"""What the cell drivers share: the measured window, the harness's
wrappers around the program's units of work, and the run's record.

The window opens when the cell's first work starts and closes at a
boundary of the program's own work: before the next prefill or decode
chunk once ``--seconds`` have passed (``close_at: "unit"``), or at the
end of the folder read (``"folder"``) or of the agent round
(``"round"``) during which they passed. Either way its rates count all
the work completed over all of its time.

The wrappers replace the program's unit methods on the one
``PagedProgram`` object the cell uses: the read's ``prefill`` and
``decode_chunk`` (``UNITS``), or guided decode's ``prefill_topk``,
``step_topk`` and ``string_chunk`` (``GUIDED``, whose ranges end in a
synchronise, as the caller reads their ids at once). Each checks the
window before the unit starts, times it as a range, and in a traced run
counts its work (the live slots and their contexts, the prompts
prefilled) from the batcher's host state and the unit's own arguments
and results. The program's code is not changed.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from benchmark.tracing import Ranges
from benchmark.work import Work

UNITS = ("prefill", "decode_chunk")
GUIDED = ("prefill_topk", "step_topk", "string_chunk")
# An admission's prefill calls run back to back and the batcher adds their
# ``prefill_s`` after the last: a traced window stops at no prefill.
PREFILLS = ("prefill", "prefill_topk")


class WindowClosed(Exception):
    """Raised at a unit boundary once the window is due to close."""


class Window:
    """``on_due``: called once, at the first boundary after ``seconds``
    before a decode or step unit (never before a prefill, ``PREFILLS``),
    by a window that closes later (a traced run stops its trace there,
    see ``drivers/ocr.py``)."""

    def __init__(self, seconds: float, close_at: str, on_due=None):
        if close_at not in ("unit", "folder", "round"):
            raise ValueError("close_at is 'unit', 'folder' or 'round', not "
                             f"{close_at!r}")
        self.seconds = seconds
        self.close_at = close_at
        self.t_open = self.t_close = None
        self.armed = False
        self.on_due = on_due

    def open(self) -> None:
        self.t_open = time.perf_counter()
        self.armed = True

    def due(self) -> bool:
        return time.perf_counter() - self.t_open >= self.seconds

    def close(self) -> None:
        if self.armed:
            self.t_close = time.perf_counter()
            self.armed = False

    def at_unit(self, prefill: bool = False) -> None:
        if not self.armed or not self.due():
            return
        if self.close_at == "unit":
            self.close()
            raise WindowClosed
        if self.on_due is not None and not prefill:
            on_due, self.on_due = self.on_due, None
            on_due()

    @property
    def length(self) -> float:
        return self.t_close - self.t_open


@dataclasses.dataclass
class Run:
    """What a cell's run hands back to the harness."""

    rates: dict                 # end-to-end metric name -> value
    attempted: int
    failed: int
    counters: dict              # the program's own counters over the window
    ranges: Ranges
    work: Work
    window: Window
    checks: dict                # name -> (value, limit[, "min"])
    memory_peak: int = 0


def _cpu(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def instrument(batcher, window: Window, ranges: Ranges, work: Work | None,
               faults=(), units=UNITS) -> None:
    """Wrap the unit methods ``units`` of ``batcher.program`` (see the
    module docstring); ``faults`` are callables ``(name, args, out,
    batcher) -> out`` planted underneath the timed path by the tests of
    the comparison, never by a measured run."""
    program = batcher.program
    eos = program.eos_token_id

    def wrap(name, original):
        def unit(*args, **kwargs):
            window.at_unit(prefill=name in PREFILLS)
            before = _before(name, args) if work is not None else None
            with ranges.range(name, sync=name in GUIDED):
                out = original(*args, **kwargs)
            for fault in faults:
                out = fault(name, args, out, batcher)
            if work is not None and not work.frozen:
                _count(name, args, out, before)
            return out
        return unit

    def _before(name, args):
        return batcher._host_len.copy() \
            if name in ("decode_chunk", "string_chunk") else None

    def _count(name, args, out, start):
        if name in ("prefill", "prefill_topk"):
            work.prompts.extend(int(n) for n in _cpu(args[3]))
        elif name == "step_topk":
            # run_guided has advanced each session's length by the token
            # this step writes
            work.step(batcher._host_len[_cpu(args[2]).astype(bool)])
        elif name == "string_chunk":
            auto, remaining = _cpu(args[2]).astype(bool), _cpu(args[3])
            stop, tokens, steps = _cpu(args[4]), _cpu(out[0]), out[3]
            spans = {}
            for slot in np.flatnonzero(auto):
                row = tokens[slot, :steps]
                stall = stop[row] | (row == eos) \
                    | (np.arange(1, steps + 1) >= remaining[slot])
                stops = np.flatnonzero(stall)
                spans[slot] = int(stops[0]) + 1 if len(stops) else steps
            for i in range(steps):
                work.step([start[s] + i + 1 for s, n in spans.items() if i < n])
        elif name == "decode_chunk":
            done, remaining = _cpu(args[2]), _cpu(args[3])
            tokens = _cpu(out[0])
            spans = {}
            for slot in np.flatnonzero(~done.astype(bool)):
                row = tokens[slot]
                stops = np.flatnonzero(row == eos)
                last = min(int(stops[0]) if len(stops) else len(row) - 1,
                           int(remaining[slot]) - 1)
                spans[slot] = last + 1
            for i in range(max(spans.values(), default=0)):
                work.step([start[s] + i + 1 for s, n in spans.items() if i < n])

    for name in units:
        setattr(program, name, wrap(name, getattr(program, name)))


def reset_counters(batcher) -> None:
    for key, value in batcher.stats.items():
        batcher.stats[key] = 0.0 if isinstance(value, float) else 0


def sample(items: list, key, k: int, seed: int) -> list:
    """``k`` of ``items`` drawn from the seed, the one with the largest
    ``key`` always among them."""
    if len(items) <= k:
        return list(items)
    longest = max(range(len(items)), key=lambda i: key(items[i]))
    rest = [i for i in range(len(items)) if i != longest]
    rng = np.random.default_rng(int(seed) + 1)
    chosen = [longest] + list(rng.choice(rest, size=k - 1, replace=False))
    return [items[i] for i in sorted(chosen)]
