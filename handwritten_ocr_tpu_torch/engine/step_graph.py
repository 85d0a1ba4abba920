"""The decode steps of one batcher, replayed as CUDA graphs.

A decode step of the port is over a thousand small launches (28 or 64
layers of norms, projections, rope, the paged kernel and the MLP, then
the lm_head and the argmax or top-k), and enqueueing them one by one from
Python takes longer than the card takes to run them. :class:`StepGraphs`
captures a step once per key and replays it, so that a step costs one
``replay()`` on the host. A key (:meth:`StepGraphs.key`) names the step's
body (the greedy step of a plain chunk, guided decode's string step or
its top-k step), the batcher's table width and the rope path, and for the
top-k step its ``k``.

Every batcher holds one :class:`StepGraphs`, and every step reads its
inputs from the buffers :meth:`StepGraphs.load` fills, so the units of
``engine/serving.py`` have one body whether their steps are captured or
not. Whether they are is decided once, at construction, by
:func:`graphable`; where they are not (the CPU, tensor parallelism,
FSDP), :meth:`StepGraphs.step` runs the step eagerly and counts nothing.

Where they are, the first step of a key runs eagerly, on the graphs' own
stream: it is a real step, and it also sizes the kernels' workspaces and
sets up cuBLAS on that stream. The step is then captured (capture runs
nothing, so no state moves) and every later step of the key replays it.
The graph reads the buffers and points at the batcher's cache directly:
the pools, ``lengths`` and ``block_tables`` are updated in place and
never reallocated. A replay writes its output into the same tensor every
time: a caller that keeps it past the next replay keeps a copy.

What a replay must keep as an eager step has it:

- the kernels' workspaces: a capture keeps every workspace buffer alive
  for as long as its graph lives, so a later call that grows a workspace
  (a verify round, a wider table) replaces the buffer for eager calls
  without freeing the one the graph writes (``ops/build.py:Workspace``);
- the launch counts: the kernel wrappers count their launches while the
  step is captured; a capture launches nothing, so those increments are
  taken back, and each replay adds exactly them again.

Graphs live and die with the :class:`StepGraphs` that holds them, and it
with its batcher: dropping the batcher frees the graphs and their memory.
"""

from __future__ import annotations

import dataclasses

import torch

from handwritten_ocr_tpu_torch.models.layers import rope_fp32
from handwritten_ocr_tpu_torch.ops import build, launch_counters


def graphable(program, device: torch.device) -> bool:
    """Whether ``program``'s decode steps are captured on ``device``: on a
    CUDA card, without tensor parallelism (``group``: its collectives
    run over gloo where ranks share a card, which a graph cannot hold)
    and without FSDP (``gather``: a layer's gather per step)."""
    return (device.type == "cuda" and program.group is None
            and program.gather is None)


@dataclasses.dataclass
class _Captured:
    graph: torch.cuda.CUDAGraph
    out: torch.Tensor           # the step's output, written by every replay
    launches: list              # (wrapper, attribute, launches a replay)
    workspaces: list            # the workspace buffers the graph writes


class StepGraphs:
    """The step buffers of one batcher over its ``cache`` and, where
    :func:`graphable` holds for ``program`` on the cache's device
    (``captures``), the CUDA graphs of its decode steps, one per key;
    ``stats`` (the batcher's) counts the steps replayed and the captures,
    of the greedy step (``decode_graph_steps``, ``decode_graph_captures``)
    and of guided decode's string and top-k steps (``guided_graph_steps``,
    ``guided_graph_captures``) apart.
    """

    def __init__(self, program, cache, stats: dict):
        device = cache.lengths.device
        n_slots = cache.lengths.shape[0]
        self.cache = cache
        self.stats = stats
        self.captures = graphable(program, device)
        self.last = torch.zeros((n_slots,), dtype=torch.int32, device=device)
        self.live = torch.zeros((n_slots,), dtype=torch.bool, device=device)
        self.rope_delta = torch.zeros((n_slots,), dtype=torch.int32,
                                      device=device)
        self.slot_ids = torch.arange(n_slots, device=device)
        self._graphs: dict = {}
        if self.captures:
            self._stream = torch.cuda.Stream(device)
            self._pool = torch.cuda.graph_pool_handle()

    @staticmethod
    def key(body: str, table_pages: int | None, *extra) -> tuple:
        """The key of a step: its ``body`` (``"greedy"``, ``"string"`` or
        ``"topk"``), the table width, the rope path (:func:`rope_fp32`,
        read here, once a chunk or step, so that a graph holds one path)
        and what else shapes the body (the top-k's ``k``)."""
        return (body, table_pages, rope_fp32(), *extra)

    def load(self, last: torch.Tensor, rope_delta: torch.Tensor,
             live: torch.Tensor) -> None:
        """Copy a chunk's (or a step's) inputs into the buffers the steps
        read: each slot's last token, its rope delta and whether it is
        live (steps; a slot that is not appends nothing)."""
        self.last.copy_(last)
        self.rope_delta.copy_(rope_delta)
        self.live.copy_(live)

    def step(self, key, step) -> torch.Tensor:
        """The output of ``step()``, one decode step over the buffers of
        :meth:`load`: run eagerly where the steps are not captured;
        otherwise replayed from the graph of ``key`` (the same tensor at
        every replay), or, at a key's first step, run eagerly and then
        captured."""
        if not self.captures:
            return step()
        counter = "decode" if key[0] == "greedy" else "guided"
        captured = self._graphs.get(key)
        if captured is not None:
            captured.graph.replay()
            for wrapper, attr, count in captured.launches:
                setattr(wrapper, attr, getattr(wrapper, attr) + count)
            self.stats[f"{counter}_graph_steps"] += 1
            return captured.out
        current = torch.cuda.current_stream(self.last.device)
        self._stream.wait_stream(current)
        with torch.cuda.stream(self._stream):
            nxt = step()
            self._graphs[key] = self._capture(step)
        current.wait_stream(self._stream)
        nxt.record_stream(current)
        self.stats[f"{counter}_graph_captures"] += 1
        return nxt

    def _capture(self, step) -> _Captured:
        counters = launch_counters()
        before = [getattr(wrapper, attr) for _, wrapper, attr in counters]
        graph = torch.cuda.CUDAGraph()
        graph.capture_begin(pool=self._pool,
                            capture_error_mode="thread_local")
        try:
            out = step()
        finally:
            graph.capture_end()
        launches = []
        for (_, wrapper, attr), count in zip(counters, before):
            if getattr(wrapper, attr) != count:
                launches.append((wrapper, attr, getattr(wrapper, attr) - count))
                setattr(wrapper, attr, count)
        return _Captured(graph, out, launches, build.Workspace.held())
