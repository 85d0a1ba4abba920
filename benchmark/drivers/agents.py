"""Agent rounds: the reasoner answering a lockstep round of schema-guided
turns, as the lockstep driver (``graph/batch_driver.py``) calls it: one
``TorchReasoningBackend.chat_batch(turns, json_schema=...)`` over every
page of a folder, on the engine's own batcher (``run_guided``:
``prefill_topk``, then ``step_topk`` for each scaffold token or choice,
``string_chunk`` through string values; the graphed free decode for a
session that does not complete). Rounds run back to back, each over the
folder's pages with words drawn anew (``traffic/transcriptions.py``),
and the window closes at the end of the round during which ``--seconds``
passed.

The model comes from the configuration's architecture
(``env.architecture``, ``architectures/<name>.py``): its configuration,
weight units, program and plain reference; this driver names no model.

After the window: the program's state is freed, and the plain reference
(float32, on the served weights drawn again from the seed) reads a
sample of the completed turns teacher-forced over their prompt and
committed tokens. Compared: the gaps of the string tokens (greedy picks)
and the choices' gaps (``choices.py``).
"""

from __future__ import annotations

import json
import statistics
import sys
import time

import torch

from benchmark import choices
from benchmark.drivers.common import (GUIDED, Run, Window, instrument,
                                      reset_counters, sample)
from benchmark.reference import compare, models as ref_models
from benchmark.reference.chat import DenseTokenizer, chat_prompt
from benchmark.tracing import Ranges
from benchmark.traffic.transcriptions import round_texts
from benchmark.weights import STD
from benchmark.work import Work

TEMPERATURE = 0.1           # what the pipeline passes; greedy decode ignores it
TOP_K = 64                  # run_guided's top-k, the reference's too


def _agent(cell: dict):
    """The request builder (``agents/runners.py``) and the contract
    (``agents/schemas.py``) the workload names."""
    from handwritten_ocr_tpu_torch.agents import runners, schemas
    return getattr(runners, cell["request"]), getattr(schemas, cell["contract"])


class Recorder:
    """Every ``step_topk``'s ids, with the request each live slot serves
    and the index of the token the step commits for it; and every
    ``run_guided`` call's requests."""

    def __init__(self, batcher):
        self.steps: list = []
        self.calls: list = []
        program = batcher.program
        step_topk, run_guided = program.step_topk, batcher.run_guided

        def record_step(*args, **kwargs):
            out = step_topk(*args, **kwargs)
            self.steps.append((out, [(slot, request, len(request.tokens))
                                     for slot, request
                                     in batcher._slot_req.items()]))
            return out

        def record_call(requests, *args, **kwargs):
            self.calls.append(list(requests))
            return run_guided(requests, *args, **kwargs)
        program.step_topk = record_step
        batcher.run_guided = record_call

    def rows(self) -> dict:
        """id(request) -> {token index: top-k ids}."""
        out: dict = {}
        for ids, live in self.steps:
            ids = ids.cpu().numpy()
            for slot, request, index in live:
                out.setdefault(id(request), {})[index] = ids[slot].tolist()
        return out


def run(env) -> Run:
    from handwritten_ocr_tpu_torch.utils.schema_decode import compile_schema
    cell, device, seed = env.cell, env.device, env.seed
    model = env.architecture
    cfg, _ = model.config(env.config["hf"])
    unit_list = model.units(cfg)
    std = env.config.get("init_std", STD)
    backend = model.program(cfg, unit_list, cell, device, env.control, std)
    request_of, contract = _agent(cell)
    schema = contract.json_schema()
    budget = cell["max_tokens"]
    tokenizer = DenseTokenizer()

    def turns(index: int):
        return [request_of(text) for text in round_texts(cell, seed, index)]

    def prompt(turn) -> list[int]:
        return tokenizer.encode(chat_prompt(turn.system, turn.user))

    def answer(batch, max_tokens: int) -> list[str]:
        return backend.chat_batch(batch, temperature=TEMPERATURE,
                                  max_tokens=max_tokens, json_schema=schema)

    # Warm-up on the batcher the window will use (its context bound is
    # the round's longest prompt and the budget): one guided call over the
    # round's longest prompts, through prefill, top-k and string steps.
    first = turns(0)
    longest = sorted(first, key=lambda t: -len(prompt(t)))
    batcher = backend._ensure_batcher(len(prompt(longest[0])) + budget)
    answer(longest[:cell["warmup"]["turns"]], cell["warmup"]["max_tokens"])
    if backend._batcher is not batcher:
        raise RuntimeError("the warm-up rebuilt the batcher")
    env.sync()
    env.mark_setup()

    work = Work() if env.trace else None
    ranges = Ranges(profile=env.trace)
    frozen: dict = {}

    def stop_tracing() -> None:
        """A traced run traces until the first step that starts past
        ``--seconds``; the round goes on untraced, so that its turns
        finish (see ``drivers/ocr.py``)."""
        frozen["counters"] = dict(batcher.stats)
        work.frozen = ranges.frozen = True
        t_stop = time.perf_counter()
        env.stop_trace(ranges, window.t_open, t_stop)
        print(f"trace stopped at {t_stop - window.t_open:.3f} s of the "
              f"window, read in {time.perf_counter() - t_stop:.3f} s",
              file=sys.stderr)

    window = Window(env.seconds, cell["close_at"],
                    on_due=stop_tracing if env.trace else None)
    instrument(batcher, window, ranges, work, env.faults, GUIDED)
    recorder = Recorder(batcher)
    reset_counters(batcher)
    rounds = []                              # (turns, texts)
    env.start_trace()
    window.open()
    index, batch = 0, first
    while True:
        with ranges.range("chat_batch"):
            rounds.append((batch, answer(batch, budget)))
        index += 1
        if window.due():
            window.close()
            break
        batch = turns(index)
    if "counters" not in frozen:
        env.stop_trace(ranges, window.t_open, window.t_close)
    counters = frozen.get("counters", dict(batcher.stats))
    memory_peak = env.memory_peak()

    done, failed = [], 0
    for (batch, texts), requests in zip(rounds, recorder.calls):
        for turn, text, request in zip(batch, texts, requests):
            failed += not _valid(contract, text)
            done.append((turn, list(request.tokens), id(request)))
    rows = recorder.rows()
    spec = compile_schema(schema)
    eos = cfg.eos_token_id
    walks = {key: choices.walk(tokens, rows.get(key, {}), spec, tokenizer,
                               eos, budget) for _, tokens, key in done}
    _shapes(window, batcher.stats, done, walks, budget, failed)
    chosen = sample(done, lambda d: len(prompt(d[0])) + len(d[1]),
                    cell["sample_turns"], seed)
    checked = [(prompt(turn), tokens, walks[key][0], rows.get(key, {}))
               for turn, tokens, key in chosen]
    mismatched = sum(m for _, m in walks.values())
    attempted = len(done)
    del rounds, done, chosen, recorder, batcher, backend, rows
    env.free()

    numbers = reference_numbers(model, cfg, unit_list, cell["weights_seed"],
                                std, device, checked, spec, tokenizer, eos,
                                budget)
    numbers["replay_mismatches"] = mismatched
    print("turns compared: " + ", ".join(f"{k} {v!r}"
                                         for k, v in numbers.items()),
          file=sys.stderr)
    checks = {name: (numbers[name], limit)
              for name, limit in cell["limits"].items()}
    checks["replay_mismatches"] = (mismatched, 0)
    return Run(rates={"agent_turns_per_s": (attempted - failed)
                      / window.length},
               attempted=attempted, failed=failed, counters=counters,
               ranges=ranges, work=work or Work(), window=window,
               checks=checks, memory_peak=memory_peak)


def _valid(contract, text: str) -> bool:
    try:
        contract.validate(json.loads(text))
    except ValueError:
        return False
    return True


def _shapes(window, counters, done, walks, budget: int,
            failed: int) -> None:
    """The window's answer shapes (``counters``: the batcher's over the
    whole window), on standard error."""
    lengths = [min(len(tokens), budget) for _, tokens, _ in done]
    per_turn = [sum(isinstance(s, tuple) for s in states)
                for states, _ in walks.values()]
    topk, string = counters["topk_steps"], counters["string_steps"]
    sessions = counters["sessions"] or 1
    print(f"window {window.length:.3f} s: {len(done)} turns ({failed} not "
          f"valid), {sum(n < budget for n in lengths)} ended before the "
          f"budget; tokens a turn {statistics.mean(lengths):.1f}; top-k / "
          f"string steps {topk} / {string}; sessions incomplete "
          f"{sessions - counters['sessions_complete']} of {sessions}; "
          f"choices a turn {statistics.mean(per_turn):.2f} (sd "
          f"{statistics.pstdev(per_turn):.2f}, {min(per_turn)}-"
          f"{max(per_turn)})", file=sys.stderr)


def reference_numbers(model, cfg, unit_list, weights_seed: int, std: float,
                      device, checked, spec, tokenizer, eos: int,
                      budget: int) -> dict:
    """The string tokens' gaps and the choices' gaps of ``checked``
    (prompt, committed tokens, their states, the program's top-k rows)
    under the float32 reference of the architecture ``model``."""
    ref_models.full_fp32()
    seqs = [{"ids": p + t, "want": list(range(len(p) - 1, len(p) - 1 + len(t)))}
            for p, t, _, _ in checked]
    logits = model.reference_logits(cfg, unit_list, weights_seed, std, device,
                                    seqs)
    strings, gaps, mismatches = [], [], 0
    for rows_logits, (_, tokens, states, rows) in zip(logits, checked):
        at = [i for i, s in enumerate(states) if s == "string"]
        if at:
            strings.append(compare.gaps(rows_logits[at],
                                        [tokens[i] for i in at]))
        for i, s in enumerate(states):
            if not isinstance(s, tuple):
                continue
            order = torch.topk(rows_logits[i], TOP_K).indices.tolist()
            program = rows.get(i, [tokens[i]])
            gaps.append(choices.gap(rows_logits[i], s, program, order,
                                    tokenizer.decode, eos))
            mismatches += choices.reference_pick(
                tokens, rows, i, order, spec, tokenizer, eos, budget) \
                != tokens[i]
    every = torch.cat(strings) if strings else torch.zeros(1)
    return {"max_logit_gap": float(every.max()),
            "mean_logit_gap": float(every.mean()),
            "string_tokens_compared": int(every.numel()) if strings else 0,
            "max_choice_gap": max(gaps, default=0.0),
            "choices_compared": len(gaps),
            "choice_mismatches": int(mismatches)}
