"""The greedy decode step of one batcher, replayed as CUDA graphs.

A decode step of the port is over a thousand small launches (28 layers
of norms, projections, rope, the paged kernel and the MLP, then the
lm_head and the argmax), and enqueueing them one by one from Python takes
longer than the card takes to run them. :class:`StepGraphs` captures the
step once per key (the batcher's table width and the rope path) and
replays it, so that a step costs one ``replay()`` on the host.

The first step of a key runs eagerly, on the graphs' own stream: it is a
real step, and it also sizes the kernels' workspaces and sets up cuBLAS
on that stream. The step is then captured (capture runs nothing, so no
state moves) and every later step of the key replays it. The graph reads
the step's inputs from buffers of its own (:meth:`StepGraphs.load`) and
points at the batcher's cache directly: the pools, ``lengths`` and
``block_tables`` are updated in place and never reallocated.

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

from handwritten_ocr_tpu_torch.ops import build, launch_counters


def graphable(program, device: torch.device) -> bool:
    """Whether ``program``'s greedy step is captured on ``device``: on a
    CUDA card, without tensor parallelism (``group``: its collectives
    run over gloo where ranks share a card, which a graph cannot hold)
    and without FSDP (``gather``: a layer's gather per step)."""
    return (device.type == "cuda" and program.group is None
            and program.gather is None)


@dataclasses.dataclass
class _Captured:
    graph: torch.cuda.CUDAGraph
    out: torch.Tensor           # the step's next tokens, written by replay
    launches: list              # (wrapper, attribute, launches a replay)
    workspaces: list            # the workspace buffers the graph writes


class StepGraphs:
    """CUDA graphs of one batcher's greedy decode step over its ``cache``,
    one per key; ``stats`` (the batcher's) counts the steps replayed
    (``decode_graph_steps``) and the captures (``decode_graph_captures``).
    """

    def __init__(self, cache, n_slots: int, stats: dict):
        device = cache.lengths.device
        self.cache = cache
        self.stats = stats
        self.last = torch.zeros((n_slots,), dtype=torch.int32, device=device)
        self.done = torch.zeros((n_slots,), dtype=torch.bool, device=device)
        self.rope_delta = torch.zeros((n_slots,), dtype=torch.int32,
                                      device=device)
        self.slot_ids = torch.arange(n_slots, device=device)
        self._stream = torch.cuda.Stream(device)
        self._pool = torch.cuda.graph_pool_handle()
        self._graphs: dict = {}

    def load(self, last: torch.Tensor, done: torch.Tensor,
             rope_delta: torch.Tensor) -> None:
        """Copy a chunk's inputs into the buffers every graph reads."""
        self.last.copy_(last)
        self.done.copy_(done)
        self.rope_delta.copy_(rope_delta)

    def step(self, key, step) -> torch.Tensor:
        """The next tokens [S] of ``step()``, one decode step over the
        buffers of :meth:`load`: replayed from the graph of ``key``, or,
        at a key's first step, run eagerly and then captured."""
        captured = self._graphs.get(key)
        if captured is not None:
            captured.graph.replay()
            for wrapper, attr, count in captured.launches:
                setattr(wrapper, attr, getattr(wrapper, attr) + count)
            self.stats["decode_graph_steps"] += 1
            return captured.out
        current = torch.cuda.current_stream(self.last.device)
        self._stream.wait_stream(current)
        with torch.cuda.stream(self._stream):
            nxt = step()
            self._graphs[key] = self._capture(step)
        current.wait_stream(self._stream)
        nxt.record_stream(current)
        self.stats["decode_graph_captures"] += 1
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
