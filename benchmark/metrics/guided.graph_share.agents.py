"""Share of guided decode's steps replayed from a CUDA graph, in %: the
batcher's ``guided_graph_steps`` over its ``topk_steps`` and
``string_steps`` (each graph's capture runs one eager step). None where
the program does not count guided replays."""


def read(m):
    steps = m.counters.get("topk_steps", 0) + m.counters.get("string_steps", 0)
    replayed = m.counters.get("guided_graph_steps")
    return replayed / steps * 100 if steps and replayed is not None else None
