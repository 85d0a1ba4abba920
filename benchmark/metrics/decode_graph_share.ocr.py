"""Share of the decode steps replayed from a CUDA graph, in %: the
batcher's own ``decode_graph_steps`` over its ``decode_steps`` (each
graph's capture runs one eager step). None where the program does not
count replays."""


def read(m):
    steps = m.counters.get("decode_steps")
    replayed = m.counters.get("decode_graph_steps")
    return replayed / steps * 100 if steps and replayed is not None else None
