"""Host ms a decode step waits on the card: the port's ``decode.sync``
spans (the per-step done-flag read and the chunk's token read at its
end) over its ``decode_steps`` counter. Where it is large the step is
bound by the card's work, not by the host's dispatch."""

from benchmark.program_spans import seconds


def read(m):
    steps = m.counters.get("decode_steps")
    spent = seconds(m, "decode.sync")
    return spent / steps * 1e3 if steps and spent is not None else None
