"""ms of a step inside string values: the harness's ``string_chunk``
range (greedy steps of the in-span slots, a flag read each, ending in a
synchronise) over the batcher's ``string_steps``."""


def read(m):
    steps = m.counters.get("string_steps")
    seconds = m.ranges.seconds("string_chunk")
    return seconds / steps * 1e3 if steps and seconds else None
