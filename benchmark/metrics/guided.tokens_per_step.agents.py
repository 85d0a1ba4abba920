"""Tokens guided decode commits a step: the batcher's ``guided_tokens``
over its ``topk_steps`` and ``string_steps``. A step runs every slot;
this is how many sessions it moved on, on average."""


def read(m):
    steps = m.counters.get("topk_steps", 0) + m.counters.get("string_steps", 0)
    tokens = m.counters.get("guided_tokens")
    return tokens / steps if steps and tokens else None
