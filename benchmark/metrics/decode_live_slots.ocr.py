"""Live slots a decode step ran on average: the batcher's own
``decode_slot_steps`` (each slot's tokens and its EOS step) over its
``decode_steps`` (each chunk's longest-running slot's)."""


def read(m):
    steps = m.counters.get("decode_steps")
    live = m.counters.get("decode_slot_steps")
    return live / steps if steps and live is not None else None
