"""ms of a guided top-k step: the harness's ``step_topk`` range (one
forward of every slot and the top-k, ending in a synchronise, as the
caller reads the ids at once) over the steps it timed."""


def read(m):
    seconds, steps = m.ranges.totals.get("step_topk", (0.0, 0))
    return seconds / steps * 1e3 if steps else None
