"""Host ms per read of packing and ``VLModel.prompt_embeds`` (the vision
tower and the splice): the harness's ``vision`` range, which ends in a
synchronise, over the reads it encoded."""


def read(m):
    reads = len(m.work.grids)
    return m.ranges.seconds("vision") / reads * 1e3 if reads else None
