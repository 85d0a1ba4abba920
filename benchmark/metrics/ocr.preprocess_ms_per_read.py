"""Host ms per read of the strategy chains (``TorchPreprocessor.apply``):
the harness's ``preprocess`` range, which ends in a synchronise, over the
reads it preprocessed."""


def read(m):
    reads = len(m.work.grids)
    return m.ranges.seconds("preprocess") / reads * 1e3 if reads else None
