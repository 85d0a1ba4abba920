"""Traffic of the benchmark's cells, made from ``--seed``: one general
generator per kind of work, driven by a cell's parameter file."""
