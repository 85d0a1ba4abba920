"""One driver per path of the program a cell runs (``drivers/<driver>.py``,
named by the cell's workload file)."""
