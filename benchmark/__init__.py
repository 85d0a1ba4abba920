"""The PyTorch/CUDA port's benchmark: one cell of BENCHMARK.json per run
(``benchmark/run.py``), its traffic, its plain reference and its
per-layer readers."""
