"""portbench: the benchmark of `deqmpc_tpu_torch`, the PyTorch and CUDA port.

`run.py` runs one cell of `BENCHMARK.json`. Everything that belongs to one
configuration, traffic mix or per-layer metric sits in a file of its own
(`configs/`, `traffic/`, `metrics/`), found by the name the cell gives.
`ref/` is the plain reference that decides `correct`; it imports nothing of
the port.
"""
