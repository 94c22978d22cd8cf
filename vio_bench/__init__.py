"""The benchmark of `rd_vio_tpu_torch`, the PyTorch and CUDA port of the
RD-VIO engine: the lockstep batch-replay path on one NVIDIA GPU.

`python -m vio_bench.run --workload <cell> --seed <n> --seconds <s> --trace
<0|1>` runs one cell of `BENCHMARK.json` once and prints its result as the
last line of standard output. Everything that belongs to one configuration,
traffic mix, cell or per-layer metric is a file of its own, found by name:
`configs/<config>.json`, `traffic/<mix>.json`, `cells/<cell>.json`,
`metrics/<metric>.py`. The plain reference that decides `correct` lives in
`reference/` and imports nothing of the program.
"""
