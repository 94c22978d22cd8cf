"""Per-layer metric readers, one module per metric of BENCHMARK.json's
`per_layer`, named as the metric (dots become underscores). Each has
`UNIT` and `read(trace) -> float | None`. `trace` holds what the traced
run read over its profiled ticks: "ticks" and "frames" (sequence-frames)
profiled; "spans", every span of the program's GLOBAL_TIMER by name (the
seconds of each call, the timer emptied at the first profiled tick);
"counters", each module-level counter of the program by
"<module>.<NAME>" (vio_bench.trace.counters_since); "syncs", the host
syncs torch.cuda.set_sync_debug_mode reported; "device", the profiler's
reading (busy_s, window_s, kernels). A reader picks what it reads, so a
metric is added as a file of its own. A reader that finds nothing to read
returns None, and the run then fails with a message: it never prints 0 in
its place."""

import importlib


def reader(name: str):
    return importlib.import_module(f"vio_bench.metrics.{name.replace('.', '_')}")
