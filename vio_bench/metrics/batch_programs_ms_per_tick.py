"""Host milliseconds per tick in the dispatcher's batched flushes: the
program's spans `batch.sub` and `batch.kf` (BatchDispatcher.flush, which
runs batched_sub, batched_kf and batched_marg), summed over the profiled
ticks, over the ticks."""

UNIT = "ms"


def read(trace):
    spans = trace["spans"]
    got = spans.get("batch.sub", []) + spans.get("batch.kf", [])
    if not got or not trace["ticks"]:
        return None
    return 1e3 * sum(got) / trace["ticks"]
