"""Device kernels per tick: the kernels torch.profiler recorded over the
profiled ticks (copies and memsets left out), over the ticks."""

UNIT = "count"


def read(trace):
    k = trace["device"]["kernels"]
    if not k or not trace["ticks"]:
        return None
    return k / trace["ticks"]
