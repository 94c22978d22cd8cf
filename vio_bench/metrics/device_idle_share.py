"""The device's idle share over the profiled ticks, in percent:
100 x (1 - busy_s / window_s), busy_s the union of the intervals of every
device activity the profiler recorded, window_s the ticks' wall time."""

UNIT = "%"


def read(trace):
    d = trace["device"]
    if not d["busy_s"] > 0 or not d["window_s"] > 0:
        return None
    return 100.0 * (1.0 - d["busy_s"] / d["window_s"])
