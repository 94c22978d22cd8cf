"""LM iterations per tick of the batched solves: each batched solve runs
as many iterations as its longest row (the program's rolling log
`estimation.ba.ROW_ITERATIONS`, one list of row iterations per solve),
summed over the profiled ticks, over the ticks."""

UNIT = "count"


def read(trace):
    rows = trace["counters"].get("estimation.ba.ROW_ITERATIONS")
    if not rows or not trace["ticks"]:
        return None
    return sum(max(r) for r in rows) / trace["ticks"]
