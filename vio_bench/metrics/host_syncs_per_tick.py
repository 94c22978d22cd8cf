"""Host syncs per tick: the warnings of torch.cuda.set_sync_debug_mode("warn")
over the profiled ticks, over the ticks. The lockstep path always waits on
the card (the LM stop flags, the keyframe fetch), so no warning at all means
the count did not work."""

UNIT = "count"


def read(trace):
    if not trace["syncs"] or not trace["ticks"]:
        return None
    return trace["syncs"] / trace["ticks"]
