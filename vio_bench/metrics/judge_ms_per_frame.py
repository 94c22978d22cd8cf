"""Host milliseconds per sequence-frame in the PARSAC judge: the program's
spans `swt.judge_asm` (the judge's gathers, every tracked frame) and
`swt.judge` (the IMU-PARSAC vote and the tag writes, its
`swt.judge.parsac` inside), summed over the profiled ticks, over the
sequence-frames those ticks offered. `swt.judge_asm` runs on every tracked
frame while PARSAC is on, so the reading is never empty in a steady
window."""

UNIT = "ms"


def read(trace):
    spans = trace["spans"]
    got = spans.get("swt.judge_asm", []) + spans.get("swt.judge", [])
    if not spans.get("swt.judge_asm") or not trace["frames"]:
        return None
    return 1e3 * sum(got) / trace["frames"]
