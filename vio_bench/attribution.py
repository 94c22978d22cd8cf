"""Device time by the program span that launched it, and device idle by what
the host was doing, over a traced run's profiled ticks.

Inputs: the records of a torch.profiler trace taken with
ProfilerActivity.CUDA alone (vio_bench.trace.Tracer), and the program's host
spans (rd_vio_tpu_torch.utils.metrics.StageTimer.spans(): name, thread,
start_ns, end_ns). Both are on one clock: kineto stamps its records with
the unix-epoch nanoseconds that the spans are taken on (time.time_ns()).

- The join. Every device activity (kernel, copy, set) carries the
  correlation id of the CUDA runtime call that launched it; a kernel that
  a CUDA graph runs carries that of the cudaGraphLaunch. The runtime
  record names its thread by the low 32 bits of its pthread id, which is
  what a span records. A launch belongs to the innermost `prog.*` span open
  on its thread at the launch, else to UNATTRIBUTED.
- Device seconds by span. The busy time (the union of the activities'
  intervals, clipped to the window) is split among the activities: each
  instant to the activity that started first of those running then. The
  parts therefore sum to the busy time exactly; on one stream, where
  activities do not overlap, a span's part is the union of its own
  activities' intervals.
- Idle by host phase. The device's idle time (the window less the busy
  union) inside the union of the flush spans (`batch.kf`, `batch.sub`),
  and inside the host steps (`handler.host_step`) outside any flush; the
  flush split into the LM loop (`ba.rows.lm`), the programs' other work
  and the dispatcher's own.

All per-event work is NumPy sorts and searches; Python loops run over spans
and the few longest gaps only.

    python -m vio_bench.attribution --workload <cell> --seed <n> --seconds <s>

runs one traced run of the cell exactly as `vio_bench.run --trace 1` does
(vio_bench.run.run_cell), then prints one JSON line: the cell's declared
per-layer metrics, the five readings of this module (READINGS), the device
seconds by span with the check that they sum to the busy time, the
longest idle gaps named by the innermost program span open at their
midpoint, the host and idle time of each host phase, and the seconds the
attribution took. Needs a CUDA device.
"""

from __future__ import annotations

import time
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

PROGRAM_PREFIX = "prog."
FLUSH_SPANS = ("batch.kf", "batch.sub")
HOST_STEP_SPAN = "handler.host_step"
LM_SPAN = "ba.rows.lm"
UNATTRIBUTED = "unattributed"
# the reading names and what each reads; all are milliseconds per profiled tick
READINGS = {
    "sub_device_ms_per_tick": "prog.batched_sub",
    "kf_device_ms_per_tick": "prog.batched_kf",
    "marg_device_ms_per_tick": "prog.batched_marg",
    "flush_idle_ms_per_tick": "flush",
    "host_step_idle_ms_per_tick": "host_step",
}


class Records(NamedTuple):
    """A trace's device activities (start, end, correlation) and the runtime
    calls that launched them (correlation, thread, time), as int64 arrays."""

    dev_start: np.ndarray
    dev_end: np.ndarray
    dev_corr: np.ndarray
    launch_corr: np.ndarray
    launch_thread: np.ndarray
    launch_t: np.ndarray


def thread_key(ident: int) -> int:
    """The low 32 bits of a pthread id: how a span's thread and a runtime
    record's thread are matched."""
    return int(ident) & 0xFFFFFFFF


def records(kineto_events) -> Records:
    """Records from `profile.profiler.kineto_results.events()`: the device
    activities, and the CPU-side records named `cu*` (the CUDA API calls:
    cudaLaunchKernel, cudaGraphLaunch, cudaMemcpyAsync, cuLaunchKernel, ...).
    Kineto's other CPU-side records of a launch (module and function
    loading) share its correlation id and are left out."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    cpu = torch.autograd.DeviceType.CPU
    ds, de, dc, lc, lt, lth = [], [], [], [], [], []
    for e in kineto_events:
        kind = e.device_type()
        if kind == cuda:
            s = e.start_ns()
            ds.append(s)
            de.append(s + e.duration_ns())
            dc.append(e.correlation_id())
        elif kind == cpu and e.name().startswith("cu"):
            lc.append(e.correlation_id())
            lt.append(e.start_ns())
            lth.append(e.device_resource_id())
    a = lambda x: np.asarray(x, np.int64)  # noqa: E731
    return Records(a(ds), a(de), a(dc), a(lc), a(lth) & 0xFFFFFFFF, a(lt))


# --------------------------------------------------------------------------
# interval arithmetic on sorted arrays
# --------------------------------------------------------------------------


def merge(starts, ends) -> Tuple[np.ndarray, np.ndarray]:
    """The union of [start, end) intervals as sorted disjoint intervals."""
    a = np.asarray(starts, np.int64)
    b = np.asarray(ends, np.int64)
    keep = b > a
    a, b = a[keep], b[keep]
    if not len(a):
        return a, b
    order = np.argsort(a, kind="stable")
    a, b = a[order], np.maximum.accumulate(b[order])
    new = np.ones(len(a), bool)
    new[1:] = a[1:] > b[:-1]
    last = np.append(np.flatnonzero(new)[1:] - 1, len(a) - 1)
    return a[new], b[last]


def covered(ms, me, lo, hi) -> np.ndarray:
    """For each [lo, hi), the length of it that the sorted disjoint
    intervals (ms, me) cover."""
    lo = np.asarray(lo, np.int64)
    hi = np.asarray(hi, np.int64)
    if not len(ms):
        return np.zeros(lo.shape, np.int64)
    cum = np.concatenate([[0], np.cumsum(me - ms)])

    def upto(t):  # covered length of (-inf, t)
        k = np.searchsorted(ms, t, side="right") - 1
        kc = np.maximum(k, 0)
        part = np.clip(t - ms[kc], 0, me[kc] - ms[kc])
        return np.where(k >= 0, cum[kc] + part, 0)

    return np.maximum(upto(hi) - upto(lo), 0)


def subtract(a_s, a_e, b_s, b_e) -> Tuple[np.ndarray, np.ndarray]:
    """Sorted disjoint intervals A less sorted disjoint intervals B."""
    out_s, out_e = [], []
    j = 0
    for s, e in zip(a_s.tolist(), a_e.tolist()):
        while j < len(b_s) and b_e[j] <= s:
            j += 1
        k, cur = j, s
        while k < len(b_s) and b_s[k] < e:
            if b_s[k] > cur:
                out_s.append(cur)
                out_e.append(int(b_s[k]))
            cur = max(cur, int(b_e[k]))
            k += 1
        if cur < e:
            out_s.append(cur)
            out_e.append(e)
    return np.asarray(out_s, np.int64), np.asarray(out_e, np.int64)


# --------------------------------------------------------------------------
# the join
# --------------------------------------------------------------------------


def innermost_at(spans: Sequence[tuple], thread: np.ndarray, t: np.ndarray,
                 prefix: str = PROGRAM_PREFIX) -> np.ndarray:
    """For each (thread, t): the index into `spans` of the innermost span
    named `prefix`* open on that thread at t ([start, end)), else -1.
    Spans of one thread nest (they are context managers), so per thread
    the innermost open span is a step function of time: it is built by one
    sweep over the thread's span edges and read with a binary search."""
    out = np.full(len(t), -1, np.int64)
    by_thread: Dict[int, List[int]] = {}
    for i, (name, th, t0, t1) in enumerate(spans):
        if name.startswith(prefix) and t1 > t0:
            by_thread.setdefault(thread_key(th), []).append(i)
    for th, idx in by_thread.items():
        edges = sorted([(spans[i][2], 1, i) for i in idx] + [(spans[i][3], 0, i) for i in idx])
        bounds, labels, stack = [], [], []
        for when, opens, i in edges:  # at one instant, closes before opens
            if opens:
                stack.append(i)
            else:
                stack.remove(i)
            top = stack[-1] if stack else -1
            if bounds and bounds[-1] == when:
                labels[-1] = top
            else:
                bounds.append(when)
                labels.append(top)
        sel = np.flatnonzero(thread == th)
        if not len(sel):
            continue
        k = np.searchsorted(np.asarray(bounds, np.int64), t[sel], side="right") - 1
        lab = np.asarray(labels, np.int64)
        out[sel] = np.where(k >= 0, lab[np.maximum(k, 0)], -1)
    return out


def busy_parts(start, end, label, w0: int, w1: int, n_labels: int) -> np.ndarray:
    """Busy nanoseconds of [w0, w1) by label (label -1 at index n_labels):
    each instant of the union of the intervals goes to the interval that
    started first of those covering it, so the parts sum to the union."""
    a = np.clip(np.asarray(start, np.int64), w0, w1)
    b = np.clip(np.asarray(end, np.int64), w0, w1)
    lab = np.where(np.asarray(label) < 0, n_labels, label)
    keep = b > a
    a, b, lab = a[keep], b[keep], lab[keep]
    order = np.argsort(a, kind="stable")
    a, b, lab = a[order], b[order], lab[order]
    before = np.concatenate([[w0], np.maximum.accumulate(b)[:-1]]) if len(a) else a
    part = np.maximum(b - np.maximum(a, before), 0)
    out = np.zeros(n_labels + 1, np.int64)
    np.add.at(out, lab, part)
    return out


def attribute(rec: Records, spans: Sequence[tuple], w0: int, w1: int) -> dict:
    """The join over the window [w0, w1) (epoch ns): see the module
    docstring. Returns {"busy_ns", "window_ns", "device_ns" {span name:
    ns, UNATTRIBUTED: ns}, "spans_seen" (names of the spans that overlap
    the window), "phases" {phase: {"host_ns", "idle_ns"}, or None where
    its spans did not run}, "busy" (the merged busy intervals)}. The
    phases: "flush" (the union of the flush spans), "host_step" (the host
    steps outside any flush), and the flush's three parts "flush.lm"
    (inside `ba.rows.lm`), "flush.programs" (inside a `prog.*` span, outside
    the LM loop) and "flush.other" (inside no `prog.*` span)."""
    spans = list(spans)
    # each activity's launch: by correlation id (one runtime call per id)
    span_of = np.full(len(rec.dev_corr), -1, np.int64)
    if len(rec.launch_corr):
        order = np.argsort(rec.launch_corr, kind="stable")
        lc = rec.launch_corr[order]
        k = np.minimum(np.searchsorted(lc, rec.dev_corr), len(lc) - 1)
        launch_span = innermost_at(spans, rec.launch_thread, rec.launch_t)
        span_of = np.where(lc[k] == rec.dev_corr, launch_span[order[k]], -1)
    names = sorted({spans[i][0] for i in np.unique(span_of) if i >= 0})
    name_ix = {n: j for j, n in enumerate(names)}
    to_name = np.array([name_ix[s[0]] if s[0] in name_ix else -1 for s in spans] + [-1],
                       np.int64)
    label = to_name[span_of]  # span_of == -1 reads the appended -1
    parts = busy_parts(rec.dev_start, rec.dev_end, label, w0, w1, len(names))
    device_ns = {n: int(parts[j]) for n, j in name_ix.items()}
    device_ns[UNATTRIBUTED] = int(parts[-1])

    ms, me = merge(np.clip(rec.dev_start, w0, w1), np.clip(rec.dev_end, w0, w1))
    in_win = [s for s in spans if s[3] > w0 and s[2] < w1]

    def union(pick):
        sel = [s for s in in_win if pick(s[0])]
        return merge([max(s[2], w0) for s in sel], [min(s[3], w1) for s in sel]), bool(sel)

    def host_and_idle(iv):
        host = int((iv[1] - iv[0]).sum())
        return {"host_ns": host, "idle_ns": host - int(covered(ms, me, *iv).sum())}

    flush, any_flush = union(lambda n: n in FLUSH_SPANS)
    step, any_step = union(lambda n: n == HOST_STEP_SPAN)
    lm, _ = union(lambda n: n == LM_SPAN)
    progs, _ = union(lambda n: n.startswith(PROGRAM_PREFIX))
    progs_in_flush = subtract(*flush, *subtract(*flush, *progs))
    # the host step outside any flush; the flush split three ways: the LM
    # loop, the programs' other work, the dispatcher's own (stacking,
    # uploads, the keyframe fetch, continuations)
    phases = {
        "flush": flush, "host_step": subtract(*step, *flush),
        "flush.lm": subtract(*flush, *subtract(*flush, *lm)),
        "flush.programs": subtract(*progs_in_flush, *lm),
        "flush.other": subtract(*flush, *progs),
    }
    present = {"host_step": any_step}
    return {
        "busy_ns": int((me - ms).sum()),
        "window_ns": int(w1 - w0),
        "device_ns": device_ns,
        "spans_seen": sorted({s[0] for s in in_win}),
        "phases": {k: host_and_idle(iv) if present.get(k, any_flush) else None
                   for k, iv in phases.items()},
        "busy": (ms, me),
    }


def readings(att: dict, ticks: int) -> Dict[str, Optional[float]]:
    """The five readings (READINGS), ms per tick; None where the spans a
    reading reads did not run in the window (never 0 in their place)."""
    out = {}
    for name, what in READINGS.items():
        if what.startswith(PROGRAM_PREFIX):
            ns = att["device_ns"].get(what, 0) if what in att["spans_seen"] else None
        else:
            ns = att["phases"][what] and att["phases"][what]["idle_ns"]
        out[name] = None if ns is None or not ticks else 1e-6 * ns / ticks
    return out


def idle_gaps(att: dict, spans: Sequence[tuple], w0: int, w1: int, fallback=None,
              top: int = 10) -> List[list]:
    """The `top` longest idle gaps of [w0, w1): [label, seconds], the label
    being the innermost program span (any span of the log) open at the
    gap's midpoint on any thread (the latest-started of those open), else
    fallback(midpoint_ns), else "no program span"."""
    ms, me = att["busy"]
    gs = np.concatenate([[w0], me])
    ge = np.concatenate([ms, [w1]])
    keep = ge > gs
    gs, ge = gs[keep], ge[keep]
    order = np.argsort(gs - ge, kind="stable")[:top]
    s0 = np.asarray([s[2] for s in spans], np.int64)
    s1 = np.asarray([s[3] for s in spans], np.int64)
    out = []
    for a, b in zip(gs[order].tolist(), ge[order].tolist()):
        mid = (a + b) // 2
        open_ = np.flatnonzero((s0 <= mid) & (mid < s1)) if len(spans) else []
        if len(open_):
            label = spans[int(open_[np.argmax(s0[open_])])][0]
        else:
            label = fallback(mid) if fallback is not None else "no program span"
        out.append([label, (b - a) * 1e-9])
    return out


# --------------------------------------------------------------------------
# one traced run of a cell, with the join
# --------------------------------------------------------------------------


def main(argv=None) -> int:
    import argparse
    import json
    import sys

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)

    from vio_bench import manifest, run, trace

    run.fixed_caches(manifest.ROOT)
    man = manifest.load_manifest()
    w = manifest.cell(man, args.workload)
    config = manifest.load_data("configs", w["config"])
    traffic = manifest.load_data("traffic", w["traffic"])
    cellspec = manifest.load_data("cells", w["name"])
    cellspec["per_layer"] = sorted(manifest.declared_metrics(man, w["name"], True))

    import torch

    from rd_vio_tpu_torch.utils.metrics import GLOBAL_TIMER

    if not torch.cuda.is_available():
        print("vio_bench.attribution: needs a CUDA device", file=sys.stderr)
        return 1

    class KeptTracer(trace.Tracer):
        last = None

        def start(self):
            super().start()
            self.offset_ns = trace._epoch_offset_ns()
            KeptTracer.last = self

        def stop(self):
            super().stop()
            self.spans = GLOBAL_TIMER.spans()

    class KeptStamps(trace.PhaseStamps):
        last = None

        def __init__(self):
            super().__init__()
            KeptStamps.last = self

    saved = trace.Tracer, trace.PhaseStamps
    trace.Tracer, trace.PhaseStamps = KeptTracer, KeptStamps
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    try:
        rec = run.run_cell(config, traffic, cellspec, args.seed, args.seconds, True, device,
                           log=print)
    except run.RunFailed as e:
        print(f"vio_bench.attribution: run failed: {e}", file=sys.stderr)
        return 1
    finally:
        trace.Tracer, trace.PhaseStamps = saved
    tracer, stamps = KeptTracer.last, KeptStamps.last
    t_a = time.perf_counter()
    w0 = int(tracer.t0 * 1e9) + tracer.offset_ns
    w1 = int(tracer.t1 * 1e9) + tracer.offset_ns
    recs = records(tracer.prof.profiler.kineto_results.events())
    t_r = time.perf_counter()
    att = attribute(recs, tracer.spans, w0, w1)
    ticks = rec["profiled"]["ticks"]
    got = readings(att, ticks)
    gaps_named = idle_gaps(att, tracer.spans, w0, w1,
                           lambda ns: stamps.label_at((ns - tracer.offset_ns) * 1e-9))
    t_b = time.perf_counter()
    ms = lambda ns: 1e-6 * ns / ticks  # noqa: E731
    out = {
        "workload": w["name"], "seed": args.seed,
        "correct": run.judge(rec["numbers"], cellspec["limits"])[0],
        "device": torch.cuda.get_device_name(device),
        "metrics": {**{k: v["value"] for k, v in rec["metrics"].items()}, **got},
        "ticks": ticks,
        "busy_ms_per_tick": ms(att["busy_ns"]),
        "idle_ms_per_tick": ms(att["window_ns"] - att["busy_ns"]),
        "harness_busy_s": rec["device_extra"]["busy_s"],
        "window_s": att["window_ns"] * 1e-9,
        "device_ms_per_tick": {k: ms(v) for k, v in sorted(att["device_ns"].items(),
                                                            key=lambda kv: -kv[1])},
        "parts_sum_minus_busy_ns": sum(att["device_ns"].values()) - att["busy_ns"],
        "phases_ms_per_tick": {k: v and {"host": ms(v["host_ns"]), "idle": ms(v["idle_ns"])}
                               for k, v in att["phases"].items()},
        "idle_gaps": gaps_named,
        "launches": int(len(recs.launch_corr)), "device_activities": int(len(recs.dev_corr)),
        "spans_in_log": len(tracer.spans),
        "attribution_s": {"read_records": t_r - t_a, "join": t_b - t_r},
    }
    print(json.dumps(out, default=float), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
