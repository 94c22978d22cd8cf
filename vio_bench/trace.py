"""The traced run's readings over its profiled ticks: the device activity
that `torch.profiler` (CUPTI) records, the host syncs that
`torch.cuda.set_sync_debug_mode("warn")` reports, and the host's own
stamps of each tick's phases, which name the device's idle gaps.

Only device activity is traced: host-side tracing of the few hundred
thousand operator calls of a tick would cost minutes to post-process.
"""

from __future__ import annotations

import collections
import sys
import time
import warnings
from typing import Dict, List, Tuple

from vio_bench.stats import gaps, union_length

SYNC_WARNING = "synchronizing CUDA operation"


def _epoch_offset_ns() -> int:
    """time.time_ns() - time.perf_counter_ns(): kineto stamps events on the
    epoch clock, the harness its phases on perf_counter."""
    a = time.perf_counter_ns()
    e = time.time_ns()
    b = time.perf_counter_ns()
    return e - (a + b) // 2


class PhaseStamps:
    """(label, start, end) on perf_counter for the host phases of the
    profiled ticks: the sequences' host steps, each batched flush."""

    def __init__(self):
        self.spans: List[Tuple[str, float, float]] = []
        self.on = False

    def wrap(self, obj, attr, label):
        orig = getattr(obj, attr)

        def timed(*a, **kw):
            if not self.on:
                return orig(*a, **kw)
            t0 = time.perf_counter()
            try:
                return orig(*a, **kw)
            finally:
                self.spans.append((label, t0, time.perf_counter()))

        setattr(obj, attr, timed)

    def label_at(self, t: float) -> str:
        best = "between ticks (benchmark loop)"
        for label, a, b in self.spans:
            if a <= t < b:
                best = label  # the innermost: spans close before their parents
        return best


class Tracer:
    """Profile whole ticks: start() before the first, stop() after the last."""

    def __init__(self):
        self.prof = None
        self.caught = None
        self._wctx = None
        self.t0 = self.t1 = None

    def start(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self._wctx = warnings.catch_warnings(record=True)
        self.caught = self._wctx.__enter__()
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.t0 = time.perf_counter()

    def stop(self):
        import torch

        torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("default")
        self.prof.__exit__(None, None, None)
        self._wctx.__exit__(None, None, None)

    def syncs(self) -> int:
        return sum(SYNC_WARNING in str(w.message) for w in self.caught)

    def device_events(self):
        """(name, start_ns, end_ns) of every device activity traced."""
        out = []
        for e in self.prof.profiler.kineto_results.events():
            if str(e.device_type()).endswith("CUDA"):
                s = e.start_ns()
                out.append((e.name(), s, s + e.duration_ns()))
        return out


def _program_counters():
    """{name: object} of the program's module-level counters: its
    collections.Counter objects, dicts of them, and its deques (rolling
    logs), named "<module under rd_vio_tpu_torch>.<NAME>"."""
    out = {}
    for mname, mod in list(sys.modules.items()):
        if mod is None or mname.split(".")[0] != "rd_vio_tpu_torch":
            continue
        short = mname.split(".", 1)[1] if "." in mname else mname
        for k, v in list(vars(mod).items()):
            if not k.isupper():
                continue
            if isinstance(v, (collections.Counter, collections.deque)) or (
                    isinstance(v, dict) and v
                    and all(isinstance(x, collections.Counter) for x in v.values())):
                out[f"{short}.{k}"] = v
    return out


def _copy(v):
    if isinstance(v, collections.deque):
        return [list(x) if isinstance(x, (list, tuple)) else x for x in v]
    if isinstance(v, collections.Counter):
        return dict(v)
    return {k: dict(x) for k, x in v.items()}


def counter_values(clear_logs: bool = False):
    """A copy of every program counter; with `clear_logs` its rolling logs
    (deques) are emptied first."""
    objs = _program_counters()
    if clear_logs:
        for v in objs.values():
            if isinstance(v, collections.deque):
                v.clear()
    return {k: _copy(v) for k, v in objs.items()}


def counters_since(start):
    """Each program counter's growth since `start` (counter_values()): a
    Counter's counts minus those at the start, a dict of Counters likewise,
    a rolling log's entries since it was emptied."""
    out = {}
    for k, v in counter_values().items():
        s = start.get(k)
        if isinstance(v, list) or s is None:
            out[k] = v
        elif all(isinstance(x, dict) for x in v.values()):
            out[k] = {g: {c: n - s.get(g, {}).get(c, 0) for c, n in d.items()}
                      for g, d in v.items()}
        else:
            out[k] = {c: n - s.get(c, 0) for c, n in v.items()}
    return out


def is_kernel(name: str) -> bool:
    return not (name.startswith("Memcpy") or name.startswith("Memset")
                or name.startswith("cudaMemcpy") or name.startswith("cudaMemset"))


def reduce_device(events, t0: float, t1: float, stamps: PhaseStamps = None,
                  offset_ns: int = None, top: int = 10) -> Dict:
    """busy_s (the union of the activities' intervals), window_s, kernel
    count and the breakdown (the device operations that took most time,
    the longest idle gaps by the host phase they fall in) of the profiled
    ticks [t0, t1) on perf_counter."""
    if offset_ns is None:
        offset_ns = _epoch_offset_ns()
    w0 = int(t0 * 1e9) + offset_ns
    w1 = int(t1 * 1e9) + offset_ns
    iv = [(max(a, w0), min(b, w1)) for _, a, b in events]
    busy_ns = union_length(iv)
    by_name = collections.Counter()
    for name, a, b in events:
        by_name[name] += (b - a) * 1e-9
    idle = sorted(gaps(iv, w0, w1), key=lambda g: g[0] - g[1])[:top]
    idle_named = []
    for a, b in idle:
        mid = ((a + b) / 2 - offset_ns) * 1e-9
        label = stamps.label_at(mid) if stamps is not None else "host"
        idle_named.append([label, (b - a) * 1e-9])
    return {
        "busy_s": busy_ns * 1e-9,
        "window_s": t1 - t0,
        "kernels": sum(1 for name, _, _ in events if is_kernel(name)),
        "device_ops": [[n, s] for n, s in by_name.most_common(top)],
        "idle_gaps": idle_named,
    }
