"""Stage timing: host spans and device spans.

The reference only has scoped wall-clock debug timers and per-call latency
prints (SURVEY.md §5 tracing). Here: `StageTimer`, a bounded log of host
spans placed on the clock that torch.profiler stamps its records on, and
`DeviceStageTimer`, CUDA event pairs around the same kind of block.
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time
from typing import Dict, List, Tuple


class StageTimer:
    """Host spans (reference unique_timer.h analogue), always on.

    Each `time(name)` block appends one record (name, thread, start_ns,
    end_ns) to one log of at most `bound` records (the oldest go first).
    start_ns and end_ns are `time.time_ns()`: torch.profiler (kineto) stamps
    its host records and the device activities on that clock, so a span can
    be laid over a device trace without conversion. `thread` is
    `threading.get_ident()`, the pthread id by which the profiler's CUDA
    runtime records name the launching thread (in their low 32 bits).
    `samples` gives every logged call's seconds by name.

    `suppressed()` disables recording for the current thread. Threads may
    time spans at once (a threaded Odometry's two workers): each span's
    start lives on its own thread's stack, and the log is written and read
    under a lock."""

    _tls = threading.local()

    def __init__(self, bound: int = 1 << 16):
        self.bound = bound
        self._log: collections.deque = collections.deque(maxlen=bound)
        self._lock = threading.Lock()

    @classmethod
    @contextlib.contextmanager
    def suppressed(cls):
        prev = getattr(cls._tls, "off", False)
        cls._tls.off = True
        try:
            yield
        finally:
            cls._tls.off = prev

    @contextlib.contextmanager
    def time(self, stage: str):
        if getattr(self._tls, "off", False):
            yield
            return
        t0 = time.time_ns()
        try:
            yield
        finally:
            t1 = time.time_ns()
            with self._lock:
                self._log.append((stage, threading.get_ident(), t0, t1))

    def spans(self) -> List[Tuple[str, int, int, int]]:
        """The log: (name, thread, start_ns, end_ns) in the order the spans
        closed (an enclosing span after the spans inside it)."""
        with self._lock:
            return list(self._log)

    @property
    def samples(self) -> Dict[str, List[float]]:
        """{name: [seconds of each logged call, oldest first]}."""
        out: Dict[str, List[float]] = {}
        for name, _, t0, t1 in self.spans():
            out.setdefault(name, []).append((t1 - t0) * 1e-9)
        return out

    def reset(self):
        """Drop all recorded spans (bench phase boundaries)."""
        with self._lock:
            self._log.clear()

    def stats(self) -> Dict[str, dict]:
        out = {}
        for k, xs in self.samples.items():
            xs = sorted(xs)
            n = len(xs)
            out[k] = {
                "n": n,
                "mean_ms": 1e3 * sum(xs) / n,
                "p50_ms": 1e3 * xs[n // 2],
                "p90_ms": 1e3 * xs[min(n - 1, int(n * 0.9))],
            }
        return out


class DeviceStageTimer:
    """Per-stage DEVICE time from CUDA event pairs.

    `time(stage)` records one event on the current stream before the block
    and one after it; nothing waits. `stats()` synchronises once and reads
    every pair, so a timed pipeline keeps its asynchrony. Host wall time of
    the same blocks is what `StageTimer` measures. A span's two events are
    recorded by the thread that runs the block, on that thread's current
    stream."""

    def __init__(self):
        self.pairs: Dict[str, list] = {}

    @contextlib.contextmanager
    def time(self, stage: str):
        import torch

        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        try:
            yield
        finally:
            end.record()
            self.pairs.setdefault(stage, []).append((start, end))

    def stats(self) -> Dict[str, dict]:
        import torch

        torch.cuda.synchronize()
        out = {}
        for k, pairs in self.pairs.items():
            xs = sorted(s.elapsed_time(e) for s, e in pairs)
            n = len(xs)
            out[k] = {
                "n": n,
                "mean_ms": sum(xs) / n,
                "p50_ms": xs[n // 2],
                "p90_ms": xs[min(n - 1, int(n * 0.9))],
            }
        return out


GLOBAL_TIMER = StageTimer()
