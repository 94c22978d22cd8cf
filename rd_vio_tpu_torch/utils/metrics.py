"""Structured per-frame metrics and stage timing.

The reference only has scoped wall-clock debug timers and per-call latency
prints (SURVEY.md §5 tracing). Here: a stage-latency ring buffer + JSONL
emission of per-frame metrics (tracked keypoints, inlier ratios, solver
iterations, stage timings), and context-manager timers.
"""

from __future__ import annotations

import collections
import contextlib
import json
import threading
import time
from typing import Dict, Optional


class StageTimer:
    """Per-stage wall-clock ring buffers (reference unique_timer.h analogue).

    `suppressed()` disables recording for the current thread. Threads may
    time spans at once (a threaded Odometry's two workers): each span's
    start lives on its own thread's stack, and the ring buffers are written
    and read under a lock."""

    _tls = threading.local()

    def __init__(self, window: int = 256):
        self.window = window
        self.samples: Dict[str, collections.deque] = {}
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
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                self.samples.setdefault(
                    stage, collections.deque(maxlen=self.window)
                ).append(dt)

    def reset(self):
        """Drop all recorded samples (bench phase boundaries)."""
        with self._lock:
            self.samples.clear()

    def stats(self) -> Dict[str, dict]:
        with self._lock:
            snapshot = {k: list(dq) for k, dq in self.samples.items()}
        out = {}
        for k, dq in snapshot.items():
            if not dq:
                continue
            xs = sorted(dq)
            n = len(xs)
            out[k] = {
                "n": n,
                "mean_ms": 1e3 * sum(xs) / n,
                "p50_ms": 1e3 * xs[n // 2],
                "p90_ms": 1e3 * xs[min(n - 1, int(n * 0.9))],
            }
        return out


class MetricsLogger:
    """JSONL per-frame metrics sink."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self._fh = open(path, "a") if path else None
        self.latest: dict = {}

    def log(self, **kv):
        self.latest = kv
        if self._fh:
            self._fh.write(json.dumps(kv) + "\n")
            self._fh.flush()

    def close(self):
        if self._fh:
            self._fh.close()
            self._fh = None


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
