"""BatchedVIO: N independent sequences through one lockstep pipeline.

Port of the JAX package's batch/runtime.py. The runtime advances N
sequences one frame per tick: each sequence runs its whole host state
machine (feature tracking, judge, keyframe logic: the single-sequence
semantics per stream), while every steady-state device solve of the tick
coalesces into one batched program per stage through the shared
BatchDispatcher. Restrictions (checked): all sequences share one Caps and
one camera calibration, since the batched programs take one calibration
tree. Sequences may differ in content (scenes, keyframe cadence, dynamic
objects): branch divergence within a tick is handled with masked dummy
rows.

Everything runs on the card unless the caller names another device
(`device="cpu"`); without a card the default raises, as Odometry does.
"""

from __future__ import annotations

import functools
import time
from typing import Callable, List, Optional

import numpy as np

from rd_vio_tpu_torch.batch.dispatcher import BatchDispatcher
from rd_vio_tpu_torch.batch.swt import BatchSWT
from rd_vio_tpu_torch.models.odometry import Odometry


class BatchedVIO:
    def __init__(self, configs: List, backends: List, caps=None, host_workers: int = 2,
                 device=None):
        """configs, backends: one per sequence. device: where every
        sequence's estimator runs (None: each backend's, else the card).
        host_workers > 1 runs the sequences' host steps of a tick on that
        many threads (their NumPy and native parts release the interpreter
        lock); results do not depend on it."""
        if len(configs) != len(backends) or not configs:
            raise ValueError("BatchedVIO needs one backend per config, at least one")
        self.n = len(configs)
        self.odos: List[Odometry] = []
        self.disp: Optional[BatchDispatcher] = None
        K0 = np.asarray(configs[0].camera_intrinsic)
        for i, (cfg, be) in enumerate(zip(configs, backends)):
            if not np.allclose(np.asarray(cfg.camera_intrinsic), K0):
                raise ValueError(
                    "BatchedVIO requires one shared camera calibration: the batched "
                    "device programs take a single calibration tree")
            odo = Odometry(cfg, be, caps=caps, threaded=False, device=device)
            if self.disp is None:
                self.disp = BatchDispatcher(self.n, odo.calib, cfg.solver_iteration_limit)
            odo.frontend.swt_factory = functools.partial(
                BatchSWT, dispatcher=self.disp, seq_index=i)
            self.odos.append(odo)
        self.device = self.odos[0].device
        # the sequences' host work per tick is independent (separate maps,
        # random sources and submission slots); continuations touch disjoint
        # per-sequence state, so only their order across sequences varies
        self._pool = None
        if host_workers > 1 and self.n > 1:
            import concurrent.futures as cf

            self._pool = cf.ThreadPoolExecutor(max_workers=host_workers,
                                               thread_name_prefix="rdvio-batch")

    # -- lockstep ingestion ----------------------------------------------------
    def add_motion(self, i: int, t: float, gyro, accel):
        self.odos[i].add_motion(t, gyro, accel)

    def add_frame_tick(self, frames):
        """One lockstep tick: frames[i] = (t, image), or None for a sequence
        with no frame this tick. Every host pipeline advances one frame,
        then the dispatcher flushes the tick's coalesced device work."""
        if self._pool is not None:
            futs = [self._pool.submit(self._add_frame, i, fr[0], fr[1])
                    for i, fr in enumerate(frames) if fr is not None]
            for f in futs:
                f.result()
        else:
            for i, fr in enumerate(frames):
                if fr is not None:
                    self.odos[i].add_frame(fr[0], fr[1])
        self.disp.flush()

    def _add_frame(self, i, t, image):
        # a pool thread's CUDA work goes to the card of this runtime
        if self.device.type == "cuda":
            import torch

            with torch.cuda.device(self.device):
                self.odos[i].add_frame(t, image)
        else:
            self.odos[i].add_frame(t, image)

    def states(self):
        """Per sequence: (tracking?, latest (t, q, p, v, bg, ba) or None)."""
        return [(odo.state() == 1, odo.handler.get_latest_state()) for odo in self.odos]

    def close(self):
        self.disp.flush()
        for odo in self.odos:
            odo.close()
        if self._pool is not None:
            self._pool.shutdown(wait=True)


def run_sequences_lockstep(configs, backends, seqs, caps=None,
                           on_tick: Optional[Callable] = None, device=None,
                           n_ticks: Optional[int] = None,
                           on_start: Optional[Callable] = None):
    """Drive N synthetic sequences (a shared frame cadence) in lockstep, to
    the end of the shortest or for `n_ticks` ticks. Returns (ticks, per
    sequence the list of (t, p) of its tracked states, each tick's
    wall-clock stamp, the batched keyframe flushes after each tick):
    callers take steady-state throughput from the stamps and ATE from the
    states. on_tick(k) runs after tick k; on_start(vio) once, with the
    BatchedVIO, before the first tick."""
    n_frames = min(len(s.t_frame) for s in seqs)
    if n_ticks is not None:
        n_frames = min(n_frames, int(n_ticks))
    vio = BatchedVIO(configs, backends, caps=caps, device=device)
    cursors = [0] * len(seqs)  # per-sequence IMU event cursor
    est = [[] for _ in seqs]
    stamps = []
    kf_flushes = []  # batched keyframe flushes after each tick
    try:
        if on_start is not None:
            on_start(vio)
        for k in range(n_frames):
            for i, s in enumerate(seqs):
                t_f = s.t_frame[k]
                c = cursors[i]
                while c < len(s.t_imu) and s.t_imu[c] <= t_f:
                    vio.add_motion(i, s.t_imu[c], s.gyro[c], s.accel[c])
                    c += 1
                cursors[i] = c
            vio.add_frame_tick([(s.t_frame[k], k) for s in seqs])
            stamps.append(time.perf_counter())
            kf_flushes.append(vio.disp.n_kf_flushes)
            for i, odo in enumerate(vio.odos):
                if odo.state() == 1:
                    ls = odo.handler.get_latest_state()
                    if ls is not None and (not est[i] or ls[0] != est[i][-1][0]):
                        est[i].append((ls[0], ls[2]))
            if on_tick is not None:
                on_tick(k)
    finally:
        vio.close()
    return n_frames, est, stamps, kf_flushes


def steady_window_start(kf_flushes, margin: int = 5) -> int:
    """First tick index safely inside the batched steady state: `margin`
    ticks past the third batched keyframe flush (before it the pipeline is
    in its unbatched initialization and window filling). Falls back to the
    midpoint when steady state was never reached."""
    for k, n in enumerate(kf_flushes):
        if n >= 3:
            return min(k + margin, max(len(kf_flushes) - 2, 0))
    return len(kf_flushes) // 2
