"""The benchmark's own copy of the lockstep loop (the port's
`batch.runtime.run_sequences_lockstep`) and of its steady-window rule
(`steady_window_start`), so that the yardstick does not move when the
program does.

The loop is closed: tick k + 1 is offered when tick k has returned. Each
tick feeds every sequence its IMU samples up to the frame's time, then
hands `BatchedVIO.add_frame_tick` one frame per sequence. Every pose a
sequence publishes is stamped on the host's clock as it is published
(`frontend.on_publish`), so the window counts the poses published inside
it. (A sequence's handler runs a frame's host step when the IMU samples
after the frame arrive, so a frame is published in the tick after the one
that offered it.)
"""

from __future__ import annotations

import time
from typing import List, Optional

import numpy as np


class SequencesEnded(RuntimeError):
    """A tick was due after the sequences' last frame."""


class Lockstep:
    """N sequences in lockstep through one `BatchedVIO` (see the module
    docstring)."""

    def __init__(self, vio, seqs):
        self.vio = vio
        self.seqs = seqs
        self.n = len(seqs)
        self.n_frames = min(len(s.t_frame) for s in seqs)
        self.k = 0  # the next tick
        self._imu = [0] * self.n
        self.tick_start: List[float] = []
        self.tick_end: List[float] = []
        self.kf_flushes: List[int] = []  # batched keyframe flushes after each tick
        # per sequence: (frame time, position, publication stamp)
        self.published = [[] for _ in range(self.n)]
        self.stamps = None  # a trace.PhaseStamps, while a traced run profiles
        for i, odo in enumerate(vio.odos):
            odo.frontend.on_publish = self._publisher(i)

    def _publisher(self, i):
        pubs = self.published[i]

        def on_publish(state):
            # (t, last_id, q, p, v, bg, ba); called on a host worker thread
            stamp = time.perf_counter()
            pubs.append((float(state[0]), np.array(state[3], float), stamp))

        return on_publish

    def tick(self):
        """Offer frame k of every sequence; returns the tick's index."""
        k = self.k
        if k >= self.n_frames:
            raise SequencesEnded(f"the sequences end after {self.n_frames} frames: tick {k} "
                                 "has no frame to offer (the traffic's sequences are too "
                                 "short for this run)")
        # the tick starts with its IMU samples: a sequence's handler runs its
        # previous frame's host step when the samples after that frame come
        t0 = time.perf_counter()
        self.tick_start.append(t0)
        for i, s in enumerate(self.seqs):
            t_f = s.t_frame[k]
            c = self._imu[i]
            while c < len(s.t_imu) and s.t_imu[c] <= t_f:
                self.vio.add_motion(i, s.t_imu[c], s.gyro[c], s.accel[c])
                c += 1
            self._imu[i] = c
        if self.stamps is not None and self.stamps.on:
            self.stamps.spans.append(("IMU feed: the sequences' previous-frame host steps",
                                      t0, time.perf_counter()))
        self.vio.add_frame_tick([(s.t_frame[k], k) for s in self.seqs])
        self.tick_end.append(time.perf_counter())
        self.kf_flushes.append(self.vio.disp.n_kf_flushes)
        self.k = k + 1
        return k

    def states(self):
        return [odo.state() for odo in self.vio.odos]

    def close(self):
        self.vio.close()


def steady_window_start(kf_flushes, flushes: int = 3, margin: int = 5) -> Optional[int]:
    """The tick after which the window opens: `margin` ticks past the tick
    of the `flushes`-th batched keyframe flush; None before that tick."""
    for k, n in enumerate(kf_flushes):
        if n >= flushes:
            start = k + margin
            return start if start < len(kf_flushes) else None
    return None

