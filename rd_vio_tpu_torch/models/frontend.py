"""Frontend state machine: Initializer until success, then the sliding-window
tracker; on tracking failure, re-bootstrap.

Behavioral reference: frontend.cpp:26-97. Port of the JAX package's
models/frontend.py.
"""

from __future__ import annotations

import threading
from enum import Enum
from typing import Callable, Optional

import numpy as np

from rd_vio_tpu_torch.models import builders
from rd_vio_tpu_torch.models.initializer import Initializer
from rd_vio_tpu_torch.models.sliding_window_tracker import SlidingWindowTracker
from rd_vio_tpu_torch.utils.metrics import GLOBAL_TIMER as T


class SysState(Enum):
    SYS_INITIALIZING = 0
    SYS_TRACKING = 1
    SYS_CRASH = 2
    SYS_UNKNOWN = 3


class Frontend:
    def __init__(self, feature_tracker, config, calib: builders.CalibArrays,
                 caps: builders.Caps,
                 init_noise: Optional[Callable[[], Callable]] = None,
                 swt_noise: Optional[Callable[[], Callable]] = None):
        """init_noise: zero-argument factory of each new Initializer's RANSAC
        noise source (see Initializer; default: its own seeded source).
        swt_noise: the same for each new SlidingWindowTracker's device-PARSAC
        noise (see SlidingWindowTracker)."""
        self.feature_tracker = feature_tracker
        self.config = config
        self.calib = calib
        self.caps = caps
        self.init_noise = init_noise
        self.swt_noise = swt_noise
        # optional callable, called with `latest_optimized` after every
        # publish (on the thread that runs the frontend)
        self.on_publish: Optional[Callable[[tuple], None]] = None
        self.initializer: Optional[Initializer] = self._new_initializer()
        self.swt: Optional[SlidingWindowTracker] = None
        # tracker constructor: the batched runtime (rd_vio_tpu_torch.batch)
        # swaps in its dispatcher-coupled subclass here
        self.swt_factory = SlidingWindowTracker
        self.bootstraps = 0  # initializations that succeeded
        self.pending_frame_ids = []
        # (t, frame_id, q, p, v, bg, ba)
        self.latest_optimized = None
        # threaded pipeline mode (reference handler.cpp:35-50): issue_frame
        # only enqueues; Handler's frontend worker drains via run()
        self.threaded = False
        self._cv = threading.Condition()
        # frames popped from pending but still being processed by run();
        # wait_for_backlog counts them so join() truly drains the pipeline
        self._in_flight = 0

    def _new_initializer(self) -> Initializer:
        noise = self.init_noise() if self.init_noise is not None else None
        return Initializer(self.config, self.calib, self.caps, noise=noise)

    @property
    def initializing(self) -> bool:
        return self.initializer is not None

    def issue_frame(self, frame):
        if self.threaded:
            with self._cv:
                self.pending_frame_ids.append(frame.id)
                self._cv.notify_all()
        else:
            self.pending_frame_ids.append(frame.id)
            self.run()

    # -- threaded-mode synchronization helpers ---------------------------
    def wake(self):
        with self._cv:
            self._cv.notify_all()

    def wait_for_work(self, stop, timeout=0.2) -> bool:
        with self._cv:
            if self.pending_frame_ids:
                return True
            self._cv.wait(timeout=timeout)
            return bool(self.pending_frame_ids) and not stop.is_set()

    def wait_for_backlog(self, n: int, stop):
        """Block until <= n frames are pending or in flight (producer
        backpressure; n=0 is a full pipeline drain)."""
        with self._cv:
            while (len(self.pending_frame_ids) + self._in_flight > n
                   and not stop.is_set()):
                self._cv.wait(timeout=0.2)

    def run(self):
        with self._cv:
            if not self.pending_frame_ids:
                return
            if self.initializer is not None:
                fid = self.pending_frame_ids[0]
                self.pending_frame_ids.clear()
            else:
                fid = self.pending_frame_ids.pop(0)
            self._in_flight += 1
            self._cv.notify_all()  # wake backpressured producers
        try:
            self._process(fid)
        finally:
            with self._cv:
                self._in_flight -= 1
                self._cv.notify_all()

    def _process(self, fid):
        ft_map = self.feature_tracker.map
        if self.initializer is not None:
            with ft_map.lock:
                self.initializer.mirror_keyframe_map(ft_map, fid)
            init_map = self.initializer.initialize()
            if init_map is not None:
                self.swt = self.swt_factory(
                    init_map, self.config, self.calib, self.caps,
                    noise=self.swt_noise() if self.swt_noise is not None else None,
                )
                self.swt.feature_tracking_map = ft_map
                self._publish(fid)
                self.initializer = None
                self.bootstraps += 1
        elif self.swt is not None:
            # the deferred subwindow result is drained INSIDE track(), after
            # the judge's state-independent assembly — mirror's structural
            # work (clone/link/prune) doesn't read the states the drain
            # writes, and track() re-predicts the mirrored frame post-drain
            with T.time("swt.mirror"):
                with ft_map.lock:
                    ok = self.swt.mirror_frame(ft_map, fid)
            if not ok:
                return
            if self.swt.track():
                # batched runtime: a deferred keyframe tail publishes from
                # its continuation instead (the state it publishes does not
                # exist until the batched fetch is applied)
                hook = getattr(self.swt, "defer_publish_hook", None)
                if hook is None or not hook(lambda fid=fid: self._publish(fid)):
                    self._publish(fid)
            else:
                self.latest_optimized = None
                self.initializer = self._new_initializer()
                self.swt = None

    def _publish(self, fid):
        t, q, p, v, bg, ba, last_id = self.swt.get_latest_state()
        self.latest_optimized = (t, last_id, q, p, v, bg, ba)
        self.feature_tracker.refresh_from_optimized()
        if self.on_publish is not None:
            self.on_publish(self.latest_optimized)

    def get_system_state(self) -> SysState:
        if self.initializer is not None:
            return SysState.SYS_INITIALIZING
        if self.swt is not None:
            return SysState.SYS_TRACKING
        return SysState.SYS_UNKNOWN

    def get_landmarks(self):
        if self.swt is not None:
            return self.swt.get_landmarks()
        return np.zeros((0, 3))
