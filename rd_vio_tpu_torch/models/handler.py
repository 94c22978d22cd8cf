"""Sensor front door: gyro/accel interleaving, IMU->frame association, and
IMU-rate pose prediction.

Behavioral reference: the reference's src/rdvio/src/handler.cpp —
track_gyroscope/track_accelerometer interpolation (:56-111), track_imu frame
dispatch (:140-152), predict_pose forward-Euler propagation for low-latency
output (:13-26, 154-177), track_camera frame packing (:113-138), and the
THREADING=ON worker model (:35-50: one thread runs the feature tracker, one
runs the frontend/optimizer) — implemented here as event-driven queues rather
than 1/5 ms polling loops; `threaded=False` reproduces THREADING=OFF inline
dispatch (feature_tracker.cpp:113-118, frontend.cpp:68-73).

On a CUDA device each worker runs under `torch.cuda.device(device)`: the
current device and stream are per-thread state. Both workers launch on that
device's default stream, so a tensor the tracker thread made is ready, in
stream order, for the estimator thread's kernels. The host spans
`worker.tracker` and `worker.estimator` time each worker's work per frame.
"""

from __future__ import annotations

import queue
import threading
from collections import deque
from typing import Optional

import numpy as np
import torch

from rd_vio_tpu_torch.utils.host import asnp, fetch
from rd_vio_tpu_torch.utils.metrics import GLOBAL_TIMER as T

from rd_vio_tpu_torch.models import builders
from rd_vio_tpu_torch.models.map import Frame
from rd_vio_tpu_torch.models.quat_np import qmul, qnorm, qrot

GRAVITY = np.array([0.0, 0.0, -9.80665])


def _propagate(q, p, v, dt, w, a, bg, ba):
    """Forward-Euler IMU propagation (reference handler.cpp:13-26)."""
    from scipy.spatial.transform import Rotation

    a_world = qrot(q, a - ba) + GRAVITY
    rv = (w - bg) * dt
    dq = Rotation.from_rotvec(rv).as_quat()
    q_new = qnorm(qmul(q, np.array([dq[3], dq[0], dq[1], dq[2]])))
    p_new = p + dt * v + 0.5 * dt * dt * a_world
    v_new = v + dt * a_world
    return q_new, p_new, v_new


class Handler:
    def __init__(self, config, feature_tracker, frontend, threaded: bool = False,
                 device=None):
        """device: where the workers launch (threaded mode); None or a CPU
        device runs them without a CUDA device scope."""
        self.config = config
        self.feature_tracker = feature_tracker
        self.frontend = frontend
        self.pending_frames = deque()  # frames waiting for IMU coverage
        self.gyros = deque()  # (t, w) awaiting accel interleave
        self.accels = deque()  # (t, a) awaiting gyro interleave
        self.frontal_imus = deque(maxlen=4096)  # fused samples for prediction
        self._frame_samples = []  # (t, w, a) accumulating for the front frame
        self._last_sample = None  # last dispatched fused sample
        self._last_frame_t = None

        # -- threaded pipeline (reference handler.cpp:35-50) --------------
        self.threaded = threaded
        self._ft_queue: Optional[queue.Queue] = None
        self._ft_worker: Optional[threading.Thread] = None
        self._fe_worker: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._worker_error: Optional[BaseException] = None
        self._closed = False
        if threaded:
            frontend.threaded = True
            # bounded: ingestion blocks rather than letting the tracker race
            # arbitrarily far ahead of the optimizer
            self._ft_queue = queue.Queue(maxsize=4)
            self.device = torch.device(device) if device is not None else None
            self._ft_worker = threading.Thread(
                target=self._on_device, args=(self._ft_loop,),
                name="rdvio-feature-tracker", daemon=True
            )
            self._fe_worker = threading.Thread(
                target=self._on_device, args=(self._fe_loop,),
                name="rdvio-frontend", daemon=True
            )
            self._ft_worker.start()
            self._fe_worker.start()

    # -- worker loops (threaded mode) -----------------------------------
    def _on_device(self, loop):
        if self.device is not None and self.device.type == "cuda":
            with torch.cuda.device(self.device):
                loop()
        else:
            loop()

    def _ft_loop(self):
        while True:
            frame = self._ft_queue.get()
            if frame is None:
                self._ft_queue.task_done()
                return
            try:
                # backpressure: keep the optimizer at most 2 frames behind so
                # every frame is estimated (throughput = slowest stage, with
                # the two stages overlapped)
                self.frontend.wait_for_backlog(2, self._stop)
                # after a worker error, keep consuming (so producers never
                # block forever on the bounded queue) but stop processing
                if self._worker_error is None and not self._stop.is_set():
                    with T.time("worker.tracker"):
                        self.feature_tracker.track_frame(frame)
            except BaseException as e:  # noqa: BLE001 — reported via join()
                self._record_worker_error(e)
            finally:
                self._ft_queue.task_done()

    def _fe_loop(self):
        while not self._stop.is_set():
            try:
                if not self.frontend.wait_for_work(self._stop, timeout=0.2):
                    continue
                with T.time("worker.estimator"):
                    self.frontend.run()
            except BaseException as e:  # noqa: BLE001 — reported via join()
                self._record_worker_error(e)

    def _record_worker_error(self, e: BaseException):
        """First worker exception wins; unblock everything so join()/close()
        can surface it instead of hanging the process."""
        if self._worker_error is None:
            self._worker_error = e
        self._stop.set()
        self.frontend.wake()

    def join(self):
        """Block until both pipeline stages have drained (threaded mode).
        Re-raises the first worker exception, if any."""
        if not self.threaded:
            return
        self._ft_queue.join()
        self.frontend.wait_for_backlog(0, self._stop)
        if self._worker_error is not None:
            raise RuntimeError(
                "rdvio pipeline worker failed"
            ) from self._worker_error

    def close(self):
        if not self.threaded or self._closed:
            return
        self._closed = True
        err = None
        try:
            self.join()
        except RuntimeError as e:
            err = e
        self._stop.set()
        self._ft_queue.put(None)
        self.frontend.wake()
        self._ft_worker.join(timeout=10)
        self._fe_worker.join(timeout=10)
        if err is not None:
            raise err

    # ------------------------------------------------------------------
    def track_camera(self, t: float, image) -> None:
        frame = Frame(t)
        frame.image = image
        self.pending_frames.append(frame)
        self._drain()

    def track_motion(self, t: float, w, a) -> None:
        """Fused gyro+accel sample (reference Odometry::addMotion path)."""
        self._track_imu(t, asnp(w, float), asnp(a, float))

    def track_gyroscope(self, t: float, w) -> None:
        """Interpolate gyro to pending accel timestamps
        (reference handler.cpp:56-80)."""
        self.gyros.append((t, asnp(w, float)))
        self._interleave()

    def track_accelerometer(self, t: float, a) -> None:
        self.accels.append((t, asnp(a, float)))
        self._interleave()

    def _interleave(self):
        while self.accels and len(self.gyros) >= 2:
            ta, a = self.accels[0]
            t0, w0 = self.gyros[0]
            t1, w1 = self.gyros[1]
            if ta < t0:
                self.accels.popleft()
                continue
            if ta > t1:
                self.gyros.popleft()
                continue
            lam = (ta - t0) / max(t1 - t0, 1e-12)
            w = w0 + lam * (w1 - w0)
            self.accels.popleft()
            self._track_imu(ta, w, a)

    def _track_imu(self, t, w, a):
        self.frontal_imus.append((t, w, a))
        self._frame_samples.append((t, w, a))
        self._drain()

    def _drain(self):
        """Dispatch pending frames whose interval is fully covered by IMU
        (reference handler.cpp:140-152)."""
        while self.pending_frames:
            frame = self.pending_frames[0]
            have = [s for s in self._frame_samples if s[0] <= frame.t + 1e-12]
            if self._frame_samples and self._frame_samples[-1][0] > frame.t + 1e-12:
                pass  # covered
            elif not self._frame_samples or self._frame_samples[-1][0] <= frame.t + 1e-12:
                return  # wait for more IMU
            rest = [s for s in self._frame_samples if s[0] > frame.t + 1e-12]
            self._dispatch(frame, have)
            self._frame_samples = rest
            self.pending_frames.popleft()

    def _dispatch(self, frame: Frame, samples):
        """Build (dt, w, a) arrays covering (prev_frame_t, frame.t]; stitch the
        boundary with the previous interval's last sample (the gap-stitching of
        reference feature_tracker.cpp:70-81)."""
        seq = list(samples)
        if self._last_sample is not None and self._last_frame_t is not None:
            t0, w0, a0 = self._last_sample
            seq.insert(0, (self._last_frame_t, w0, a0))
        if seq:
            times = np.array([s[0] for s in seq])
            dts = np.empty(len(seq))
            dts[:-1] = np.diff(times)
            dts[-1] = max(frame.t - times[-1], 0.0)
            frame.imu_dt = dts
            frame.imu_w = np.stack([s[1] for s in seq])
            frame.imu_a = np.stack([s[2] for s in seq])
            self._last_sample = samples[-1] if samples else self._last_sample
        self._last_frame_t = frame.t
        if self.threaded:
            self._ft_queue.put(frame)  # blocks when the pipeline is full
        else:
            with T.time("handler.host_step"):
                self.feature_tracker.track_frame(frame)

    # ------------------------------------------------------------------
    def predict_pose(self, t: float):
        """Latest optimized/tracked state + forward Euler over newer IMU
        samples (reference handler.cpp:154-177)."""
        st = self.get_latest_state()
        if st is None:
            return None
        t0, q, p, v, bg, ba = st
        for ts, w, a in self.frontal_imus:
            if ts <= t0 or ts > t:
                continue
            dt = ts - t0
            q, p, v = _propagate(q, p, v, dt, w, a, bg, ba)
            t0 = ts
        if t > t0:
            # hold last sample to t
            if self.frontal_imus:
                _, w, a = self.frontal_imus[-1]
                q, p, v = _propagate(q, p, v, t - t0, w, a, bg, ba)
        return q, p

    def get_latest_state(self):
        ls = self.feature_tracker.latest_state
        if ls is None:
            return None
        t, q, p, v, bg, ba = ls
        return t, q.copy(), p.copy(), v.copy(), bg.copy(), ba.copy()
