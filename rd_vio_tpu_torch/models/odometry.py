"""Public Odometry API — the reference's `rdvio::Odometry` surface.

Behavioral reference: rdvio.hpp:25-115: addFrame(t, image), addMotion(t,
acc, gyro), addAcc/addGyro, transform_world_cam (output pose composed with
the output extrinsic), state() mapping {0: initializing, 1: tracking,
2: crash, 3: unknown}, local_map()/keypoints().

Port of the JAX package's models/odometry.py. Synchronous (`threaded=False`):
every frame runs to its end inside add_frame. Threaded (the reference's
THREADING=ON model, bench.py's default): the feature tracker and the
estimator run in two worker threads (models/handler.py); call join() before
reading results and close() (or use the Odometry as a context manager) when
done. The estimator runs on `device`, which defaults to the image backend's
(the card for TorchImageBackend's default); the CPU only when asked for.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from rd_vio_tpu_torch.config import Config
from rd_vio_tpu_torch.models import builders
from rd_vio_tpu_torch.models.feature_tracker import FeatureTracker
from rd_vio_tpu_torch.models.frontend import Frontend, SysState
from rd_vio_tpu_torch.models.handler import Handler
from rd_vio_tpu_torch.models.quat_np import qmul, qrot


class Odometry:
    def __init__(self, config: Config, backend, caps: Optional[builders.Caps] = None,
                 threaded: bool = False, device=None,
                 init_noise: Optional[Callable[[], Callable]] = None,
                 swt_noise: Optional[Callable[[], Callable]] = None):
        """backend: TorchImageBackend (the device loop on its device) or
        SyntheticBackend (perfect matches on the host). device: where the
        estimator runs; None means the backend's device, or the card for a
        backend without one. A device that differs from the backend's, or
        the card where there is none, raises. init_noise, swt_noise: see
        Frontend.

        threaded=True runs the reference's THREADING=ON pipeline model
        (handler.cpp:35-50): the feature tracker and the optimizer run in
        worker threads and overlap. threaded=False is fully synchronous."""
        be_dev = getattr(backend, "device", None)
        if device is None:
            device = be_dev if be_dev is not None else "cuda"
        device = torch.device(device)
        if be_dev is not None and torch.device(be_dev) != device:
            raise ValueError(f"Odometry on {device} with a backend on {be_dev}")
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Odometry: no CUDA device; pass device='cpu' to run "
                               "on the CPU")
        self.device = device
        self.config = config
        self.calib = builders.CalibArrays.from_config(config, device=device)
        # keyframe-solve capacity: window keyframes + transient lift slots
        self.caps = caps or builders.Caps(W=config.sliding_window_size + 3)
        self.feature_tracker = FeatureTracker(config, self.calib, self.caps, backend,
                                              device=device)
        self.frontend = Frontend(self.feature_tracker, config, self.calib, self.caps,
                                 init_noise=init_noise, swt_noise=swt_noise)
        self.feature_tracker.frontend = self.frontend
        self.handler = Handler(config, self.feature_tracker, self.frontend,
                               threaded=threaded, device=device)

    # -- pipeline lifecycle ----------------------------------------------
    def join(self):
        """Finish every ingested frame: wait for both workers (threaded),
        finalize the frames the device-loop tracker still holds in flight
        and wait again, then apply any deferred result (a subwindow solve's,
        or an async keyframe step's with its window slide) so final state
        reads see the last solve. Re-raises a worker's first error as
        a RuntimeError chained from it."""
        self.handler.join()
        self.feature_tracker.flush()
        self.handler.join()
        self._drain_swt()

    def close(self):
        """join(), then stop the workers (each given 10 s to exit). A
        worker's error is raised here too, after the workers were told to
        stop."""
        if self.handler.threaded:
            try:
                self.join()
            except RuntimeError:
                pass  # raised again by handler.close below
            self.handler.close()
        else:
            self.join()
        self._drain_swt()

    def _drain_swt(self):
        """Apply any deferred result (subwindow solve or async keyframe
        step) so final state reads see the last solve (join has left no
        estimator work in flight)."""
        swt = self.frontend.swt
        if swt is not None:
            swt.drain_pending()

    def healthy(self) -> bool:
        """False once a pipeline worker has failed (threaded mode): frames
        ingested after that are not processed."""
        return self.handler._worker_error is None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # -- sensor ingestion ------------------------------------------------
    def add_frame(self, t: float, image) -> None:
        backend = self.feature_tracker.backend
        if hasattr(backend, "preprocess"):
            image = backend.preprocess(image)
        self.handler.track_camera(t, image)

    def add_motion(self, t: float, gyro, accel) -> None:
        self.handler.track_motion(t, gyro, accel)

    def add_gyroscope(self, t: float, w) -> None:
        self.handler.track_gyroscope(t, w)

    def add_accelerometer(self, t: float, a) -> None:
        self.handler.track_accelerometer(t, a)

    # -- outputs ---------------------------------------------------------
    def transform_world_cam(self, t: Optional[float] = None):
        """Body pose composed with the output extrinsic (reference
        rdvio.hpp:71-77). Returns (q_wxyz, p) or None before tracking."""
        st = self.handler.predict_pose(t) if t is not None else None
        if st is None:
            ls = self.handler.get_latest_state()
            if ls is None:
                return None
            _, q, p, *_ = ls
        else:
            q, p = st
        q_bo = np.asarray(self.config.output_to_body_rotation)
        p_bo = np.asarray(self.config.output_to_body_translation)
        return qmul(q, q_bo), p + qrot(q, p_bo)

    def state(self) -> int:
        return {
            SysState.SYS_INITIALIZING: 0,
            SysState.SYS_TRACKING: 1,
            SysState.SYS_CRASH: 2,
            SysState.SYS_UNKNOWN: 3,
        }[self.frontend.get_system_state()]

    def local_map(self) -> np.ndarray:
        return self.frontend.get_landmarks()

    def keypoints(self) -> np.ndarray:
        m = self.feature_tracker.map
        if m.frame_num == 0:
            return np.zeros((0, 2))
        return self.feature_tracker._pix_from_bearings(m.get_frame(m.frame_num - 1))
