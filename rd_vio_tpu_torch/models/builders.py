"""Host pieces of the JAX package's models/builders.py that the feature
tracker needs: the static capacities (`Caps`), the calibration constants
(`CalibArrays`, NumPy only) and the mean-only IMU state prediction
(`predict_frame`, `propagate_chain`), and `cast_floats`, which puts a
window problem in the solver's dtype.

The BA-problem assembly and the estimator device programs of that module are
not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch
from torch.utils._pytree import tree_map

from rd_vio_tpu_torch.models.map import Frame
from rd_vio_tpu_torch.ops import preintegration_np as pre_np


@dataclasses.dataclass(frozen=True)
class Caps:
    """Static capacities (same fields and defaults as the JAX package)."""

    W: int = 20  # frame slots per solve
    L: int = 512  # landmark slots
    O: int = 3072  # reprojection factor slots
    P: int = 512  # fixed-anchor reprojection-prior slots
    Fi: int = 24  # imu factor slots
    Fp: int = 4  # fixed-i imu-prior slots
    R: int = 256  # rotation-prior factor slots
    IMU: int = 96  # imu samples per frame interval
    IMU_KF: int = 512  # imu samples per keyframe chain
    TRI_VIEWS: int = 24  # views per track in batched triangulation
    TRI_PAD: int = 64  # per-keyframe triangulation batch


@dataclasses.dataclass
class CalibArrays:
    """Config-derived calibration constants, all host NumPy (f64)."""

    K: np.ndarray  # intrinsics
    sqrt_inv_cov2: np.ndarray  # K-scaled pixel whitening
    q_bc_h: np.ndarray
    p_bc_h: np.ndarray
    q_bi_h: np.ndarray
    p_bi_h: np.ndarray
    cov_w_h: np.ndarray
    cov_a_h: np.ndarray
    cov_bg_h: np.ndarray
    cov_ba_h: np.ndarray

    @staticmethod
    def from_config(cfg) -> "CalibArrays":
        Km = np.asarray(cfg.camera_intrinsic, np.float64)
        # K-scaled pixel whitening (reference handler.cpp:117-119)
        sic2 = np.diag(
            [
                Km[0, 0] / np.sqrt(cfg.keypoint_noise_cov[0, 0]),
                Km[1, 1] / np.sqrt(cfg.keypoint_noise_cov[1, 1]),
            ]
        )
        f64 = lambda a: np.array(a, np.float64)  # noqa: E731
        return CalibArrays(
            K=Km, sqrt_inv_cov2=sic2,
            q_bc_h=f64(cfg.camera_to_body_rotation),
            p_bc_h=f64(cfg.camera_to_body_translation),
            q_bi_h=f64(cfg.imu_to_body_rotation),
            p_bi_h=f64(cfg.imu_to_body_translation),
            cov_w_h=f64(cfg.gyroscope_noise_cov),
            cov_a_h=f64(cfg.accelerometer_noise_cov),
            cov_bg_h=f64(cfg.gyroscope_bias_noise_cov),
            cov_ba_h=f64(cfg.accelerometer_bias_noise_cov),
        )


def predict_frame(frame_prev: Frame, frame: Frame, calib: CalibArrays, cap: int):
    """Preintegrate frame's interval at prev biases and propagate the state
    (reference mirror_frame tail / judge_track_status head). Mean-only host
    math."""
    frame.q, frame.p, frame.v = pre_np.predict_frame_mean(
        frame_prev.q, frame_prev.p, frame_prev.v, frame_prev.bg, frame_prev.ba,
        frame.imu_dt, frame.imu_w, frame.imu_a,
    )
    frame.bg = frame_prev.bg.copy()
    frame.ba = frame_prev.ba.copy()


def propagate_chain(frames: List[Frame], start: Frame, calib: CalibArrays, cap: int):
    """Re-propagate `frames` (in order) from `start`'s state — pure host math
    (reference feature_tracker.cpp:36-69 re-anchoring loop)."""
    prev = start
    for f in frames:
        f.q, f.p, f.v = pre_np.predict_frame_mean(
            prev.q, prev.p, prev.v, prev.bg, prev.ba,
            f.imu_dt, f.imu_w, f.imu_a,
        )
        f.bg, f.ba = prev.bg.copy(), prev.ba.copy()
        prev = f


def cast_floats(tree, dtype):
    """Every floating-point tensor of a (nested NamedTuple) tree as `dtype`;
    index and mask tensors stay as they are."""
    return tree_map(lambda a: a.to(dtype) if isinstance(a, torch.Tensor)
                    and a.is_floating_point() else a, tree)
