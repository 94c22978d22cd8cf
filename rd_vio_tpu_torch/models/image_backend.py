"""Real-pixel image backend: CLAHE preprocess + pyramid + GFTT + pyramidal LK.

Plays the role of the reference's `extra::OpenCvImage` (opencv_image.cpp)
behind the abstract Image seam: preprocess = CLAHE + pyramid (:156-161),
detect = GFTT + Poisson spacing + border (:38-73), track = fwd/bwd pyramidal
LK (:75-154). The counterpart of the JAX package's JaxImageBackend; every
tensor lives on the backend's `device` (the GPU unless the caller names
another), and on a CUDA device LK is one launch of the hand-written kernel
(ops/image/klt.lk_track_fwd_rev) unless `lk` names another tracker.
"""

from __future__ import annotations

import logging
from typing import Tuple

import numpy as np
import torch

from rd_vio_tpu_torch.ops.image import clahe as clahe_mod
from rd_vio_tpu_torch.ops.image import gftt as gftt_mod
from rd_vio_tpu_torch.ops.image import klt as klt_mod
from rd_vio_tpu_torch.ops.image import pyramid as pyr_mod
from rd_vio_tpu_torch.utils.host import fetch, to_device


def preprocess_fused(img: torch.Tensor, tx: int, ty: int, clip: float,
                     levels: int, clahe_on: bool):
    """u8 -> f32 cast + CLAHE (tile-padded) + pyramid."""
    x = img.to(torch.float32)
    if clahe_on:
        H, W = x.shape
        Hp = -(-H // ty) * ty
        Wp = -(-W // tx) * tx
        if (Hp, Wp) != (H, W):
            x = pyr_mod.pad_edge(x, 0, Hp - H, 0, Wp - W)
        x = clahe_mod.clahe(x, tx, ty, clip)
        x = x[:H, :W].contiguous()
    return pyr_mod.build_pyramid(x, levels)


class ProcessedImage:
    """Opaque image handle: preprocessed pyramid + release hook
    (reference OpenCvImage release_image_buffer, opencv_image.cpp:200-208)."""

    __slots__ = ("pyramid", "shape")

    def __init__(self, pyramid, shape):
        self.pyramid = pyramid
        self.shape = shape

    def release(self):
        self.pyramid = None


class TorchImageBackend:
    """ImageBackend over real pixel arrays, computing on `device`."""

    # pyramids stay on the device => the device-resident frontend loop
    # (ops/frontend_loop) can chain frame pairs without host copies
    supports_device_loop = True

    def __init__(self, config, device="cuda", levels: int = 3,
                 kp_cap: int = 512, clahe_enabled: bool = True,
                 lk=klt_mod.lk_track_fwd_rev):
        self.config = config
        self.device = torch.device(device)
        self.levels = levels
        self.kp_cap = kp_cap  # fixed tracking batch capacity
        self.clahe_enabled = clahe_enabled
        self.lk = lk  # the tracker; klt.lk_track_fwd_rev_plain for comparisons

    # -- preprocessing --------------------------------------------------
    def preprocess(self, img: np.ndarray) -> ProcessedImage:
        """img: (H, W) grayscale in [0, 255]; uint8 uploads byte-exact,
        other dtypes are cast host-side to f32."""
        cfg = self.config
        if img.dtype != np.uint8:
            img = np.asarray(img, np.float32)
        pyr = preprocess_fused(
            to_device(img, self.device),
            tx=int(cfg.feature_tracker_clahe_width),
            ty=int(cfg.feature_tracker_clahe_height),
            clip=float(cfg.feature_tracker_clahe_clip_limit),
            levels=self.levels, clahe_on=self.clahe_enabled,
        )
        return ProcessedImage(pyr, img.shape)

    # -- ImageBackend protocol ------------------------------------------
    def detect(self, image: ProcessedImage, existing_pix, max_points, min_dist):
        cap = 256
        ex = np.zeros((cap, 2), np.float32)
        ev = np.zeros(cap, bool)
        n = min(len(existing_pix), cap)
        if n:
            ex[:n] = existing_pix[:n]
            ev[:n] = True
        pix, valid, _ = fetch(gftt_mod.detect_gftt(
            image.pyramid[0], to_device(ex, self.device),
            to_device(ev, self.device),
            max_points=int(max_points), min_dist=float(min_dist),
        ))
        return pix[valid]

    def _check_cap(self, n: int) -> int:
        if n > self.kp_cap:
            logging.getLogger(__name__).warning(
                "image backend keypoint capacity exceeded (%d > kp_cap=%d); "
                "extra keypoints lost this frame (raise kp_cap)",
                n, self.kp_cap,
            )
        return min(n, self.kp_cap)

    def _pack(self, prev_pix, pred_pix):
        cap = self.kp_cap
        p = np.zeros((cap, 2), np.float32)
        g = np.zeros((cap, 2), np.float32)
        v = np.zeros(cap, bool)
        nn = self._check_cap(len(prev_pix))
        p[:nn] = prev_pix[:nn]
        g[:nn] = pred_pix[:nn]
        v[:nn] = True
        return (to_device(p, self.device), to_device(g, self.device),
                to_device(v, self.device))

    def track(self, prev_image: ProcessedImage, next_image: ProcessedImage,
              prev_pix, pred_pix) -> Tuple[np.ndarray, np.ndarray]:
        n = len(prev_pix)
        tracked, status = fetch(self.lk(
            prev_image.pyramid, next_image.pyramid,
            *self._pack(prev_pix, pred_pix),
        ))
        return self._fit(tracked, n), self._fit(status, n)

    @staticmethod
    def _fit(a: np.ndarray, n: int) -> np.ndarray:
        """Return exactly n rows: slice, or zero-pad (status False / pixel 0)
        for over-capacity slots already warned about in _check_cap."""
        if len(a) >= n:
            return a[:n]
        pad = np.zeros((n - len(a),) + a.shape[1:], a.dtype)
        return np.concatenate([a, pad], axis=0)

    def track_and_detect(self, prev_image: ProcessedImage,
                         next_image: ProcessedImage, prev_pix, pred_pix,
                         max_points: int, min_dist: float):
        """LK fwd+rev plus GFTT detection on the new frame spaced against the
        surviving tracked points. Returns (next_pix (N, 2), status (N,),
        new_pix (M, 2))."""
        n = len(prev_pix)
        tracked, status = self.lk(
            prev_image.pyramid, next_image.pyramid,
            *self._pack(prev_pix, pred_pix),
        )
        preset = torch.where(status[:, None], tracked, -1e6)
        pix, val, _ = gftt_mod.detect_gftt(
            next_image.pyramid[0], preset, status,
            max_points=int(max_points), min_dist=float(min_dist),
        )
        tracked, status, pix, val = fetch((tracked, status, pix, val))
        return self._fit(tracked, n), self._fit(status, n), pix[val]
