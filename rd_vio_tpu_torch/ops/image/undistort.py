"""Image undistortion via precomputed remap tables.

Port of the JAX package's ops/image/undistort.py. Behavioral reference: the
reference's image_undistorter.h:16-84 (radtan + equidistant remap tables;
its examples use cv::undistort equivalently, dataset.hpp:232-236).

The remap table maps each undistorted output pixel to its source coordinate
in the distorted input (forward distortion model). It is built once on the
host in f64 (the JAX package builds it under x64) and applied per frame as
one bilinear gather on the device that holds the image and the tables.
"""

from __future__ import annotations

import numpy as np
import torch

from rd_vio_tpu_torch.ops import camera


def build_remap(K, dist, model: str, width: int, height: int):
    """Host-precomputed (map_y, map_x) f32 arrays of shape (H, W)."""
    ys, xs = np.mgrid[0:height, 0:width].astype(np.float64)
    pix = torch.from_numpy(np.stack([xs, ys], axis=-1).reshape(-1, 2))
    K = np.asarray(K, np.float64)
    dist = np.asarray(dist, np.float64)
    distort = camera.distort_radtan if model == "radtan" else camera.distort_equidistant
    src = camera.apply_k(distort(camera.remove_k(pix, K), dist), K).numpy()
    map_x = src[:, 0].reshape(height, width).astype(np.float32)
    map_y = src[:, 1].reshape(height, width).astype(np.float32)
    return map_y, map_x


def _fma(x, y, z):
    """x * y + z for f32 tensors, rounded once to f32 as a fused
    multiply-add rounds it: the product of two f32 is exact in f64, so only
    the sum rounds (to f64, then to f32; the two roundings differ from one
    only where the f64 sum falls on an f32 midpoint)."""
    return (x.double() * y.double() + z.double()).float()


def remap_bilinear(img: torch.Tensor, map_y: torch.Tensor, map_x: torch.Tensor):
    """Sample img (H, W) f32 at (map_y, map_x) bilinearly; out-of-range -> 0.

    The blend is the JAX package's expression in the order its CPU compiler
    evaluates it, which contracts the sum into fused multiply-adds:
    fma(d*wy, wx, fma(c*wy, 1-wx, fma(a*(1-wy), 1-wx, b*(1-wy)*wx))) for
    the corners a = img[y0, x0], b = img[y0, x0+1], c = img[y0+1, x0],
    d = img[y0+1, x0+1]. CLAHE truncates its input to integers, so one ulp
    of difference can move a pixel to another histogram bin. The fused
    steps are written out (see _fma), so the card and the CPU give the same
    bits."""
    H, W = img.shape
    x0 = torch.floor(map_x)
    y0 = torch.floor(map_y)
    wx = map_x - x0
    wy = map_y - y0
    x0i = x0.to(torch.int64).clamp(0, W - 2)
    y0i = y0.to(torch.int64).clamp(0, H - 2)
    a, b = img[y0i, x0i], img[y0i, x0i + 1]
    c, d = img[y0i + 1, x0i], img[y0i + 1, x0i + 1]
    v = _fma(d * wy, wx, _fma(c * wy, 1 - wx, _fma(a * (1 - wy), 1 - wx,
                                                  b * (1 - wy) * wx)))
    inside = (map_x >= 0) & (map_x <= W - 1) & (map_y >= 0) & (map_y <= H - 1)
    return torch.where(inside, v, torch.zeros((), dtype=v.dtype, device=v.device))
