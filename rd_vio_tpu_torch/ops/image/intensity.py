"""Bicubic intensity evaluation with analytic gradients.

Behavioral reference: the reference's src/rdvio_extra/src/opencv_image.cpp:19-36
(`OpenCvImage::evaluate` via ceres::BiCubicInterpolator — Catmull-Rom cubic
convolution over a 4x4 neighborhood, returning intensity and d(intensity)/du
scaled by the per-level coordinate scale). Unused by the reference's main
tracking path; provided for API completeness (direct photometric methods).

Port of the JAX package's ops/image/intensity.py: batched over query points,
the 4x4 neighborhood of each point is one advanced-indexing gather and the
cubic convolution two contractions against the Catmull-Rom basis. Plain
tensor code on the caller's device, in the image's float dtype (f32 for an
integer image, as the JAX package computes).
"""

from __future__ import annotations

import torch

# Catmull-Rom cubic convolution kernel (a = -0.5), the BiCubicInterpolator
# kernel used by Ceres: weights for samples at offsets {-1, 0, 1, 2} as
# cubic polynomials in the fractional coordinate f.
_CR = torch.tensor(
    [
        # 1, f, f^2, f^3 coefficients per tap
        [0.0, -0.5, 1.0, -0.5],
        [1.0, 0.0, -2.5, 1.5],
        [0.0, 0.5, 2.0, -1.5],
        [0.0, 0.0, -0.5, 0.5],
    ],
    dtype=torch.float64,
)


def _weights(f):
    """(..., 4) Catmull-Rom weights and their derivatives at fraction f."""
    p = torch.stack([torch.ones_like(f), f, f * f, f * f * f], dim=-1)
    dp = torch.stack(
        [torch.zeros_like(f), torch.ones_like(f), 2.0 * f, 3.0 * f * f], dim=-1
    )
    cr_t = _CR.T.to(device=p.device, dtype=p.dtype)
    return p @ cr_t, dp @ cr_t


def evaluate_bicubic(img: torch.Tensor, pts):
    """Bicubic intensity + gradient at float pixel coords.

    img: (H, W); pts: (N, 2) [x, y] on img's device. Returns (value (N,),
    grad (N, 2) [d/dx, d/dy]). Coordinates are clamped to the valid
    interpolation domain (matching the interpolator's edge clamping)."""
    dtype = img.dtype if img.is_floating_point() else torch.float32
    img = img.to(dtype)
    pts = torch.as_tensor(pts, device=img.device).to(dtype)
    H, W = img.shape
    x = torch.clamp(pts[:, 0], 1.0, W - 2.0 - 1e-4)
    y = torch.clamp(pts[:, 1], 1.0, H - 2.0 - 1e-4)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0
    xi = x0.long() - 1
    yi = y0.long() - 1

    taps = torch.arange(4, device=img.device)
    rows = (yi[:, None] + taps)[:, :, None]  # (N, 4, 1)
    cols = (xi[:, None] + taps)[:, None, :]  # (N, 1, 4)
    patch = img[rows, cols]  # (N, 4, 4)

    wx, dwx = _weights(fx)  # (N, 4)
    wy, dwy = _weights(fy)

    val = torch.einsum("nr,nrc,nc->n", wy, patch, wx)
    gx = torch.einsum("nr,nrc,nc->n", wy, patch, dwx)
    gy = torch.einsum("nr,nrc,nc->n", dwy, patch, wx)
    return val, torch.stack([gx, gy], dim=-1)


def evaluate_pyramid(pyramid, pts, level: int):
    """Reference-evaluate semantics at a pyramid level: query coords are in
    LEVEL-0 pixels, scaled into the level (opencv_image.cpp:19-36), and the
    returned gradient is rescaled back to level-0 units."""
    s = 0.5 ** level
    img = pyramid[level]
    pts = torch.as_tensor(pts, device=img.device)
    val, g = evaluate_bicubic(img, pts * s)
    return val, g * s
