"""Pinhole camera projection + distortion models.

Port of the JAX package's ops/camera.py. Behavioral reference: the
reference's rdvio_geometry stereo.h:7-22 (apply_k / remove_k / dproj_dp) and
rdvio_extra image_undistorter.h:16-84 (radtan + equidistant models). Plain
functions on tensors in the caller's dtype and on its device; all broadcast
over leading batch dims. K and dist may be tensors or NumPy arrays (their
entries are read as numbers).

A "bearing" is a unit 3-vector in the camera frame; a "normalized point" is
(x/z, y/z); a "keypoint" is a pixel coordinate (u, v).
"""

from __future__ import annotations

import torch


def apply_k(p_norm, K):
    """Normalized image point (..., 2) -> pixel (..., 2) via intrinsics K (3,3)."""
    fx, fy = K[0, 0], K[1, 1]
    cx, cy = K[0, 2], K[1, 2]
    return torch.stack(
        [p_norm[..., 0] * fx + cx, p_norm[..., 1] * fy + cy], dim=-1
    )


def remove_k(p_pix, K):
    """Pixel (..., 2) -> normalized point (..., 2)."""
    fx, fy = K[0, 0], K[1, 1]
    cx, cy = K[0, 2], K[1, 2]
    return torch.stack(
        [(p_pix[..., 0] - cx) / fx, (p_pix[..., 1] - cy) / fy], dim=-1
    )


def project(x_cam):
    """Camera-frame 3D point (..., 3) -> normalized point (..., 2)."""
    z = x_cam[..., 2:3]
    return x_cam[..., :2] / z


def dproj_dp(x_cam):
    """Jacobian of project() wrt the 3D point (reference stereo.h:18-22).
    (..., 3) -> (..., 2, 3)."""
    x, y, z = x_cam[..., 0], x_cam[..., 1], x_cam[..., 2]
    iz = 1.0 / z
    iz2 = iz * iz
    zr = torch.zeros_like(z)
    return torch.stack(
        [
            torch.stack([iz, zr, -x * iz2], dim=-1),
            torch.stack([zr, iz, -y * iz2], dim=-1),
        ],
        dim=-2,
    )


def bearing_from_normalized(p_norm):
    """Normalized point (..., 2) -> unit bearing (..., 3)."""
    v = torch.cat([p_norm, torch.ones_like(p_norm[..., :1])], dim=-1)
    return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)


def bearing_from_pixel(p_pix, K):
    """Pixel (..., 2) -> unit bearing (..., 3) (reference frame.cpp:66-70)."""
    return bearing_from_normalized(remove_k(p_pix, K))


def distort_radtan(p_norm, dist):
    """Apply radial-tangential (k1 k2 p1 p2) distortion to normalized points."""
    k1, k2, p1, p2 = dist[0], dist[1], dist[2], dist[3]
    x, y = p_norm[..., 0], p_norm[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + k2 * r2)
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return torch.stack([xd, yd], dim=-1)


def distort_equidistant(p_norm, dist):
    """Apply equidistant (k1..k4) distortion to normalized points."""
    k1, k2, k3, k4 = dist[0], dist[1], dist[2], dist[3]
    x, y = p_norm[..., 0], p_norm[..., 1]
    r = torch.sqrt(torch.clamp(x * x + y * y, min=1e-18))
    theta = torch.arctan(r)
    t2 = theta * theta
    theta_d = theta * (1 + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4))))
    scale = theta_d / r
    return p_norm * scale[..., None]


def undistort(p_norm_d, dist, model: str = "radtan", iters: int = 8):
    """Invert the distortion model by a fixed number of fixed-point
    iterations (the reference undistorts via precomputed remap tables,
    image_undistorter.h:16-84; here each point is solved for)."""
    distort = distort_radtan if model == "radtan" else distort_equidistant
    p = p_norm_d
    for _ in range(iters):
        p = p + (p_norm_d - distort(p, dist))
    return p


def undistort_points_pixel(p_pix, K, dist, model: str = "radtan"):
    """Distorted pixel coords -> undistorted pixel coords (same K)."""
    return apply_k(undistort(remove_k(p_pix, K), dist, model), K)
