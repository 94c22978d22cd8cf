"""SO(3)/quaternion Lie-group operations on tensors with any leading batch dims.

Port of the JAX package's ops/lie.py. Small-angle branches use `torch.where`
with Taylor-series fallbacks instead of data-dependent control flow, so every
function works under `torch.func.vmap` / `jacfwd` and never waits for the
device.

Conventions:
- Quaternions are Hamilton, stored wxyz as shape (..., 4); always unit-norm.
- ``quat_rotate(q, v)`` applies the rotation R(q) @ v.
- Poses (q, p) map body to world: x_w = R(q) x_b + p.
"""

from __future__ import annotations

import torch

_EPS = 1e-12


def hat(w):
    """Skew-symmetric matrix of w: hat(w) @ v == cross(w, v). (..., 3) -> (..., 3, 3)."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([z, -wz, wy], dim=-1),
            torch.stack([wz, z, -wx], dim=-1),
            torch.stack([-wy, wx, z], dim=-1),
        ],
        dim=-2,
    )


def quat_mul(a, b):
    """Hamilton product a*b, wxyz. (..., 4), (..., 4) -> (..., 4)."""
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def quat_conj(q):
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def quat_normalize(q):
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def quat_rotate(q, v):
    """Rotate v by q: R(q) @ v. (..., 4), (..., 3) -> (..., 3)."""
    w = q[..., :1]
    # broadcast as jnp.cross does: torch.linalg.cross wants equal ndims
    qv, v = torch.broadcast_tensors(q[..., 1:], v)
    t = 2.0 * torch.linalg.cross(qv, v)
    return v + w * t + torch.linalg.cross(qv, t)


def quat_to_matrix(q):
    """(..., 4) -> (..., 3, 3) rotation matrix."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r00 = 1 - 2 * (y * y + z * z)
    r01 = 2 * (x * y - w * z)
    r02 = 2 * (x * z + w * y)
    r10 = 2 * (x * y + w * z)
    r11 = 1 - 2 * (x * x + z * z)
    r12 = 2 * (y * z - w * x)
    r20 = 2 * (x * z - w * y)
    r21 = 2 * (y * z + w * x)
    r22 = 1 - 2 * (x * x + y * y)
    return torch.stack(
        [
            torch.stack([r00, r01, r02], dim=-1),
            torch.stack([r10, r11, r12], dim=-1),
            torch.stack([r20, r21, r22], dim=-1),
        ],
        dim=-2,
    )


def matrix_to_quat(R):
    """(..., 3, 3) -> (..., 4) wxyz. Branch-free Shepperd-style selection."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    # four candidate quaternions (unnormalized), one per dominant component
    qw = torch.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], dim=-1)
    qx = torch.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20], dim=-1)
    qy = torch.stack([m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21], dim=-1)
    qz = torch.stack([m10 - m01, m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22], dim=-1)
    # dominant diagonal decides which candidate is numerically safe
    c0 = tr
    c1 = m00 - m11 - m22
    c2 = m11 - m00 - m22
    c3 = m22 - m00 - m11
    cands = torch.stack([qw, qx, qy, qz], dim=-2)  # (..., 4cand, 4)
    scores = torch.stack([c0, c1, c2, c3], dim=-1)  # (..., 4)
    idx = torch.argmax(scores, dim=-1)  # first of equal scores, as jnp.argmax
    q = torch.gather(cands, -2, idx[..., None, None].expand(idx.shape + (1, 4)))[..., 0, :]
    q = quat_normalize(q)
    # canonical sign: w >= 0
    return torch.where(q[..., :1] < 0, -q, q)


def expmap(w):
    """Axis-angle rotation vector -> unit quaternion. (..., 3) -> (..., 4).

    Small angles use the 2nd-order Taylor series. The factor Jacobians are
    taken at a tangent of exactly 0, so that branch is the one they run; the
    other branch stays finite there (theta is floored at 1e-6), so forward-
    mode derivatives through `where` carry no NaN, as in JAX."""
    theta2 = torch.sum(w * w, dim=-1, keepdim=True)
    theta = torch.sqrt(torch.clamp(theta2, min=_EPS))
    half = 0.5 * theta
    small = theta2 < 1e-10
    sinc_half = torch.where(small, 0.5 - theta2 / 48.0, torch.sin(half) / theta)
    cw = torch.where(small, 1.0 - theta2 / 8.0, torch.cos(half))
    return quat_normalize(torch.cat([cw, sinc_half * w], dim=-1))


def logmap(q):
    """Unit quaternion -> rotation vector, |axis|*angle in (-pi, pi]. (..., 4) -> (..., 3)."""
    q = torch.where(q[..., :1] < 0, -q, q)  # shortest arc
    w = torch.clamp(q[..., :1], -1.0, 1.0)
    vn = torch.linalg.vector_norm(q[..., 1:], dim=-1, keepdim=True)
    angle = 2.0 * torch.atan2(vn, w)
    scale = torch.where(vn < 1e-10, 2.0 / torch.clamp(w, min=0.5),
                        angle / torch.clamp(vn, min=_EPS))
    return scale * q[..., 1:]


def right_jacobian(w):
    """Right Jacobian of SO(3) at rotation vector w.

    Jr(w) = I - (1-cos t)/t^2 hat(w) + (t - sin t)/t^3 hat(w)^2.
    (..., 3) -> (..., 3, 3), Taylor fallback for small angles.
    """
    theta2 = torch.sum(w * w, dim=-1)[..., None, None]
    theta = torch.sqrt(torch.clamp(theta2, min=_EPS))
    W = hat(w)
    W2 = W @ W
    small = theta2 < 1e-10
    a = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2)
    b = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (theta - torch.sin(theta)) / (theta2 * theta))
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return eye - a * W + b * W2


def left_jacobian(w):
    """Left Jacobian of SO(3): Jl(w) = Jr(-w)."""
    return right_jacobian(-w)


def s2_tangential_basis(x):
    """Orthonormal basis of the tangent plane at unit vector x.
    (..., 3) -> (..., 3, 2).

    Branch-free: pick the seed axis least aligned with x.
    """
    ax = torch.abs(x)
    # one-hot of the smallest |component| (the first of equal ones, as
    # jnp.argmin); a comparison, not an index, so it batches under vmap
    idx = torch.argmin(ax, dim=-1)
    seed = (idx[..., None] == torch.arange(3, device=x.device)).to(x.dtype)
    b0 = torch.linalg.cross(x, seed)
    b0 = b0 / torch.linalg.vector_norm(b0, dim=-1, keepdim=True)
    b1 = torch.linalg.cross(x, b0)
    b1 = b1 / torch.linalg.vector_norm(b1, dim=-1, keepdim=True)
    return torch.stack([b0, b1], dim=-1)


def slerp(q0, q1, t):
    """Spherical linear interpolation between unit quaternions (IMU timestamp
    interpolation)."""
    d = torch.sum(q0 * q1, dim=-1, keepdim=True)
    q1 = torch.where(d < 0, -q1, q1)
    d = torch.abs(d)
    # fall back to lerp when nearly parallel
    theta = torch.arccos(torch.clamp(d, -1.0, 1.0))
    sin_theta = torch.sin(theta)
    use_lerp = sin_theta < 1e-6
    w0 = torch.where(use_lerp, 1.0 - t,
                     torch.sin((1.0 - t) * theta) / torch.clamp(sin_theta, min=_EPS))
    w1 = torch.where(use_lerp, t, torch.sin(t * theta) / torch.clamp(sin_theta, min=_EPS))
    return quat_normalize(w0 * q0 + w1 * q1)
