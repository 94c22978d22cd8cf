"""Perspective-n-Point solvers (DLT-P6P + Gauss-Newton polish), batched.

Behavioral reference: pnp.h (solve_pnp_6pt at pnp.h:24,63 delegates to
OpenCV EPnP; wrappers find_pnp_matrix* at pnp.h:96-203).

Port of the JAX package's ops/pnp.py: OpenCV's EPnP is replaced by a DLT P6P
(12-dim homogeneous least squares via eigh of the 12x12 normal matrix,
nearest rotation by SVD) and a fixed-iteration Gauss-Newton refinement on
SO(3)xR^3, batched over hypothesis banks. On a CUDA tensor
`torch.linalg.eigh` and `torch.linalg.svd` each synchronise the host (they
check their error codes): `solve_pnp_dlt` waits for the device twice.
"""

from __future__ import annotations

import torch

from rd_vio_tpu_torch.ops.lie import (
    expmap, hat, matrix_to_quat, quat_mul, quat_rotate, quat_to_matrix,
)


def solve_pnp_dlt(x_world, p_norm):
    """DLT PnP from N>=6 points. x_world: (..., N, 3), p_norm: (..., N, 2).

    Returns (R_cw, t_cw) with x_cam = R_cw x_world + t_cw. The eigenvector's
    sign is free; R and t do not depend on it."""
    X, Y, Z = x_world[..., 0], x_world[..., 1], x_world[..., 2]
    u, v = p_norm[..., 0], p_norm[..., 1]
    zero = torch.zeros_like(X)
    one = torch.ones_like(X)
    r1 = torch.stack(
        [X, Y, Z, one, zero, zero, zero, zero, -u * X, -u * Y, -u * Z, -u], dim=-1)
    r2 = torch.stack(
        [zero, zero, zero, zero, X, Y, Z, one, -v * X, -v * Y, -v * Z, -v], dim=-1)
    A = torch.cat([r1, r2], dim=-2)  # (..., 2N, 12)
    M = A.transpose(-1, -2) @ A
    _, vecs = torch.linalg.eigh(M)
    p = vecs[..., :, 0]
    P = p.reshape(p.shape[:-1] + (3, 4))
    Rraw = P[..., :, :3]
    traw = P[..., :, 3]
    # scale and sign: mean projected depth must be positive
    U, S, Vh = torch.linalg.svd(Rraw)
    scale = S.mean(dim=-1)
    R = U @ Vh
    detR = _det3(R)
    R = R * detR[..., None, None]
    t = traw * (detR / torch.clamp(scale, min=1e-12))[..., None]
    depths = torch.einsum("...ij,...nj->...ni", R, x_world)[..., 2] + t[..., None, 2]
    flip = depths.mean(dim=-1) < 0
    R = torch.where(flip[..., None, None], -R, R)
    # flipping all of P changes det(R); re-orthogonalize the sign via det
    detR = _det3(R)
    R = R * detR[..., None, None]
    t = torch.where(flip[..., None], -t, t) * detR[..., None]
    return R, t


def _det3(M):
    """Determinant of (..., 3, 3) by cofactors (no LU, no host sync)."""
    return (M[..., 0, 0] * (M[..., 1, 1] * M[..., 2, 2] - M[..., 1, 2] * M[..., 2, 1])
            - M[..., 0, 1] * (M[..., 1, 0] * M[..., 2, 2] - M[..., 1, 2] * M[..., 2, 0])
            + M[..., 0, 2] * (M[..., 1, 0] * M[..., 2, 1] - M[..., 1, 1] * M[..., 2, 0]))


def refine_pnp(R_cw, t_cw, x_world, p_norm, weights=None, iters: int = 5):
    """Fixed-iteration Gauss-Newton on SO(3)xR^3 minimizing reprojection
    error. Batched over leading dims of R_cw/t_cw (points may broadcast)."""
    q = matrix_to_quat(R_cw)
    t = t_cw
    eye3 = torch.eye(3, dtype=x_world.dtype, device=x_world.device)
    for _ in range(iters):
        x_cam = quat_rotate(q[..., None, :], x_world) + t[..., None, :]
        z = torch.clamp(x_cam[..., 2:3], min=1e-6)
        pred = x_cam[..., :2] / z
        r = pred - p_norm  # (..., N, 2)
        iz = 1.0 / z[..., 0]
        zz = torch.zeros_like(iz)
        Jp = torch.stack(
            [torch.stack([iz, zz, -pred[..., 0] * iz], dim=-1),
             torch.stack([zz, iz, -pred[..., 1] * iz], dim=-1)],
            dim=-2,
        )  # (..., N, 2, 3)
        # x_cam = exp(dtheta) R x + t + dt: d/d dtheta = -hat(R x)
        JR = -hat(x_cam - t[..., None, :])  # (..., N, 3, 3)
        Jx = torch.cat([JR, eye3.expand(JR.shape)], dim=-1)  # (..., N, 3, 6)
        J = Jp @ Jx  # (..., N, 2, 6)
        if weights is not None:
            wgt = weights[..., None, None]
            Jw, rw = J * wgt, r[..., None] * wgt
        else:
            Jw, rw = J, r[..., None]
        Jf = Jw.reshape(Jw.shape[:-3] + (-1, 6))
        rf = rw.reshape(rw.shape[:-3] + (-1, 1))
        H = Jf.transpose(-1, -2) @ Jf + 1e-9 * torch.eye(6, dtype=Jf.dtype,
                                                          device=Jf.device)
        g = Jf.transpose(-1, -2) @ rf
        delta = -_cho_solve(H, g)[..., 0]
        q = quat_mul(expmap(delta[..., :3]), q)
        t = t + delta[..., 3:]
    return quat_to_matrix(q), t


def _cho_solve(H, g):
    """H^-1 g by Cholesky; NaN where H is not positive definite (as JAX's
    cholesky), with no host sync (`cholesky_ex` does not check)."""
    L, info = torch.linalg.cholesky_ex(H)
    L = torch.where((info != 0)[..., None, None], float("nan"), L)
    y = torch.linalg.solve_triangular(L, g, upper=False)
    return torch.linalg.solve_triangular(L.transpose(-1, -2), y, upper=True)


def pnp_reprojection_error(R_cw, t_cw, x_world, p_norm):
    """Squared normalized-plane reprojection error per point; points behind
    the camera get an infinite error so they can never count as inliers."""
    x_cam = torch.einsum("...ij,...nj->...ni", R_cw, x_world) + t_cw[..., None, :]
    z = x_cam[..., 2]
    zs = z[..., None]
    pred = x_cam[..., :2] / torch.where(zs.abs() < 1e-12, torch.full_like(zs, 1e-12), zs)
    err = ((pred - p_norm) ** 2).sum(dim=-1)
    return torch.where(z > 1e-6, err, float("inf"))
