"""Essential-matrix estimation for hypothesis banks (batched).

Behavioral reference: essential.h:14-19 (geometric error). As in the JAX
package (ops/epipolar.py), the minimal solver inside the batched RANSAC is
the normalized linear 8-point solver, and the projection onto the essential
manifold uses a symmetric eigendecomposition of E^T E instead of an SVD, so
whole hypothesis banks batch over the leading axis (`torch.linalg.eigh`).
"""

from __future__ import annotations

import torch


def _homog(p):
    return torch.cat([p, torch.ones_like(p[..., :1])], dim=-1)


def solve_essential_8pt(p1, p2):
    """Linear 8-point essential solver on normalized image points.

    p1, p2: (..., N>=8, 2) normalized points with p2^T E p1 = 0.
    Returns E: (..., 3, 3) projected onto the essential manifold (s, s, 0);
    E is defined up to sign."""
    x1, y1 = p1[..., 0], p1[..., 1]
    x2, y2 = p2[..., 0], p2[..., 1]
    one = torch.ones_like(x1)
    A = torch.stack(
        [x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, one], dim=-1
    )  # (..., N, 9)
    M = A.transpose(-1, -2) @ A  # (..., 9, 9)
    _, v = torch.linalg.eigh(M)
    e = v[..., :, 0]
    E = e.reshape(e.shape[:-1] + (3, 3))
    # singular values (s, s, 0) via eigh of E^T E: sigma_i = sqrt(lambda_i),
    # u_i = E v_i / sigma_i (ascending eigenvalues)
    lam, V = torch.linalg.eigh(E.transpose(-1, -2) @ E)
    v1 = V[..., :, 2]
    v2 = V[..., :, 1]
    s1 = torch.sqrt(torch.clamp(lam[..., 2], min=0.0))
    s2 = torch.sqrt(torch.clamp(lam[..., 1], min=0.0))
    eps = 1e-20
    u1 = torch.einsum("...ij,...j->...i", E, v1) / torch.clamp(s1, min=eps)[..., None]
    u2 = torch.einsum("...ij,...j->...i", E, v2) / torch.clamp(s2, min=eps)[..., None]
    s = 0.5 * (s1 + s2)
    return s[..., None, None] * (
        u1[..., :, None] * v1[..., None, :] + u2[..., :, None] * v2[..., None, :]
    )


def essential_geometric_error(E, p1, p2):
    """Point-to-epipolar-line squared distance of p2 against E p1
    (reference essential.h:14-19). Batched: E (..., 3, 3), p1/p2 (..., N, 2)."""
    Ep1 = torch.einsum("...ij,...nj->...ni", E, _homog(p1))
    r = (_homog(p2) * Ep1).sum(dim=-1)
    denom = Ep1[..., 0] ** 2 + Ep1[..., 1] ** 2
    return r * r / torch.clamp(denom, min=1e-18)


def essential_geometric_error_sym(E, p1, p2):
    """Symmetric epipolar error: the mean of the two directed line distances
    (the tracker's epipolar check, reference sliding_window_tracker.cpp:469-500
    computes both directions)."""
    e12 = essential_geometric_error(E, p1, p2)
    e21 = essential_geometric_error(E.transpose(-1, -2), p2, p1)
    return 0.5 * (e12 + e21)


def essential_from_pose(R_21, t_21):
    """E with p2^T E p1 = 0 for x_2 = R_21 x_1 + t_21: E = [t]x R."""
    tx, ty, tz = t_21[..., 0], t_21[..., 1], t_21[..., 2]
    z = torch.zeros_like(tx)
    T_hat = torch.stack(
        [torch.stack([z, -tz, ty], dim=-1),
         torch.stack([tz, z, -tx], dim=-1),
         torch.stack([-ty, tx, z], dim=-1)],
        dim=-2,
    )
    return T_hat @ R_21


def decompose_essential(E):
    """E -> two rotations + translation direction (reference essential.cpp:222-283).

    Returns (R1, R2, T) with the four candidate poses being
    (R1, T), (R1, -T), (R2, T), (R2, -T). Batched over leading dims. The
    SVD's signs are arbitrary: another library may return R1 and R2
    swapped and T negated, the same four candidates in another order."""
    U, _, Vt = torch.linalg.svd(E)
    # enforce proper rotations
    U = U * torch.linalg.det(U)[..., None, None]
    Vt = Vt * torch.linalg.det(Vt)[..., None, None]
    W = torch.tensor([[0.0, 1.0, 0.0], [-1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                     dtype=E.dtype, device=E.device)
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    T = U[..., :, 2]
    return R1, R2, T
