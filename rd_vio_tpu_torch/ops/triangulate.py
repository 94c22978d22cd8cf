"""DLT triangulation, 2-view and masked N-view, batch-friendly.

Port of the JAX package's ops/triangulate.py. The homogeneous least-squares
problem min |A h|, |h| = 1 is solved by the symmetric eigendecomposition of
the 4x4 normal matrix A^T A; rows are weighted by a validity mask so
fixed-capacity observation tensors triangulate without dynamic shapes.

`torch.linalg.eigh` makes the host wait for the device on CUDA (it checks
its error codes); the JAX package's eigh does not wait.
"""

from __future__ import annotations

import torch

from rd_vio_tpu_torch.ops.lie import quat_to_matrix, s2_tangential_basis


def _smallest_eigvec(M):
    """Eigenvector of the smallest eigenvalue of symmetric M (..., n, n);
    the input is symmetrized, as jnp.linalg.eigh does by default. Its sign
    is arbitrary."""
    _, v = torch.linalg.eigh(0.5 * (M + M.mT))  # ascending eigenvalues
    return v[..., :, 0]


def triangulate_homogeneous(bearings, q_cw, p_cw, mask=None):
    """Triangulate one world point from N camera views.

    Args:
      bearings: (N, 3) unit bearings in each camera frame.
      q_cw: (N, 4) world-to-camera rotations (x_c = R(q_cw) x_w + p_cw).
      p_cw: (N, 3) world-to-camera translations.
      mask: optional (N,) row validity.

    Returns:
      (point_w (3,), ok) where ok requires positive depth in every valid view.
    """
    R = quat_to_matrix(q_cw)  # (N, 3, 3)
    P = torch.cat([R, p_cw[..., None]], dim=-1)  # (N, 3, 4)
    # Two tangent-plane constraint rows per view: s^T (R x + p) = 0.
    S = s2_tangential_basis(bearings)  # (N, 3, 2)
    rows = torch.einsum("nij,nik->njk", S, P).reshape(-1, 4)  # (2N, 4)
    if mask is not None:
        rows = rows * mask.to(rows.dtype)[:, None].expand(-1, 2).reshape(-1)[:, None]
    M = rows.mT @ rows
    h = _smallest_eigvec(M)
    w = h[3]
    # guard near-zero homogeneous scale
    point = h[:3] / torch.where(torch.abs(w) < 1e-12, torch.sign(w) * 1e-12 + 1e-15, w)
    depths = torch.einsum("nij,j->ni", R, point)[..., 2] + p_cw[..., 2]
    valid = (mask.to(torch.bool) if mask is not None
             else torch.ones(bearings.shape[0], dtype=torch.bool, device=bearings.device))
    n_valid = torch.sum(valid)
    ok = (torch.all(torch.where(valid, depths > 0, True)) & (n_valid >= 2)
          & torch.isfinite(point).all())
    return point, ok


def triangulate_two_view(b1, b2, q_cw1, p_cw1, q_cw2, p_cw2):
    """Two-view DLT, batched over the leading dims of b1/b2 with shared poses.

    b1, b2: (..., 3) bearings; poses world-to-camera.
    Returns (point_w (..., 3), ok (...,)).
    """
    R1, R2 = quat_to_matrix(q_cw1), quat_to_matrix(q_cw2)
    P1 = torch.cat([R1, p_cw1[..., None]], dim=-1)  # (3, 4)
    P2 = torch.cat([R2, p_cw2[..., None]], dim=-1)
    S1 = s2_tangential_basis(b1)  # (..., 3, 2)
    S2 = s2_tangential_basis(b2)
    r1 = torch.einsum("...ij,ik->...jk", S1, P1)  # (..., 2, 4)
    r2 = torch.einsum("...ij,ik->...jk", S2, P2)
    A = torch.cat([r1, r2], dim=-2)  # (..., 4, 4)
    M = A.mT @ A
    h = _smallest_eigvec(M)
    w = h[..., 3:4]
    point = h[..., :3] / torch.where(torch.abs(w) < 1e-12, 1e-12, w)
    z1 = torch.einsum("ij,...j->...i", R1, point)[..., 2] + p_cw1[2]
    z2 = torch.einsum("ij,...j->...i", R2, point)[..., 2] + p_cw2[2]
    ok = (z1 > 0) & (z2 > 0) & torch.isfinite(point).all(dim=-1)
    return point, ok
