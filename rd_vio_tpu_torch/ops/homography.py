"""Homography estimation (normalized 4-point DLT) and analytic decomposition.

Behavioral reference: homography.cpp (DLT at :100-157, Malis-Vargas analytic
decomposition with pure-rotation detection at :6-96, ||H^T H - I|| < 1e-3).

Port of the JAX package's ops/homography.py: batched and branch-free, the
three diagonal-dominance cases of the decomposition are computed
unconditionally and selected with `torch.where`, so a whole hypothesis bank
decomposes in one call.
"""

from __future__ import annotations

import torch


def _homog(p):
    return torch.cat([p, torch.ones_like(p[..., :1])], dim=-1)


def _mat3(rows):
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def solve_homography_dlt(p1, p2, weights=None):
    """DLT homography from N>=4 correspondences, p2 ~ H p1.

    Hartley-normalized internally. p1, p2: (..., N, 2). Returns (..., 3, 3).
    """

    def normalize(p):
        mean = p.mean(dim=-2, keepdim=True)
        d = torch.linalg.vector_norm(p - mean, dim=-1, keepdim=True)
        scale = torch.sqrt(torch.tensor(2.0, dtype=p.dtype, device=p.device)) / torch.clamp(
            d.mean(dim=-2, keepdim=True), min=1e-12)
        pn = (p - mean) * scale
        s = scale[..., 0, 0]
        mx, my = mean[..., 0, 0], mean[..., 0, 1]
        zero, one = torch.zeros_like(s), torch.ones_like(s)
        T = _mat3([[s, zero, -s * mx], [zero, s, -s * my], [zero, zero, one]])
        return pn, T

    p1n, T1 = normalize(p1)
    p2n, T2 = normalize(p2)
    x1, y1 = p1n[..., 0], p1n[..., 1]
    x2, y2 = p2n[..., 0], p2n[..., 1]
    zero, one = torch.zeros_like(x1), torch.ones_like(x1)
    # rows for x2 * (h3 . p1) - (h1 . p1) = 0 and y2 * (h3 . p1) - (h2 . p1) = 0
    r1 = torch.stack([-x1, -y1, -one, zero, zero, zero, x2 * x1, x2 * y1, x2], dim=-1)
    r2 = torch.stack([zero, zero, zero, -x1, -y1, -one, y2 * x1, y2 * y1, y2], dim=-1)
    A = torch.cat([r1, r2], dim=-2)  # (..., 2N, 9)
    if weights is not None:
        A = A * torch.cat([weights, weights], dim=-1)[..., None]
    M = A.mT @ A
    _, v = torch.linalg.eigh(0.5 * (M + M.mT))
    h = v[..., :, 0]
    Hn = h.reshape(h.shape[:-1] + (3, 3))
    # denormalize: H = T2^-1 Hn T1 with T2's closed-form inverse
    s = T2[..., 0, 0]
    mx = -T2[..., 0, 2] / s
    my = -T2[..., 1, 2] / s
    inv_s = 1.0 / s
    zero, one = torch.zeros_like(s), torch.ones_like(s)
    T2_inv = _mat3([[inv_s, zero, mx], [zero, inv_s, my], [zero, zero, one]])
    H = T2_inv @ Hn @ T1
    return H / H[..., 2:3, 2:3]


def homography_geometric_error(H, p1, p2):
    """Squared transfer error |p2 - pi(H p1)|^2 (reference homography.h:17-21)."""
    q = torch.einsum("...ij,...nj->...ni", H, _homog(p1))
    w = q[..., 2:3]
    qn = q[..., :2] / torch.where(torch.abs(w) < 1e-12, 1e-12, w)
    return ((p2 - qn) ** 2).sum(dim=-1)


def decompose_homography(H):
    """Malis-Vargas analytic decomposition (reference homography.cpp:6-96).

    Returns (R1, R2, T1, T2, n1, n2, is_pure_rotation). When pure rotation is
    detected (||Hn^T Hn - I||_max <= 1e-3 after scaling by the middle singular
    value) the two rotations equal the orthogonal polar factor of H and
    T/n are zero. Batched over leading dims.
    """
    eye = torch.eye(3, dtype=H.dtype, device=H.device)
    sv = torch.linalg.svdvals(H)
    Hn = H / sv[..., 1:2][..., None]
    S = Hn.mT @ Hn - eye
    pure_rot = torch.amax(torch.abs(S), dim=(-2, -1)) <= 1e-3

    # --- pure-rotation branch: nearest rotation by SVD polar factor ---
    U, _, Vt = torch.linalg.svd(H)
    Rrot = U @ Vt
    Rrot = torch.where(torch.linalg.det(Rrot)[..., None, None] < 0, -Rrot, Rrot)

    # --- general branch (computed unconditionally; guarded sqrt args) ---
    s00, s01, s02 = S[..., 0, 0], S[..., 0, 1], S[..., 0, 2]
    s11, s12, s22 = S[..., 1, 1], S[..., 1, 2], S[..., 2, 2]
    # opposite minors M_S(i,i) of S and their square roots
    Ms00 = s12 * s12 - s11 * s22
    Ms11 = s02 * s02 - s00 * s22
    Ms22 = s01 * s01 - s00 * s11
    m00 = torch.sqrt(torch.clamp(Ms00, min=0.0))
    m11 = torch.sqrt(torch.clamp(Ms11, min=0.0))
    m22 = torch.sqrt(torch.clamp(Ms22, min=0.0))
    tr = s00 + s11 + s22
    nu = 2.0 * torch.sqrt(torch.clamp(1.0 + tr - (Ms00 + Ms11 + Ms22), min=0.0))
    te2 = 2.0 + tr - nu

    def safe_div(a, b):
        return a / torch.where(torch.abs(b) < 1e-12, torch.where(b < 0, -1e-12, 1e-12), b)

    def sgn(x):
        return torch.where(x < 0, -1.0, 1.0).to(x.dtype)

    def norm(x):
        return torch.linalg.vector_norm(x, dim=-1, keepdim=True)

    # case A: s00 dominant
    eA = sgn(s01 * s02 - s00 * s12)
    n1A = torch.stack([s00, s01 + m22, s02 + eA * m11], dim=-1)
    n2A = torch.stack([s00, s01 - m22, s02 - eA * m11], dim=-1)
    t1A = safe_div(norm(n1A) * n2A, s00[..., None])
    t2A = safe_div(norm(n2A) * n1A, s00[..., None])
    # case B: s11 dominant
    eB = sgn(s11 * s02 - s01 * s12)
    n1B = torch.stack([s01 + m22, s11, s12 - eB * m00], dim=-1)
    n2B = torch.stack([s01 - m22, s11, s12 + eB * m00], dim=-1)
    t1B = safe_div(norm(n1B) * n2B, s11[..., None])
    t2B = safe_div(norm(n2B) * n1B, s11[..., None])
    # case C: s22 dominant
    eC = sgn(s12 * s02 - s01 * s22)
    n1C = torch.stack([s02 + eC * m11, s12 + m00, s22], dim=-1)
    n2C = torch.stack([s02 - eC * m11, s12 - m00, s22], dim=-1)
    t1C = safe_div(norm(n1C) * n2C, s22[..., None])
    t2C = safe_div(norm(n2C) * n1C, s22[..., None])

    caseA = ((s00 > s11) & (s00 > s22))[..., None]
    caseB = ((s11 > s00) & (s11 > s22))[..., None] & ~caseA
    n1 = torch.where(caseA, n1A, torch.where(caseB, n1B, n1C))
    n2 = torch.where(caseA, n2A, torch.where(caseB, n2B, n2C))
    ts1 = torch.where(caseA, t1A, torch.where(caseB, t1B, t1C))
    ts2 = torch.where(caseA, t2A, torch.where(caseB, t2B, t2C))

    n1 = n1 / torch.clamp(norm(n1), min=1e-12)
    n2 = n2 / torch.clamp(norm(n2), min=1e-12)
    ts1 = ts1 - te2[..., None] * n1
    ts2 = ts2 - te2[..., None] * n2
    inv_nu = safe_div(torch.ones_like(nu), nu)[..., None, None]
    R1 = Hn @ (eye - inv_nu * ts1[..., :, None] * n1[..., None, :])
    R2 = Hn @ (eye - inv_nu * ts2[..., :, None] * n2[..., None, :])
    T1 = torch.einsum("...ij,...j->...i", R1, 0.5 * ts1)
    T2 = torch.einsum("...ij,...j->...i", R2, 0.5 * ts2)

    pr = pure_rot[..., None, None]
    R1 = torch.where(pr, Rrot, R1)
    R2 = torch.where(pr, Rrot, R2)
    pv = pure_rot[..., None]
    zero3 = torch.zeros_like(T1)
    T1 = torch.where(pv, zero3, T1)
    T2 = torch.where(pv, zero3, T2)
    n1 = torch.where(pv, zero3, n1)
    n2 = torch.where(pv, zero3, n2)
    return R1, R2, T1, T2, n1, n2, pure_rot
