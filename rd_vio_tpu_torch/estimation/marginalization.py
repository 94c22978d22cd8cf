"""Sliding-window marginalization: Schur-out the oldest frame into a
square-root prior.

Port of the JAX package's estimation/marginalization.py: accumulate (a) the
current prior, (b) the preintegration factor(s) touching the victim, (c) the
reprojection factors of tracks anchored at the victim (landmark inverse
depth Schur-eliminated analytically per track, scalar 1/info), then take the
Schur complement of the victim's 15x15 block and refactorize it by an
eigendecomposition with eigenvalue clipping > 1e-8 into (sqrt_inv_cov,
infovec). The victim is always slot 0, so the frame remap is a static
15-row shift. No robust loss is applied here (raw J^T J).

Both `torch.linalg.eigh` calls make the host wait for the device on CUDA
(the solver checks its error codes); they stay, counted in PERF.md.
"""

from __future__ import annotations

import torch

from rd_vio_tpu_torch.estimation import ba
from rd_vio_tpu_torch.estimation import factors as F
from rd_vio_tpu_torch.estimation.state import ES_SIZE, FrameStates


def _eigh_pinv(M, clip=1e-12):
    w, V = torch.linalg.eigh(0.5 * (M + M.mT))
    w_inv = torch.where(w > clip * torch.clamp(torch.max(w), min=1.0), 1.0 / w, 0.0)
    return (V * w_inv[None, :]) @ V.mT


def marginalize_frame0(states: FrameStates, inv_depth, pb: ba.BAProblem) -> F.PriorFactor:
    """Marginalize window slot 0. `pb` must contain: the current prior, the
    preintegration factor(s) adjacent to slot 0, and the reprojection
    observations of tracks anchored at slot 0 (valid-masked).

    Returns the new PriorFactor, already shifted so the prior's slot k refers
    to the old slot k+1 (the caller shifts its own frame arrays identically).
    """
    W = states.q.shape[0]
    D = W * ES_SIZE
    dtype = states.q.dtype
    L = inv_depth.shape[0]

    # --- accumulate information from the three factor groups ---
    r_p, J_p = ba.linearize_prior(states, pb)
    r_m, Jc_m = ba.linearize_imu(states, pb)
    wm = pb.imu.valid.to(dtype)[:, None]
    rm = (r_m * wm).reshape(-1)
    Jm = (Jc_m * wm[..., None]).reshape(-1, D)
    r_v, Jc_v, Jl_v = ba.linearize_reprojection(states, inv_depth, pb)
    wv = pb.reproj.valid.to(dtype)[:, None]
    rv = (r_v * wv).reshape(-1)
    Jv = (Jc_v * wv[..., None]).reshape(-1, D)
    Jlv = (Jl_v * wv).reshape(-1)
    lm_rows = pb.reproj.lm.long()[:, None].expand(-1, 2).reshape(-1)

    J_all = torch.cat([J_p, Jm, Jv], dim=0)
    r_all = torch.cat([r_p, rm, rv], dim=0)
    info = J_all.mT @ J_all
    vec = J_all.mT @ r_all

    # --- analytic per-track landmark elimination ---
    Hll = ba.segment_sum(Jlv * Jlv, lm_rows, L)
    bl = ba.segment_sum(Jlv * rv, lm_rows, L)
    Hcl = ba.segment_sum(Jlv[:, None] * Jv, lm_rows, L)
    inv_Hll = torch.where(Hll > 1e-12, 1.0 / Hll, 0.0)
    info = info - Hcl.mT @ (Hcl * inv_Hll[:, None])
    vec = vec - Hcl.mT @ (bl * inv_Hll)

    # --- Schur complement of the victim block (slot 0) ---
    C = info[:ES_SIZE, :ES_SIZE]
    B = info[ES_SIZE:, :ES_SIZE]  # (D-15, 15)
    P = _eigh_pinv(C)
    info_rest = info[ES_SIZE:, ES_SIZE:] - B @ P @ B.mT
    vec_rest = vec[ES_SIZE:] - B @ P @ vec[:ES_SIZE]

    # --- shift up by one slot into the fixed-capacity layout ---
    info_new = torch.nn.functional.pad(info_rest, (0, ES_SIZE, 0, ES_SIZE))
    vec_new = torch.nn.functional.pad(vec_rest, (0, ES_SIZE))

    # --- sqrt refactorization with eigenvalue clipping ---
    w, V = torch.linalg.eigh(0.5 * (info_new + info_new.mT))
    keep = w > 1.0e-8
    lam = torch.where(keep, w, 0.0)
    lam_inv = torch.where(keep, 1.0 / torch.clamp(w, min=1e-300), 0.0)
    S_new = torch.sqrt(lam)[:, None] * V.mT
    iv_new = torch.sqrt(lam_inv)[:, None] * V.mT @ vec_new

    shift = lambda a: torch.roll(a, -1, dims=0)  # noqa: E731
    return F.PriorFactor(
        q_lin=shift(states.q), p_lin=shift(states.p), v_lin=shift(states.v),
        bg_lin=shift(states.bg), ba_lin=shift(states.ba),
        sqrt_inv_cov=S_new, infovec=iv_new,
    )
