"""Factor residuals for the sliding-window VI-BA.

Port of the JAX package's estimation/factors.py:
- reprojection: inverse depth along the anchor bearing, residual in the
  tangent basis of the observed bearing, whitened by the K-scaled pixel
  noise;
- preintegration: 15-dim residual with the IMU extrinsic composition and a
  first-order bias correction;
- rotation prior: rotation-only reprojection;
- marginalization prior: r = S @ dx + infovec.

Each residual is a pure function of one factor's tensors; estimation/ba.py
batches it with `torch.func.vmap` and takes its Jacobian with `jacfwd`
through the tangent retraction at delta = 0. The functions hold no `.item()`
and no branch on values, so they stay vmap-safe.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from rd_vio_tpu_torch.estimation.state import ES_SIZE, FrameStates, local_delta
from rd_vio_tpu_torch.ops.lie import (
    expmap,
    logmap,
    quat_conj,
    quat_mul,
    quat_rotate,
    s2_tangential_basis,
)
from rd_vio_tpu_torch.ops.preintegration import PreintDelta, gravity_like, zero_delta

# ---------------------------------------------------------------------------
# factor data (fixed-capacity tensors, masked)
# ---------------------------------------------------------------------------


class ReprojFactors(NamedTuple):
    """Reprojection observations, [O] leading axis."""

    tgt: torch.Tensor  # (O,) target frame slot
    ref: torch.Tensor  # (O,) anchor frame slot
    lm: torch.Tensor  # (O,) landmark slot in [0, L)
    z_ref: torch.Tensor  # (O, 3) anchor bearing (unit, camera frame)
    z_tgt: torch.Tensor  # (O, 3) observed bearing (unit, camera frame)
    valid: torch.Tensor  # (O,) bool


class ImuFactors(NamedTuple):
    """Preintegration factors between frame pairs, [F] leading axis."""

    i: torch.Tensor  # (F,)
    j: torch.Tensor  # (F,)
    delta: PreintDelta  # leaves have leading (F, ...)
    sqrt_inv_cov: torch.Tensor  # (F, 15, 15)
    bg0: torch.Tensor  # (F, 3) bias linearization point of the delta
    ba0: torch.Tensor  # (F, 3)
    valid: torch.Tensor  # (F,) bool


class ReprojPriorFactors(NamedTuple):
    """Reprojection PRIOR observations: anchor pose and inverse depth are
    constants of the factor. Only the target frame occupies a state slot."""

    tgt: torch.Tensor  # (P,)
    q_ref: torch.Tensor  # (P, 4) fixed anchor pose
    p_ref: torch.Tensor  # (P, 3)
    inv_depth: torch.Tensor  # (P,) fixed
    z_ref: torch.Tensor  # (P, 3)
    z_tgt: torch.Tensor  # (P, 3)
    valid: torch.Tensor  # (P,) bool


class ImuPriorFactors(NamedTuple):
    """Preintegration PRIOR: the frame-i state is constant data."""

    j: torch.Tensor  # (F,)
    q_i: torch.Tensor  # (F, 4)
    p_i: torch.Tensor  # (F, 3)
    v_i: torch.Tensor  # (F, 3)
    bg_i: torch.Tensor  # (F, 3)
    ba_i: torch.Tensor  # (F, 3)
    delta: PreintDelta  # leaves (F, ...)
    sqrt_inv_cov: torch.Tensor  # (F, 15, 15)
    valid: torch.Tensor  # (F,) bool


def _unit_rows(n, k, size, dtype, device):
    """(n, size): every row the k-th unit vector."""
    out = torch.zeros((n, size), dtype=dtype, device=device)
    out[:, k] = 1.0
    return out


def empty_reproj_prior(P: int = 1, dtype=torch.float64, device="cuda") -> ReprojPriorFactors:
    unit_z = _unit_rows(P, 2, 3, dtype, device)
    return ReprojPriorFactors(
        tgt=torch.zeros(P, dtype=torch.int32, device=device),
        q_ref=_unit_rows(P, 0, 4, dtype, device),
        p_ref=torch.zeros((P, 3), dtype=dtype, device=device),
        inv_depth=torch.ones(P, dtype=dtype, device=device),
        z_ref=unit_z, z_tgt=unit_z.clone(),
        valid=torch.zeros(P, dtype=torch.bool, device=device),
    )


def empty_imu_prior(Fp: int = 1, dtype=torch.float64, device="cuda") -> ImuPriorFactors:
    delta = PreintDelta(*(a[None].expand((Fp,) + a.shape).clone()
                          for a in zero_delta(dtype, device)))
    z3 = lambda: torch.zeros((Fp, 3), dtype=dtype, device=device)  # noqa: E731
    return ImuPriorFactors(
        j=torch.zeros(Fp, dtype=torch.int32, device=device),
        q_i=_unit_rows(Fp, 0, 4, dtype, device),
        p_i=z3(), v_i=z3(), bg_i=z3(), ba_i=z3(),
        delta=delta,
        sqrt_inv_cov=torch.eye(15, dtype=dtype, device=device).expand(Fp, 15, 15).clone(),
        valid=torch.zeros(Fp, dtype=torch.bool, device=device),
    )


class RotFactors(NamedTuple):
    """Rotation-only reprojection priors, [Or] leading axis; the anchor frame
    pose is held constant."""

    tgt: torch.Tensor  # (Or,)
    q_ref: torch.Tensor  # (Or, 4) fixed anchor rotation
    z_ref: torch.Tensor  # (Or, 3)
    z_tgt: torch.Tensor  # (Or, 3)
    valid: torch.Tensor  # (Or,) bool


class PriorFactor(NamedTuple):
    """Marginalization prior over the whole window (fixed D = W*15)."""

    q_lin: torch.Tensor  # (W, 4)
    p_lin: torch.Tensor  # (W, 3)
    v_lin: torch.Tensor  # (W, 3)
    bg_lin: torch.Tensor  # (W, 3)
    ba_lin: torch.Tensor  # (W, 3)
    sqrt_inv_cov: torch.Tensor  # (D, D)
    infovec: torch.Tensor  # (D,)


class Extrinsics(NamedTuple):
    q_bc: torch.Tensor  # (4,) camera-to-body rotation
    p_bc: torch.Tensor  # (3,)
    q_bi: torch.Tensor  # (4,) imu-to-body rotation
    p_bi: torch.Tensor  # (3,)


def initial_prior(W: int, states: FrameStates, gauge: float = 1.0e15,
                  dtype=torch.float64) -> PriorFactor:
    """Fresh prior: an absolute (q, p) gauge of 1e15 on frame 0, linearized
    at `states` and made on their device."""
    D = W * ES_SIZE
    dev = states.q.device
    diag = torch.zeros(D, dtype=dtype, device=dev)
    diag[0:6] = gauge
    return PriorFactor(
        q_lin=states.q, p_lin=states.p, v_lin=states.v,
        bg_lin=states.bg, ba_lin=states.ba,
        sqrt_inv_cov=torch.diag(diag), infovec=torch.zeros(D, dtype=dtype, device=dev),
    )


# ---------------------------------------------------------------------------
# residuals (single factor; vmapped by the assembler)
# ---------------------------------------------------------------------------


def _tangent_frame(z):
    """(3, 3) [tangent basis of z | z]."""
    return torch.cat([s2_tangential_basis(z), z[:, None]], dim=-1)


def reprojection_residual(
    q_tgt, p_tgt, q_ref, p_ref, inv_depth, z_ref, z_tgt, ext: Extrinsics, sqrt_inv_cov2
):
    """Whitened 2-residual."""
    y_ref = z_ref / inv_depth
    y_ref_center = quat_rotate(ext.q_bc, y_ref) + ext.p_bc
    x = quat_rotate(q_ref, y_ref_center) + p_ref
    y_tgt_center = quat_rotate(quat_conj(q_tgt), x - p_tgt)
    y_tgt = quat_rotate(quat_conj(ext.q_bc), y_tgt_center - ext.p_bc)
    u = _tangent_frame(z_tgt).mT @ y_tgt
    r = u[:2] / u[2]
    return sqrt_inv_cov2 @ r


def rotation_prior_residual(q_tgt, q_ref, z_ref, z_tgt, ext: Extrinsics, sqrt_inv_cov2):
    """Rotation-only reprojection."""
    z_ref_center = quat_rotate(ext.q_bc, z_ref) + ext.p_bc
    z_tgt_center = quat_rotate(quat_conj(q_tgt), quat_rotate(q_ref, z_ref_center))
    z_t = quat_rotate(quat_conj(ext.q_bc), z_tgt_center - ext.p_bc)
    u = _tangent_frame(z_tgt).mT @ z_t
    r = u[:2] / u[2]
    return sqrt_inv_cov2 @ r


def preintegration_residual(
    q_i, p_i, v_i, bg_i, ba_i, q_j, p_j, v_j, bg_j, ba_j,
    delta: PreintDelta, sqrt_inv_cov15, bg0, ba0, ext: Extrinsics,
):
    """Whitened 15-residual.

    Frame poses are body ("center") poses; the IMU pose composes the
    imu-to-body extrinsic. (bg0, ba0) is the bias linearization point of the
    stored delta; first-order correction via the stored bias Jacobians.
    """
    g = gravity_like(p_i)
    qi = quat_mul(q_i, ext.q_bi)
    pi = p_i + quat_rotate(q_i, ext.p_bi)
    qj = quat_mul(q_j, ext.q_bi)
    pj = p_j + quat_rotate(q_j, ext.p_bi)

    dt = delta.t
    dbg = bg_i - bg0
    dba = ba_i - ba0

    dq_corr = quat_mul(delta.q, expmap(delta.dq_dbg @ dbg))
    r_q = logmap(quat_mul(quat_conj(dq_corr), quat_mul(quat_conj(qi), qj)))
    r_p = quat_rotate(quat_conj(qi), pj - pi - dt * v_i - 0.5 * dt * dt * g) - (
        delta.p + delta.dp_dbg @ dbg + delta.dp_dba @ dba
    )
    r_v = quat_rotate(quat_conj(qi), v_j - v_i - dt * g) - (
        delta.v + delta.dv_dbg @ dbg + delta.dv_dba @ dba
    )
    r_bg = bg_j - bg_i
    r_ba = ba_j - ba_i
    r = torch.cat([r_q, r_p, r_v, r_bg, r_ba])
    return sqrt_inv_cov15 @ r


def prior_residual(states: FrameStates, prior: PriorFactor):
    """r = S @ dx + infovec."""
    lin = FrameStates(
        q=prior.q_lin, p=prior.p_lin, v=prior.v_lin, bg=prior.bg_lin, ba=prior.ba_lin
    )
    dx = local_delta(states, lin).reshape(-1)
    return prior.sqrt_inv_cov @ dx + prior.infovec
