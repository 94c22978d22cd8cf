"""Batched Levenberg-Marquardt sliding-window VI-BA solver.

Port of the JAX package's estimation/ba.py:

- Factor residuals and Jacobians are batched pure functions: `vmap` of
  `jacfwd` through the tangent retraction at delta = 0 (torch.func).
- Per-factor local Jacobians are scattered into dense rows over the full
  camera-state vector (D = W*15), so the normal equations are two matmuls:
  H = J^T W J, g = J^T W r.
- Landmarks (scalar inverse depth) are Schur-eliminated analytically per
  track through segment sums (`index_add_`).
- The damped reduced system is solved by Cholesky. Robust loss = Cauchy(1.0)
  IRLS reweighting on vision rows.
- Fixed states (fixed pose / motion, constant anchors in prior-flavour
  factors, non-optimized landmarks) are handled by masking Jacobian columns.

Everything is fixed-shape; invalid factor slots carry zero weight. No
function here reads a value back to the host except `solve_ba` and
`solve_ba_rows`, once per LM iteration, to stop.

`solve_ba_rows` is the batched solve of the lockstep runtime: N independent
problems with a leading row axis, each LM iteration's linearization, solve,
retraction and cost vmapped over the rows, as the JAX package vmaps its
`lax.while_loop`. On CUDA that iteration is captured once per set of
shapes in a CUDA graph and replayed (`ROW_GRAPHS`): eagerly, each of its
~4,900 small kernels costs its Python dispatch (PERF.md section 5).
"""

from __future__ import annotations

import collections
import contextlib
import threading
from typing import NamedTuple

import torch
from torch.func import jacfwd, vmap
from torch.utils._pytree import tree_flatten, tree_map

from rd_vio_tpu_torch.estimation import factors as F
from rd_vio_tpu_torch.estimation.state import ES_SIZE, FrameStates, retract
from rd_vio_tpu_torch.ops.lie import expmap, quat_mul
from rd_vio_tpu_torch.utils.metrics import GLOBAL_TIMER as _T


class BAProblem(NamedTuple):
    reproj: F.ReprojFactors
    reproj_prior: F.ReprojPriorFactors  # fixed-anchor vision priors
    imu: F.ImuFactors
    imu_prior: F.ImuPriorFactors  # fixed-i preintegration priors
    rot: F.RotFactors
    prior: F.PriorFactor
    prior_valid: torch.Tensor  # scalar bool — include the prior term?
    ext: F.Extrinsics
    sqrt_inv_cov2: torch.Tensor  # (2, 2) K-scaled pixel whitening
    opt_pose: torch.Tensor  # (W,) bool
    opt_motion: torch.Tensor  # (W,) bool
    opt_lm: torch.Tensor  # (L,) bool


class BAResult(NamedTuple):
    states: FrameStates
    inv_depth: torch.Tensor
    cost: torch.Tensor
    initial_cost: torch.Tensor
    iterations: torch.Tensor  # accepted LM steps


# ---------------------------------------------------------------------------
# linearization
# ---------------------------------------------------------------------------


def _take(states: FrameStates, idx) -> FrameStates:
    idx = idx.long()
    return FrameStates(*(a[idx] for a in states))


def _value_and_jacfwd(local, *args):
    """vmap(local)(*args) and vmap(jacfwd(local))(*args) (Jacobian with
    respect to the first argument) from one forward-mode pass."""
    both = lambda *a: (local(*a),) * 2  # noqa: E731
    J, r = vmap(jacfwd(both, has_aux=True))(*args)
    return r, J


def _scatter_frame_block(J_local, frame_idx, W):
    """Scatter per-factor local Jacobian blocks into dense (R, W*15) rows.

    J_local: (N, r, b) with b <= 15 (pose blocks are zero-padded);
    frame_idx: (N,). A one-hot product, as in the JAX package.
    """
    n, r, b = J_local.shape
    if b < ES_SIZE:
        J_local = torch.nn.functional.pad(J_local, (0, ES_SIZE - b))
    onehot = (frame_idx.long()[:, None]
              == torch.arange(W, device=J_local.device)).to(J_local.dtype)  # (N, W)
    out = onehot[:, None, :, None] * J_local[:, :, None, :]  # (N, r, W, 15)
    return out.reshape(n, r, W * ES_SIZE)


def linearize_reprojection(states: FrameStates, inv_depth, pb: BAProblem):
    """Returns (r (O,2), Jc (O,2,D), Jl (O,2))."""
    rf = pb.reproj
    W = states.q.shape[0]
    tgt, ref = rf.tgt.long(), rf.ref.long()
    # floor as in the JAX package (jnp.maximum(inv_depth, 1e-12)): a
    # non-positive inverse depth would divide by zero in the residual
    invd = torch.clamp(inv_depth[rf.lm.long()], min=1e-12)

    def local(d, q_tgt, p_tgt, q_ref, p_ref, idp, z_r, z_t):
        q_tgt2 = quat_mul(q_tgt, expmap(d[0:3]))
        p_tgt2 = p_tgt + d[3:6]
        q_ref2 = quat_mul(q_ref, expmap(d[6:9]))
        p_ref2 = p_ref + d[9:12]
        idp2 = idp + d[12]
        return F.reprojection_residual(
            q_tgt2, p_tgt2, q_ref2, p_ref2, idp2, z_r, z_t, pb.ext, pb.sqrt_inv_cov2
        )

    zeros = states.q.new_zeros((rf.tgt.shape[0], 13))
    r, J = _value_and_jacfwd(local, zeros, states.q[tgt], states.p[tgt], states.q[ref],
                             states.p[ref], invd, rf.z_ref, rf.z_tgt)
    # (O, 2, 13) -> tgt pose 0:6, ref pose 6:12, invd 12
    Jc = _scatter_frame_block(J[:, :, 0:6], rf.tgt, W) + _scatter_frame_block(
        J[:, :, 6:12], rf.ref, W
    )
    Jl = J[:, :, 12]
    return r, Jc, Jl


def linearize_reproj_prior(states: FrameStates, pb: BAProblem):
    """Fixed-anchor reprojection priors: 6-dim local Jacobian on the target
    pose only. Returns (r (P,2), Jc (P,2,D))."""
    rf = pb.reproj_prior
    W = states.q.shape[0]
    tgt = rf.tgt.long()
    invd = torch.clamp(rf.inv_depth, min=1e-12)

    def local(d, q_tgt, p_tgt, q_ref, p_ref, idp, z_r, z_t):
        q_tgt2 = quat_mul(q_tgt, expmap(d[0:3]))
        p_tgt2 = p_tgt + d[3:6]
        return F.reprojection_residual(
            q_tgt2, p_tgt2, q_ref, p_ref, idp, z_r, z_t, pb.ext, pb.sqrt_inv_cov2
        )

    zeros = states.q.new_zeros((rf.tgt.shape[0], 6))
    r, J = _value_and_jacfwd(local, zeros, states.q[tgt], states.p[tgt], rf.q_ref,
                             rf.p_ref, invd, rf.z_ref, rf.z_tgt)
    return r, _scatter_frame_block(J, rf.tgt, W)


def linearize_imu_prior(states: FrameStates, pb: BAProblem):
    """Fixed-i preintegration priors: 15-dim local Jacobian on frame j only.
    Bias linearization point = the fixed frame-i biases (dbg = 0)."""
    mf = pb.imu_prior
    W = states.q.shape[0]
    sj = _take(states, mf.j)

    def local(d, qi, pi, vi, bgi, bai, qj, pj, vj, bgj, baj, delta, sic):
        qj2 = quat_mul(qj, expmap(d[0:3]))
        return F.preintegration_residual(
            qi, pi, vi, bgi, bai,
            qj2, pj + d[3:6], vj + d[6:9], bgj + d[9:12], baj + d[12:15],
            delta, sic, bgi, bai, pb.ext,
        )

    zeros = states.q.new_zeros((mf.j.shape[0], 15))
    r, J = _value_and_jacfwd(
        local, zeros, mf.q_i, mf.p_i, mf.v_i, mf.bg_i, mf.ba_i,
        sj.q, sj.p, sj.v, sj.bg, sj.ba, mf.delta, mf.sqrt_inv_cov,
    )
    return r, _scatter_frame_block(J, mf.j, W)


def linearize_imu(states: FrameStates, pb: BAProblem):
    """Returns (r (F,15), Jc (F,15,D))."""
    mf = pb.imu
    W = states.q.shape[0]
    si, sj = _take(states, mf.i), _take(states, mf.j)

    def local(d, qi, pi, vi, bgi, bai, qj, pj, vj, bgj, baj, delta, sic, bg0, ba0):
        di, dj = d[:15], d[15:]
        qi2 = quat_mul(qi, expmap(di[0:3]))
        qj2 = quat_mul(qj, expmap(dj[0:3]))
        return F.preintegration_residual(
            qi2, pi + di[3:6], vi + di[6:9], bgi + di[9:12], bai + di[12:15],
            qj2, pj + dj[3:6], vj + dj[6:9], bgj + dj[9:12], baj + dj[12:15],
            delta, sic, bg0, ba0, pb.ext,
        )

    zeros = states.q.new_zeros((mf.i.shape[0], 30))
    r, J = _value_and_jacfwd(
        local, zeros, si.q, si.p, si.v, si.bg, si.ba, sj.q, sj.p, sj.v, sj.bg, sj.ba,
        mf.delta, mf.sqrt_inv_cov, mf.bg0, mf.ba0,
    )
    Jc = _scatter_frame_block(J[:, :, :15], mf.i, W) + _scatter_frame_block(
        J[:, :, 15:], mf.j, W
    )
    return r, Jc


def linearize_rot(states: FrameStates, pb: BAProblem):
    rf = pb.rot
    W = states.q.shape[0]
    q_t = states.q[rf.tgt.long()]

    def local(d, q_tgt, q_ref, z_r, z_t):
        q_tgt2 = quat_mul(q_tgt, expmap(d))
        return F.rotation_prior_residual(q_tgt2, q_ref, z_r, z_t, pb.ext, pb.sqrt_inv_cov2)

    zeros = states.q.new_zeros((rf.tgt.shape[0], 3))
    r, J3 = _value_and_jacfwd(local, zeros, q_t, rf.q_ref, rf.z_ref, rf.z_tgt)
    return r, _scatter_frame_block(J3, rf.tgt, W)  # pads cols 3:15 with zeros


def linearize_prior(states: FrameStates, pb: BAProblem):
    W = states.q.shape[0]
    D = W * ES_SIZE

    def local(dflat):
        r = F.prior_residual(retract(states, dflat.reshape(W, ES_SIZE)), pb.prior)
        return r, r

    J, r = jacfwd(local, has_aux=True)(states.q.new_zeros(D))
    w = pb.prior_valid.to(r.dtype)
    return r * w, J * w


# ---------------------------------------------------------------------------
# cost
# ---------------------------------------------------------------------------


def _cauchy_rho(s):
    """Ceres CauchyLoss(1.0): rho(s) = log(1 + s)."""
    return torch.log1p(s)


def compute_cost(states, inv_depth, pb: BAProblem):
    """0.5 * (sum_vision rho(|r|^2) + sum_imu |r|^2 + |r_prior|^2)."""
    ext, sic2 = pb.ext, pb.sqrt_inv_cov2
    reproj = vmap(lambda a, b, c, d, e, f, g: F.reprojection_residual(
        a, b, c, d, e, f, g, ext, sic2))
    preint = vmap(lambda *a: F.preintegration_residual(*a, ext))

    rf = pb.reproj
    tgt, ref = rf.tgt.long(), rf.ref.long()
    r_v = reproj(states.q[tgt], states.p[tgt], states.q[ref], states.p[ref],
                 torch.clamp(inv_depth[rf.lm.long()], min=1e-12), rf.z_ref, rf.z_tgt)
    c_v = torch.sum(torch.where(rf.valid, _cauchy_rho(torch.sum(r_v * r_v, dim=-1)), 0.0))

    rp = pb.reproj_prior
    tgt = rp.tgt.long()
    r_vp = reproj(states.q[tgt], states.p[tgt], rp.q_ref, rp.p_ref,
                  torch.clamp(rp.inv_depth, min=1e-12), rp.z_ref, rp.z_tgt)
    c_v = c_v + torch.sum(
        torch.where(rp.valid, _cauchy_rho(torch.sum(r_vp * r_vp, dim=-1)), 0.0))

    mp = pb.imu_prior
    sjp = _take(states, mp.j)
    r_mp = preint(mp.q_i, mp.p_i, mp.v_i, mp.bg_i, mp.ba_i,
                  sjp.q, sjp.p, sjp.v, sjp.bg, sjp.ba,
                  mp.delta, mp.sqrt_inv_cov, mp.bg_i, mp.ba_i)
    c_mp = torch.sum(torch.where(mp.valid, torch.sum(r_mp * r_mp, dim=-1), 0.0))

    mf = pb.imu
    si, sj = _take(states, mf.i), _take(states, mf.j)
    r_m = preint(si.q, si.p, si.v, si.bg, si.ba, sj.q, sj.p, sj.v, sj.bg, sj.ba,
                 mf.delta, mf.sqrt_inv_cov, mf.bg0, mf.ba0)
    c_m = torch.sum(torch.where(mf.valid, torch.sum(r_m * r_m, dim=-1), 0.0))

    ro = pb.rot
    r_r = vmap(lambda a, b, c, d: F.rotation_prior_residual(a, b, c, d, ext, sic2))(
        states.q[ro.tgt.long()], ro.q_ref, ro.z_ref, ro.z_tgt)
    c_r = torch.sum(torch.where(ro.valid, _cauchy_rho(torch.sum(r_r * r_r, dim=-1)), 0.0))

    r_p = F.prior_residual(states, pb.prior) * pb.prior_valid.to(r_v.dtype)
    c_p = torch.sum(r_p * r_p)

    return 0.5 * (c_v + c_m + c_mp + c_r + c_p)


# ---------------------------------------------------------------------------
# normal equations + Schur
# ---------------------------------------------------------------------------


def _col_mask(pb: BAProblem, W, dtype):
    pose = pb.opt_pose.to(dtype)[:, None].expand(W, 6)
    motion = pb.opt_motion.to(dtype)[:, None].expand(W, 9)
    return torch.cat([pose, motion], dim=-1).reshape(-1)  # (D,)


def segment_sum(data, segment_ids, num_segments):
    """jax.ops.segment_sum over dim 0. On CUDA `index_add` adds with
    atomics, so the order of summation (and the last bits) varies from run
    to run; the CPU adds in index order. Out of place, so that it runs
    under `torch.func.vmap` with batched data (an in-place add into an
    unbatched tensor cannot take a batched one)."""
    out = data.new_zeros((num_segments,) + data.shape[1:])
    return torch.index_add(out, 0, segment_ids, data)


def build_normal_system(states, inv_depth, pb: BAProblem):
    """Linearize everything and build (H, g, Hll, Hcl, bl, cmask)."""
    W = states.q.shape[0]
    D = W * ES_SIZE
    dtype = states.q.dtype
    L = inv_depth.shape[0]
    cmask = _col_mask(pb, W, dtype)
    lm = pb.reproj.lm.long()

    # --- vision rows (Cauchy IRLS) ---
    r_v, Jc_v, Jl_v = linearize_reprojection(states, inv_depth, pb)
    s_v = torch.sum(r_v * r_v, dim=-1)
    w_v = torch.where(pb.reproj.valid, 1.0 / (1.0 + s_v), 0.0)  # rho'(s)
    sw_v = torch.sqrt(w_v)[:, None]
    Jl_v = Jl_v * pb.opt_lm[lm].to(dtype)[:, None]
    rv = (r_v * sw_v).reshape(-1)
    Jv = (Jc_v * sw_v[..., None]).reshape(-1, D) * cmask[None, :]
    Jlv = (Jl_v * sw_v).reshape(-1)
    lm_rows = lm[:, None].expand(-1, 2).reshape(-1)  # jnp.repeat(lm, 2)

    # --- fixed-anchor vision prior rows (Cauchy IRLS) ---
    r_vp, Jc_vp = linearize_reproj_prior(states, pb)
    s_vp = torch.sum(r_vp * r_vp, dim=-1)
    w_vp = torch.where(pb.reproj_prior.valid, 1.0 / (1.0 + s_vp), 0.0)
    sw_vp = torch.sqrt(w_vp)[:, None]
    rvp = (r_vp * sw_vp).reshape(-1)
    Jvp = (Jc_vp * sw_vp[..., None]).reshape(-1, D) * cmask[None, :]

    # --- fixed-i imu prior rows ---
    r_mp, Jc_mp = linearize_imu_prior(states, pb)
    wmp = torch.sqrt(pb.imu_prior.valid.to(dtype))[:, None]
    rmp = (r_mp * wmp).reshape(-1)
    Jmp = (Jc_mp * wmp[..., None]).reshape(-1, D) * cmask[None, :]

    # --- imu rows ---
    r_m, Jc_m = linearize_imu(states, pb)
    wm = torch.sqrt(pb.imu.valid.to(dtype))[:, None]
    rm = (r_m * wm).reshape(-1)
    Jm = (Jc_m * wm[..., None]).reshape(-1, D) * cmask[None, :]

    # --- rotation rows (Cauchy) ---
    r_r, Jc_r = linearize_rot(states, pb)
    s_r = torch.sum(r_r * r_r, dim=-1)
    w_r = torch.where(pb.rot.valid, 1.0 / (1.0 + s_r), 0.0)
    swr = torch.sqrt(w_r)[:, None]
    rr = (r_r * swr).reshape(-1)
    Jr = (Jc_r * swr[..., None]).reshape(-1, D) * cmask[None, :]

    # --- prior rows ---
    r_p, J_p = linearize_prior(states, pb)
    J_p = J_p * cmask[None, :]

    # --- normal equations: one stacked matmul each (plain matmuls, as in
    # the JAX package; TF32 must be off for f32, see the package docstring)
    J_all = torch.cat([Jv, Jvp, Jm, Jmp, Jr, J_p], dim=0)
    r_all = torch.cat([rv, rvp, rm, rmp, rr, r_p], dim=0)
    H = J_all.mT @ J_all
    g = J_all.mT @ r_all

    # --- landmark block (scalar per landmark) ---
    Hll = segment_sum(Jlv * Jlv, lm_rows, L)
    bl = segment_sum(Jlv * rv, lm_rows, L)
    Hcl = segment_sum(Jlv[:, None] * Jv, lm_rows, L)  # (L, D)

    return H, g, Hll, Hcl, bl, cmask


def solve_normal_system(H, g, Hll, Hcl, bl, cmask, lam, opt_lm):
    """Damped Schur solve. Returns (delta_c (D,), delta_l (L,))."""
    dtype = H.dtype
    D = H.shape[0]
    # the 1e-12 regularisers and gates are the JAX package's, copied as they
    # are: they decide which landmarks and columns take part
    Hd = H + lam * torch.diag(torch.diagonal(H)) + 1e-12 * torch.eye(
        D, dtype=dtype, device=H.device)
    Hll_d = Hll * (1.0 + lam) + 1e-12
    lm_on = opt_lm & (Hll > 1e-12)
    inv_Hll = torch.where(lm_on, 1.0 / Hll_d, 0.0)
    Hred = Hd - Hcl.mT @ (Hcl * inv_Hll[:, None])
    gred = g - Hcl.mT @ (bl * inv_Hll)
    # disabled columns: identity rows/cols, zero gradient
    Hred = Hred * (cmask[:, None] * cmask[None, :]) + torch.diag(1.0 - cmask)
    gred = gred * cmask
    # Cholesky failure: jnp.linalg.cholesky returns NaNs for a matrix that is
    # not positive definite and the JAX package turns them into a zero camera
    # step; torch.linalg.cholesky would raise and wait for the device. So:
    # cholesky_ex (no check, no sync) and a zero step where info != 0. The
    # input is symmetrized first, as jnp.linalg.cholesky does by default.
    L_chol, info = torch.linalg.cholesky_ex(0.5 * (Hred + Hred.mT))
    y = torch.linalg.solve_triangular(L_chol, -gred[:, None], upper=False)
    delta_c = torch.linalg.solve_triangular(L_chol.mT, y, upper=True)[:, 0]
    delta_c = torch.where(torch.isfinite(delta_c) & (info == 0), delta_c, 0.0) * cmask
    delta_l = -(bl + Hcl @ delta_c) * inv_Hll
    return delta_c, delta_l


# ---------------------------------------------------------------------------
# LM loop
# ---------------------------------------------------------------------------

class _Stats(threading.local):
    """solve_ba / solve_ba_rows calls and the LM iterations they ran, per
    thread (each Odometry of a threaded or batched run solves on its own
    thread), for the callers' statistics. A batched solve counts once, with
    the iterations its loop ran: the most of any row."""

    def __init__(self):
        self.solves = 0
        self.iterations = 0


STATS = _Stats()
# the LM iterations of each row of every batched solve (a list per solve),
# for a caller that reports them (the last 4096 solves)
ROW_ITERATIONS: collections.deque = collections.deque(maxlen=4096)


def solve_ba(states: FrameStates, inv_depth, pb: BAProblem, max_iterations: int = 10,
             timer=None) -> BAResult:
    """Levenberg-Marquardt with accept/reject, early termination and a fixed
    iteration budget; `iterations` counts the accepted steps.

    The JAX package runs this loop as a lax.while_loop whose stop flag never
    leaves the device. Here it is a Python loop that reads the flag once per
    iteration: one host sync per LM iteration and no work after the stop,
    where a fixed-length loop that freezes its carry once done would need no
    sync but always run `max_iterations` linearizations (a converged window
    solve stops after a few). Both give the JAX result.

    `timer` (a utils.metrics.DeviceStageTimer, or None) records the device
    spans `ba.build_normal_system`, `ba.solve_normal_system` and
    `ba.update` (retraction, cost, accept) of every iteration.
    """
    W = states.q.shape[0]
    dtype = states.q.dtype
    dev = states.q.device
    span = timer.time if timer is not None else (lambda _: contextlib.nullcontext())
    fi = torch.finfo(dtype)
    opt_lm = pb.opt_lm.to(dtype)
    cost0 = compute_cost(states, inv_depth, pb)

    s, invd, cost = states, inv_depth, cost0
    lam = torch.full((), 1e-4, dtype=dtype, device=dev)  # made on the device: no copy
    n_acc = torch.zeros((), dtype=torch.int32, device=dev)
    STATS.solves += 1
    for _ in range(max_iterations):
        STATS.iterations += 1
        with span("ba.build_normal_system"):
            H, g, Hll, Hcl, bl, cmask = build_normal_system(s, invd, pb)
        with span("ba.solve_normal_system"):
            dc, dl = solve_normal_system(H, g, Hll, Hcl, bl, cmask, lam, pb.opt_lm)
        with span("ba.update"):
            s_new = retract(s, dc.reshape(W, ES_SIZE))
            invd_new = invd + dl * opt_lm
            new_cost = compute_cost(s_new, invd_new, pb)
            accept = (new_cost < cost) & torch.isfinite(new_cost)
            # Ceres-default convergence tests: function_tolerance 1e-6 on the
            # relative decrease of an accepted step, parameter_tolerance 1e-8
            # on the step size; and a REJECTED step whose cost change sits at
            # the dtype's noise floor ends the solve. The floor is
            # finfo(dtype) of the solve's own dtype: an f32 solve tested
            # against f64 constants would never stop early.
            rel_decrease = (cost - new_cost) / torch.clamp(cost, min=fi.tiny)
            step_small = torch.max(torch.abs(dc)) < 1e-8
            at_noise_floor = torch.abs(rel_decrease) < 10 * fi.eps
            done = (accept & (rel_decrease < 1e-6)) | step_small | (~accept & at_noise_floor)
            s = FrameStates(*(torch.where(accept, b, a) for a, b in zip(s, s_new)))
            invd = torch.where(accept, invd_new, invd)
            cost = torch.where(accept, new_cost, cost)
            # damping schedule and its [1e-9, 1e8] clamp as in the JAX package
            lam = torch.where(accept, torch.clamp(lam / 3.0, min=1e-9),
                              torch.clamp(lam * 4.0, max=1e8))
            n_acc = n_acc + accept.to(torch.int32)
        if bool(done):  # the loop's one host sync per iteration
            break
    return BAResult(states=s, inv_depth=invd, cost=cost, initial_cost=cost0,
                    iterations=n_acc)


def _rows_where(mask, new, old):
    """Per row of the leading axis: `new` where `mask`, else `old`."""
    return torch.where(mask.reshape((-1,) + (1,) * (old.ndim - 1)), new, old)


class _RowCarry(NamedTuple):
    """The LM loop's carry of a batched solve, one entry per row."""

    s: FrameStates
    invd: torch.Tensor
    cost: torch.Tensor
    lam: torch.Tensor
    n_acc: torch.Tensor
    done: torch.Tensor


def _row_step(c: _RowCarry, pb: BAProblem) -> _RowCarry:
    """One LM iteration of every row (the body of solve_ba's loop under
    vmap); a row that is done keeps its carry."""
    N, W = c.s.q.shape[:2]
    fi = torch.finfo(c.s.q.dtype)
    H, g, Hll, Hcl, bl, cmask = vmap(build_normal_system)(c.s, c.invd, pb)
    dc, dl = vmap(solve_normal_system)(H, g, Hll, Hcl, bl, cmask, c.lam, pb.opt_lm)
    s_new = vmap(retract)(c.s, dc.reshape(N, W, ES_SIZE))
    invd_new = c.invd + dl * pb.opt_lm.to(dc.dtype)
    new_cost = vmap(compute_cost)(s_new, invd_new, pb)
    accept = (new_cost < c.cost) & torch.isfinite(new_cost)
    rel_decrease = (c.cost - new_cost) / torch.clamp(c.cost, min=fi.tiny)
    step_small = torch.amax(torch.abs(dc), dim=1) < 1e-8
    at_noise_floor = torch.abs(rel_decrease) < 10 * fi.eps
    stop = (accept & (rel_decrease < 1e-6)) | step_small | (~accept & at_noise_floor)
    live = ~c.done
    take = accept & live
    return _RowCarry(
        s=FrameStates(*(_rows_where(take, b, a) for a, b in zip(c.s, s_new))),
        invd=_rows_where(take, invd_new, c.invd),
        cost=torch.where(take, new_cost, c.cost),
        lam=torch.where(live, torch.where(accept, torch.clamp(c.lam / 3.0, min=1e-9),
                                          torch.clamp(c.lam * 4.0, max=1e8)), c.lam),
        n_acc=c.n_acc + take.to(torch.int32),
        done=c.done | stop)


def _flat(tree) -> list:
    return tree_flatten(tree)[0]


class _GraphedRowStep:
    """`_row_step` captured once in a CUDA graph for one set of shapes and
    dtypes: a replay launches the iteration's few thousand kernels from one
    host call, where the eager body dispatches each from Python (PERF.md).
    The graph reads and writes its own static tensors: `load` copies a
    solve's problem and carry in, each `replay` advances the carry in
    place."""

    def __init__(self, c: _RowCarry, pb: BAProblem):
        self.c = tree_map(torch.clone, c)
        self.pb = tree_map(torch.clone, pb)
        # warm-up on a side stream (library handles, workspaces), then the
        # capture, as torch.cuda.graphs asks
        # capture, as torch.cuda.graphs asks; the batched Cholesky through
        # cuSOLVER, whose batched factorization never waits for the host
        lib = torch.backends.cuda.preferred_linalg_library()
        torch.backends.cuda.preferred_linalg_library("cusolver")
        try:
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                for _ in range(2):
                    _row_step(self.c, self.pb)
            torch.cuda.current_stream().wait_stream(side)
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph):
                out = _row_step(self.c, self.pb)
                for dst, src in zip(_flat(self.c), _flat(out)):
                    dst.copy_(src)
        finally:
            torch.backends.cuda.preferred_linalg_library(lib)

    def load(self, c: _RowCarry, pb: BAProblem):
        for dst, src in zip(_flat(self.c) + _flat(self.pb), _flat(c) + _flat(pb)):
            dst.copy_(src)

    def replay(self):
        self.graph.replay()


# captured batched LM iterations by their inputs' shapes and dtypes; the
# batched solve replays them on CUDA while ROW_GRAPHS is set
ROW_GRAPHS = True
_row_graphs: dict = {}


def _graph_key(c: _RowCarry, pb: BAProblem) -> tuple:
    return tuple((tuple(t.shape), t.dtype, t.device) for t in _flat(c) + _flat(pb))


def solve_ba_rows(states: FrameStates, inv_depth, pb: BAProblem,
                  max_iterations: int = 10) -> BAResult:
    """N independent `solve_ba`s with a leading row axis on every leaf of
    `states`, `inv_depth` and `pb` (and of the result).

    The JAX package vmaps its `lax.while_loop`: the loop runs while any row
    goes on, and a row that is done keeps its carry. Here each iteration's
    body (`build_normal_system`, `solve_normal_system`, `retract`,
    `compute_cost`) is vmapped over the rows, a row freezes once its stop
    test has fired, and the loop reads the rows' stop flags once per
    iteration (one host sync) and ends when every row is done. Each row's
    result (accepted steps counted per row) is its single-row solve's;
    ROW_ITERATIONS gets the iterations each row ran. The loop (the
    iterations and their stop-flag reads) runs inside the span `ba.rows.lm`.

    On CUDA (while ROW_GRAPHS is set) the iteration runs as a CUDA graph,
    captured at the first solve of each set of shapes: the same kernels on
    the same inputs, launched from one host call."""
    N = states.q.shape[0]
    dtype = states.q.dtype
    dev = states.q.device
    cost0 = vmap(compute_cost)(states, inv_depth, pb)
    c = _RowCarry(s=states, invd=inv_depth, cost=cost0,
                  lam=torch.full((N,), 1e-4, dtype=dtype, device=dev),
                  n_acc=torch.zeros((N,), dtype=torch.int32, device=dev),
                  done=torch.zeros((N,), dtype=torch.bool, device=dev))
    graph = None
    if ROW_GRAPHS and dev.type == "cuda":
        key = _graph_key(c, pb)
        graph = _row_graphs.get(key)
        if graph is None:
            graph = _row_graphs[key] = _GraphedRowStep(c, pb)
        graph.load(c, pb)
    row_its, live_prev = [0] * N, [True] * N
    STATS.solves += 1
    with _T.time("ba.rows.lm"):
        for _ in range(max_iterations):
            STATS.iterations += 1
            if graph is not None:
                graph.replay()
                c = graph.c
            else:
                c = _row_step(c, pb)
            # the loop's one host sync per iteration: the rows' stop flags
            done_h = c.done.cpu().tolist()
            row_its = [n + 1 if live else n for n, live in zip(row_its, live_prev)]
            live_prev = [not d for d in done_h]
            if all(done_h):
                break
    ROW_ITERATIONS.append(row_its)
    if graph is not None:  # the graph's tensors are overwritten by its next solve
        c = tree_map(torch.clone, c)
    return BAResult(states=c.s, inv_depth=c.invd, cost=c.cost, initial_cost=cost0,
                    iterations=c.n_acc)
