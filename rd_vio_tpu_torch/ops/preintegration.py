"""IMU preintegration with covariance and bias Jacobians.

Port of the JAX package's ops/preintegration.py. Raw samples live in
fixed-capacity padded tensors (dt, w, a)[N]; padding uses dt = 0, which is
an exact no-op of the discrete-time update. The error-state order is
(q, p, v, bg, ba): ES_Q=0, ES_P=3, ES_V=6, ES_BG=9, ES_BA=12.

`integrate` evaluates the recurrences with log-depth scans of batched
products; `integrate_sequential` is the step-for-step reference it is held
against.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from rd_vio_tpu_torch.ops.lie import (
    expmap,
    hat,
    quat_mul,
    quat_normalize,
    quat_rotate,
    quat_to_matrix,
    right_jacobian,
)

ES_Q, ES_P, ES_V, ES_BG, ES_BA, ES_SIZE = 0, 3, 6, 9, 12, 15

GRAVITY = torch.tensor([0.0, 0.0, -9.80665], dtype=torch.float64)


def gravity_like(x):
    """GRAVITY with x's dtype, device and leading dims, made on x's device
    (a copy from host memory would make the host wait for the device)."""
    return torch.cat([torch.zeros_like(x[..., :2]),
                      torch.full_like(x[..., 2:], float(GRAVITY[2]))], dim=-1)


class PreintDelta(NamedTuple):
    """Integrated IMU delta between two frames."""

    t: torch.Tensor  # scalar, total dt
    q: torch.Tensor  # (4,) wxyz
    p: torch.Tensor  # (3,)
    v: torch.Tensor  # (3,)
    cov: torch.Tensor  # (15, 15), order (q, p, v, bg, ba)
    # bias jacobians
    dq_dbg: torch.Tensor  # (3, 3)
    dp_dbg: torch.Tensor
    dp_dba: torch.Tensor
    dv_dbg: torch.Tensor
    dv_dba: torch.Tensor


def zero_delta(dtype=torch.float64, device="cuda") -> PreintDelta:
    z = lambda *shape: torch.zeros(shape, dtype=dtype, device=device)  # noqa: E731
    q = z(4)
    q[0] = 1.0
    return PreintDelta(t=z(), q=q, p=z(3), v=z(3), cov=z(15, 15), dq_dbg=z(3, 3),
                       dp_dbg=z(3, 3), dp_dba=z(3, 3), dv_dbg=z(3, 3), dv_dba=z(3, 3))


def integrate_sequential(dts, ws, accs, bg, ba, cov_w, cov_a, cov_bg, cov_ba) -> PreintDelta:
    """Sample-by-sample reference of `integrate` (one step per sample, in the
    order of the discrete-time update)."""
    dtype = ws.dtype
    dev = ws.device
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    d = zero_delta(dtype, dev)
    for dt, w_raw, a_raw in zip(dts.to(dtype), ws, accs):
        w = w_raw - bg
        a = a_raw - ba
        dq_inc = expmap(w * dt)
        R_inc_T = quat_to_matrix(dq_inc).mT
        Rk = quat_to_matrix(d.q)
        Rk_hat_a = Rk @ hat(a)
        Jr = right_jacobian(w * dt)

        # --- covariance propagation ---
        A = torch.eye(9, dtype=dtype, device=dev)
        A[ES_Q : ES_Q + 3, ES_Q : ES_Q + 3] = R_inc_T
        A[ES_V : ES_V + 3, ES_Q : ES_Q + 3] = -dt * Rk_hat_a
        A[ES_P : ES_P + 3, ES_Q : ES_Q + 3] = -0.5 * dt * dt * Rk_hat_a
        A[ES_P : ES_P + 3, ES_V : ES_V + 3] = dt * eye3

        B = torch.zeros((9, 6), dtype=dtype, device=dev)
        B[ES_Q : ES_Q + 3, 0:3] = dt * Jr
        B[ES_V : ES_V + 3, 3:6] = dt * Rk
        B[ES_P : ES_P + 3, 3:6] = 0.5 * dt * dt * Rk

        inv_dt = 1.0 / torch.clamp(dt, min=1.0e-7)
        Wn = torch.zeros((6, 6), dtype=dtype, device=dev)
        Wn[0:3, 0:3] = cov_w * inv_dt
        Wn[3:6, 3:6] = cov_a * inv_dt

        cov = d.cov.clone()
        cov[:9, :9] = A @ d.cov[:9, :9] @ A.mT + B @ Wn @ B.mT
        cov[ES_BG : ES_BG + 3, ES_BG : ES_BG + 3] += cov_bg * dt
        cov[ES_BA : ES_BA + 3, ES_BA : ES_BA + 3] += cov_ba * dt

        # --- bias jacobians ---
        dp_dbg = d.dp_dbg + dt * d.dv_dbg - 0.5 * dt * dt * Rk_hat_a @ d.dq_dbg
        dp_dba = d.dp_dba + dt * d.dv_dba - 0.5 * dt * dt * Rk
        dv_dbg = d.dv_dbg - dt * Rk_hat_a @ d.dq_dbg
        dv_dba = d.dv_dba - dt * Rk
        dq_dbg = R_inc_T @ d.dq_dbg - dt * Jr

        # --- mean propagation ---
        qa = quat_rotate(d.q, a)
        d = PreintDelta(
            t=d.t + dt,
            q=quat_normalize(quat_mul(d.q, dq_inc)),
            p=d.p + dt * d.v + 0.5 * dt * dt * qa,
            v=d.v + dt * qa,
            cov=cov, dq_dbg=dq_dbg, dp_dbg=dp_dbg, dp_dba=dp_dba,
            dv_dbg=dv_dbg, dv_dba=dv_dba,
        )
    return d


def _inclusive_scan(combine, elems):
    """Inclusive scan of an associative `combine(earlier, later)` over dim 0
    of every tensor in the tuple `elems` (Hillis-Steele: ceil(log2 N) steps,
    each one batched call of `combine`). PyTorch has no associative scan;
    the grouping differs from jax.lax.associative_scan's, so results agree
    up to floating-point reassociation."""
    n = elems[0].shape[0]
    off = 1
    while off < n:
        comb = combine(tuple(e[:-off] for e in elems), tuple(e[off:] for e in elems))
        elems = tuple(torch.cat([e[:off], c], dim=0) for e, c in zip(elems, comb))
        off *= 2
    return elems


def integrate(dts, ws, accs, bg, ba, cov_w, cov_a, cov_bg, cov_ba) -> PreintDelta:
    """Integrate padded IMU samples from scratch at bias (bg, ba).

    Args:
      dts: (N,) per-sample integration interval; 0 entries are exact no-ops.
      ws, accs: (N, 3) raw gyro / accel samples.
      bg, ba: (3,) bias linearization point.
      cov_w/cov_a: (3,3) continuous white-noise covs; cov_bg/cov_ba random walk.

    Semantics match `integrate_sequential` up to floating-point
    reassociation. The recurrences are evaluated as scans:
      * orientation prefix: quaternion product chain -> scan of quat_mul.
      * mean p, v: affine in the prefix quantities -> cumulative sums.
      * bias Jacobian dq_dbg: X_i = A_i X_{i-1} + B_i -> scan of affine
        compositions; the remaining Jacobians are cumulative sums.
      * covariance: C_i = A_i C_{i-1} A_i^T + N_i -> scan of congruence
        compositions on (A, C) pairs.
    A padded dt = 0 sample has dq = (1, 0, 0, 0), A = I and zero offsets, so
    it composes as an exact identity in every recurrence.
    """
    dtype = ws.dtype
    dev = ws.device
    dts = dts.to(dtype)
    N = dts.shape[0]
    dt1 = dts[:, None]
    dt2 = (dts * dts)[:, None]

    w = ws - bg[None, :]
    a = accs - ba[None, :]
    wdt = w * dt1

    # --- orientation prefix products ------------------------------------
    dq = expmap(wdt)  # (N, 4)
    (Q,) = _inclusive_scan(lambda e1, e2: (quat_mul(e1[0], e2[0]),), (dq,))
    Q = quat_normalize(Q)
    q_id = torch.eye(4, dtype=dtype, device=dev)[:1]  # (1, 0, 0, 0)
    q_prev = torch.cat([q_id, Q[:-1]], dim=0)  # (N, 4) prefix BEFORE i

    R_prev = quat_to_matrix(q_prev)  # (N, 3, 3)
    qa = quat_rotate(q_prev, a)  # (N, 3)

    # --- mean (p, v) as prefix sums --------------------------------------
    dtqa = dt1 * qa
    v_pref = torch.cumsum(dtqa, dim=0)
    v_prev = v_pref - dtqa  # exclusive prefix
    v_out = v_pref[-1]
    p_out = torch.sum(dt1 * v_prev + 0.5 * dt2 * qa, dim=0)
    t_out = torch.sum(dts)

    # --- bias Jacobians ---------------------------------------------------
    Jr = right_jacobian(wdt)  # (N, 3, 3)
    R_incT = quat_to_matrix(dq).mT
    RkHat = R_prev @ hat(a)  # (N, 3, 3)
    dt1m = dt1[..., None]
    dt2m = dt2[..., None]

    def affine_combine(e1, e2):
        # e1 earlier, e2 later: x -> A2 (A1 x + B1) + B2
        (A1, B1), (A2, B2) = e1, e2
        return A2 @ A1, A2 @ B1 + B2

    _, dq_dbg_pref = _inclusive_scan(affine_combine, (R_incT, -dt1m * Jr))
    dq_dbg_prev = torch.cat([dts.new_zeros((1, 3, 3)), dq_dbg_pref[:-1]], dim=0)
    dq_dbg = dq_dbg_pref[-1]

    dv_dbg_step = -dt1m * (RkHat @ dq_dbg_prev)
    dv_dbg_pref = torch.cumsum(dv_dbg_step, dim=0)
    dv_dbg_prev = dv_dbg_pref - dv_dbg_step
    dv_dbg = dv_dbg_pref[-1]

    dv_dba_step = -dt1m * R_prev
    dv_dba_pref = torch.cumsum(dv_dba_step, dim=0)
    dv_dba_prev = dv_dba_pref - dv_dba_step
    dv_dba = dv_dba_pref[-1]

    dp_dbg = torch.sum(dt1m * dv_dbg_prev - 0.5 * dt2m * (RkHat @ dq_dbg_prev), dim=0)
    dp_dba = torch.sum(dt1m * dv_dba_prev - 0.5 * dt2m * R_prev, dim=0)

    # --- covariance: congruence composition -------------------------------
    # blocks joined with cat, not written in place, so that integrate stays
    # usable under torch.func.vmap (a batch of intervals)
    z = lambda *shape: dts.new_zeros((N,) + shape)  # noqa: E731
    eye3 = torch.eye(3, dtype=dtype, device=dev).expand(N, 3, 3)
    A = torch.cat([
        torch.cat([R_incT, z(3, 6)], dim=-1),
        torch.cat([-0.5 * dt2m * RkHat, eye3, dt1m * eye3], dim=-1),
        torch.cat([-dt1m * RkHat, z(3, 3), eye3], dim=-1),
    ], dim=-2)
    B = torch.cat([
        torch.cat([dt1m * Jr, z(3, 3)], dim=-1),
        torch.cat([z(3, 3), 0.5 * dt2m * R_prev], dim=-1),
        torch.cat([z(3, 3), dt1m * R_prev], dim=-1),
    ], dim=-2)

    inv_dt = (1.0 / torch.clamp(dts, min=1.0e-7))[:, None, None]
    Wn = torch.cat([
        torch.cat([cov_w * inv_dt, z(3, 3)], dim=-1),
        torch.cat([z(3, 3), cov_a * inv_dt], dim=-1),
    ], dim=-2)
    Nmat = B @ Wn @ B.mT

    def cov_combine(e1, e2):
        # e1 earlier, e2 later: C -> A2 (A1 C A1^T + N1) A2^T + N2
        (A1, C1), (A2, C2) = e1, e2
        return A2 @ A1, A2 @ C1 @ A2.mT + C2

    _, C_pref = _inclusive_scan(cov_combine, (A, Nmat))

    z2 = lambda *shape: dts.new_zeros(shape)  # noqa: E731
    cov = torch.cat([
        torch.cat([C_pref[-1], z2(9, 6)], dim=-1),
        torch.cat([z2(3, 9), cov_bg * t_out, z2(3, 3)], dim=-1),
        torch.cat([z2(3, 12), cov_ba * t_out], dim=-1),
    ], dim=-2)

    return PreintDelta(t=t_out, q=Q[-1], p=p_out, v=v_out, cov=cov, dq_dbg=dq_dbg,
                       dp_dbg=dp_dbg, dp_dba=dp_dba, dv_dbg=dv_dbg, dv_dba=dv_dba)


def _cholesky(A):
    """Lower Cholesky factor as jnp.linalg.cholesky computes it: of the
    symmetrized input, and NaN where that is not positive definite (no
    error and no host sync; `torch.linalg.cholesky` would raise)."""
    L, info = torch.linalg.cholesky_ex(0.5 * (A + A.mT))
    return torch.where(info[..., None, None] == 0, L, torch.nan)


def sqrt_inv_cov(cov, gauge_eps: float = 0.0):
    """Whitening matrix U with U^T U = cov^-1: the upper Cholesky factor of
    cov^-1, where cov^-1 is formed by a Cholesky solve against identity."""
    n = cov.shape[-1]
    eye = torch.eye(n, dtype=cov.dtype, device=cov.device)
    L = _cholesky(cov + gauge_eps * eye)
    inv_cov = torch.cholesky_solve(eye, L)
    inv_cov = 0.5 * (inv_cov + inv_cov.mT)
    return _cholesky(inv_cov).mT


def predict(delta: PreintDelta, q, p, v, bg, ba):
    """Gravity-aware forward propagation of a frame state by an integrated
    delta. Returns (q', p', v', bg, ba)."""
    g = gravity_like(p)
    v_new = v + g * delta.t + quat_rotate(q, delta.v)
    p_new = p + 0.5 * g * delta.t**2 + v * delta.t + quat_rotate(q, delta.p)
    q_new = quat_normalize(quat_mul(q, delta.q))
    return q_new, p_new, v_new, bg, ba


def propagate_state(q, p, v, dt, w, a, bg, ba):
    """Single forward-Euler IMU state propagation (IMU-rate pose
    prediction). Batch-friendly."""
    g = gravity_like(p)
    a_world = quat_rotate(q, a - ba) + g
    q_new = quat_normalize(quat_mul(q, expmap((w - bg) * dt)))
    p_new = p + dt * v + 0.5 * dt * dt * a_world
    v_new = v + dt * a_world
    return q_new, p_new, v_new
