"""Plain reference of one sliding-window visual-inertial bundle adjustment.

The problem comes as nested dicts of tensors (one problem, no row axis),
with the fields of the window solve: reprojection factors (inverse depth
along the anchor bearing, residual in the tangent basis of the observed
bearing, whitened by a 2x2 matrix), fixed-anchor reprojection priors,
preintegration factors between frames (15 residuals: rotation, position,
velocity, the two bias differences, with the first-order bias correction),
fixed-i preintegration priors, rotation-only reprojection priors, and the
marginalization prior r = S dx + b. Vision terms take Cauchy's loss
rho(s) = log(1 + s); the cost is 0.5 * (sum rho(|r|^2) over vision terms +
sum |r|^2 over the others).

The solver is a dense Levenberg-Marquardt over every free variable at once
(the frames' 15-dim error states, with a right-multiplied rotation update,
and the landmarks' inverse depths): the Jacobian of the whole residual
vector by forward-mode differentiation, the normal equations as one matrix,
a Cholesky solve, no Schur complement. It runs in the dtype of the tensors
it is given (float64 for the reference) until the cost stops falling.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import torch
from torch.func import jacfwd

GRAVITY_Z = -9.80665
ES = 15  # error-state size of one frame: rotation, position, velocity, bg, ba


# --------------------------------------------------------------------------
# rotations (wxyz unit quaternions, Hamilton product)
# --------------------------------------------------------------------------


def qmul(a, b):
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack([aw * bw - ax * bx - ay * by - az * bz,
                        aw * bx + ax * bw + ay * bz - az * by,
                        aw * by - ax * bz + ay * bw + az * bx,
                        aw * bz + ax * by - ay * bx + az * bw], dim=-1)


def qconj(q):
    return q * torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=q.dtype, device=q.device)


def rot(q, v):
    """v rotated by q: v + 2w (u x v) + 2u x (u x v), u the vector part
    (the rotation matrix of q where q has unit length; the states of a
    float32 solve are off it by some 1e-7, and are taken as given)."""
    u, v = torch.broadcast_tensors(q[..., 1:], v)
    t = 2.0 * torch.linalg.cross(u, v)
    return v + q[..., :1] * t + torch.linalg.cross(u, t)


def rot_inv(q, v):
    return rot(qconj(q), v)


def exp_q(w):
    """Rotation vector -> unit quaternion; the series near 0 (where the
    Jacobians are taken), the closed form elsewhere."""
    t2 = (w * w).sum(-1, keepdim=True)
    t = torch.sqrt(torch.clamp(t2, min=1e-12))
    small = t2 < 1e-10
    s = torch.where(small, 0.5 - t2 / 48.0, torch.sin(0.5 * t) / t)
    c = torch.where(small, 1.0 - t2 / 8.0, torch.cos(0.5 * t))
    q = torch.cat([c, s * w], dim=-1)
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def log_q(q):
    """Unit quaternion -> rotation vector of the shortest arc."""
    q = torch.where(q[..., :1] < 0, -q, q)
    w = torch.clamp(q[..., :1], -1.0, 1.0)
    n = torch.linalg.vector_norm(q[..., 1:], dim=-1, keepdim=True)
    ang = 2.0 * torch.atan2(n, w)
    k = torch.where(n < 1e-10, 2.0 / torch.clamp(w, min=0.5), ang / torch.clamp(n, min=1e-12))
    return k * q[..., 1:]


def tangent_basis(z):
    """(..., 3) unit z -> (..., 3, 2): b0 = z x e, e the axis with the
    smallest |component| (the first of equal ones), b1 = z x b0, both
    normalized."""
    e = torch.nn.functional.one_hot(torch.argmin(z.abs(), dim=-1), 3).to(z.dtype)
    b0 = torch.linalg.cross(z, e)
    b0 = b0 / torch.linalg.vector_norm(b0, dim=-1, keepdim=True)
    b1 = torch.linalg.cross(z, b0)
    b1 = b1 / torch.linalg.vector_norm(b1, dim=-1, keepdim=True)
    return torch.stack([b0, b1], dim=-1)


# --------------------------------------------------------------------------
# residuals (every factor of a group at once)
# --------------------------------------------------------------------------


def _project(y, z_obs, S2):
    """Whitened 2-residual of a camera-frame point y against the observed
    unit bearing z_obs: the point's tangent-plane coordinates over its
    coordinate along z_obs."""
    B = tangent_basis(z_obs)
    u0 = (B[..., 0] * y).sum(-1)
    u1 = (B[..., 1] * y).sum(-1)
    u2 = (z_obs * y).sum(-1)
    r = torch.stack([u0 / u2, u1 / u2], dim=-1)
    return r @ S2.transpose(-1, -2)


def reproj(q_t, p_t, q_r, p_r, invd, z_r, z_t, ext, S2):
    y_ref = z_r / invd[..., None]
    x = rot(q_r, rot(ext["q_bc"], y_ref) + ext["p_bc"]) + p_r
    y_body = rot_inv(q_t, x - p_t)
    y = rot_inv(ext["q_bc"], y_body - ext["p_bc"])
    return _project(y, z_t, S2)


def rot_prior(q_t, q_r, z_r, z_t, ext, S2):
    zc = rot(ext["q_bc"], z_r) + ext["p_bc"]
    y_body = rot_inv(q_t, rot(q_r, zc))
    y = rot_inv(ext["q_bc"], y_body - ext["p_bc"])
    return _project(y, z_t, S2)


def preint(si, sj, d, S15, bg0, ba0, ext):
    """si, sj: dicts q, p, v, bg, ba of the two frames (body poses); d the
    integrated delta with its bias Jacobians."""
    g = torch.zeros_like(si["p"])
    g[..., 2] = GRAVITY_Z
    qi = qmul(si["q"], ext["q_bi"].expand_as(si["q"]))
    pi = si["p"] + rot(si["q"], ext["p_bi"].expand_as(si["p"]))
    qj = qmul(sj["q"], ext["q_bi"].expand_as(sj["q"]))
    pj = sj["p"] + rot(sj["q"], ext["p_bi"].expand_as(sj["p"]))
    dt = d["t"][..., None]
    dbg = si["bg"] - bg0
    dba = si["ba"] - ba0
    mv = lambda M, x: (M @ x[..., None])[..., 0]  # noqa: E731
    dq = qmul(d["q"], exp_q(mv(d["dq_dbg"], dbg)))
    r_q = log_q(qmul(qconj(dq), qmul(qconj(qi), qj)))
    r_p = rot_inv(qi, pj - pi - dt * si["v"] - 0.5 * dt * dt * g) - (
        d["p"] + mv(d["dp_dbg"], dbg) + mv(d["dp_dba"], dba))
    r_v = rot_inv(qi, sj["v"] - si["v"] - dt * g) - (
        d["v"] + mv(d["dv_dbg"], dbg) + mv(d["dv_dba"], dba))
    r = torch.cat([r_q, r_p, r_v, sj["bg"] - si["bg"], sj["ba"] - si["ba"]], dim=-1)
    return mv(S15, r)


# --------------------------------------------------------------------------
# the whole problem
# --------------------------------------------------------------------------


class Residuals(NamedTuple):
    robust: torch.Tensor  # (n, 2) vision rows, each pair under Cauchy's loss
    robust_on: torch.Tensor  # (n,) which of them count
    plain: torch.Tensor  # (m,) squared rows, already masked


def _take(states, idx):
    idx = idx.long()
    return {k: v[idx] for k, v in states.items()}


def retract(states, invd, delta, W):
    d = delta[: W * ES].reshape(W, ES)
    q = qmul(states["q"], exp_q(d[:, 0:3]))
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    new = {"q": q, "p": states["p"] + d[:, 3:6], "v": states["v"] + d[:, 6:9],
           "bg": states["bg"] + d[:, 9:12], "ba": states["ba"] + d[:, 12:15]}
    return new, invd + delta[W * ES:]


def residuals(states, invd, pb) -> Residuals:
    ext, S2 = pb["ext"], pb["sqrt_inv_cov2"]
    rf = pb["reproj"]
    t, r = rf["tgt"].long(), rf["ref"].long()
    d = torch.clamp(invd[rf["lm"].long()], min=1e-12)
    r_v = reproj(states["q"][t], states["p"][t], states["q"][r], states["p"][r], d,
                 rf["z_ref"], rf["z_tgt"], ext, S2)
    rp = pb["reproj_prior"]
    t = rp["tgt"].long()
    r_vp = reproj(states["q"][t], states["p"][t], rp["q_ref"], rp["p_ref"],
                  torch.clamp(rp["inv_depth"], min=1e-12), rp["z_ref"], rp["z_tgt"], ext, S2)
    ro = pb["rot"]
    r_r = rot_prior(states["q"][ro["tgt"].long()], ro["q_ref"], ro["z_ref"], ro["z_tgt"],
                    ext, S2)
    im = pb["imu"]
    r_m = preint(_take(states, im["i"]), _take(states, im["j"]), im["delta"],
                 im["sqrt_inv_cov"], im["bg0"], im["ba0"], ext)
    ip = pb["imu_prior"]
    si = {k: ip[f"{k}_i"] for k in ("q", "p", "v", "bg", "ba")}
    r_mp = preint(si, _take(states, ip["j"]), ip["delta"], ip["sqrt_inv_cov"],
                  ip["bg_i"], ip["ba_i"], ext)
    pr = pb["prior"]
    dx = torch.cat([log_q(qmul(qconj(pr["q_lin"]), states["q"])),
                    states["p"] - pr["p_lin"], states["v"] - pr["v_lin"],
                    states["bg"] - pr["bg_lin"], states["ba"] - pr["ba_lin"]], dim=-1)
    r_p = pr["sqrt_inv_cov"] @ dx.reshape(-1) + pr["infovec"]
    on = lambda v: v.to(r_m.dtype)[..., None]  # noqa: E731
    plain = torch.cat([(r_m * on(im["valid"])).reshape(-1),
                       (r_mp * on(ip["valid"])).reshape(-1),
                       r_p * pb["prior_valid"].to(r_p.dtype)])
    robust = torch.cat([r_v, r_vp, r_r], dim=0)
    robust_on = torch.cat([rf["valid"], rp["valid"], ro["valid"]])
    return Residuals(robust, robust_on, plain)


def cost(states, invd, pb) -> torch.Tensor:
    res = residuals(states, invd, pb)
    s = (res.robust * res.robust).sum(-1)
    c_robust = torch.where(res.robust_on, torch.log1p(s), torch.zeros_like(s)).sum()
    return 0.5 * (c_robust + (res.plain * res.plain).sum())


def free_columns(pb, W, L) -> torch.Tensor:
    """Which of the W*15 + L variables the problem lets move."""
    pose = pb["opt_pose"].bool()[:, None].expand(W, 6)
    motion = pb["opt_motion"].bool()[:, None].expand(W, 9)
    return torch.cat([torch.cat([pose, motion], -1).reshape(-1), pb["opt_lm"].bool()])


class Solution(NamedTuple):
    states: Dict[str, torch.Tensor]
    inv_depth: torch.Tensor
    cost: float
    initial_cost: float
    iterations: int


def solve(states, invd, pb, max_iterations: int = 100, rel_tol: float = 1e-10) -> Solution:
    """Minimize `cost` from (states, invd) by Levenberg-Marquardt on the
    dense normal equations, in the dtype of the inputs."""
    W, L = states["q"].shape[0], invd.shape[0]
    n = W * ES + L
    free = free_columns(pb, W, L)
    dt = states["q"].dtype

    def weighted(delta, s, d):
        s2, d2 = retract(s, d, delta, W)
        res = residuals(s2, d2, pb)
        return torch.cat([res.robust.reshape(-1), res.plain])

    c0 = cost(states, invd, pb)
    c = c0
    lam = 1e-4
    its = 0
    for _ in range(max_iterations):
        res = residuals(states, invd, pb)
        s = (res.robust * res.robust).sum(-1)
        w_rob = torch.where(res.robust_on, 1.0 / (1.0 + s), torch.zeros_like(s))
        sw = torch.cat([torch.sqrt(w_rob)[:, None].expand(-1, 2).reshape(-1),
                        torch.ones_like(res.plain)])
        r = torch.cat([res.robust.reshape(-1), res.plain]) * sw
        zero = torch.zeros(n, dtype=dt, device=invd.device)
        J = jacfwd(weighted)(zero, states, invd) * sw[:, None]
        J = J * free.to(dt)[None, :]
        H = J.T @ J
        g = J.T @ r
        diag = torch.diagonal(H).clone()
        idle = diag <= 0
        diag = torch.where(idle, torch.ones_like(diag), diag)
        H = H + torch.diag(torch.where(idle, torch.ones_like(diag), torch.zeros_like(diag)))
        g = torch.where(idle, torch.zeros_like(g), g)
        accepted = False
        while lam < 1e12:
            Hd = H + lam * torch.diag(diag)
            Lc, info = torch.linalg.cholesky_ex(0.5 * (Hd + Hd.T))
            if int(info) != 0:
                lam *= 4.0
                continue
            delta = -torch.cholesky_solve(g[:, None], Lc)[:, 0]
            s_new, d_new = retract(states, invd, delta, W)
            c_new = cost(s_new, d_new, pb)
            if torch.isfinite(c_new) and c_new < c:
                rel = float((c - c_new) / torch.clamp(c, min=torch.finfo(dt).tiny))
                states, invd, c = s_new, d_new, c_new
                lam = max(lam / 3.0, 1e-12)
                accepted = True
                break
            lam *= 4.0
        its += 1
        if not accepted or rel < rel_tol or float(delta.abs().max()) < 1e-14:
            break
    return Solution(states, invd, float(c), float(c0), its)
