"""Plain reference of the sliding window's marginalization of its oldest
frame.

The problem comes as vio_bench.reference.solve takes it (one problem, no
row axis). Its marginalization prior, its preintegration factors and its
reprojection factors (no robust loss) are linearized at the given states,
taken as they are, by forward-mode differentiation of their whitened
residuals, over every
frame's 15-dim error state and every landmark's inverse depth: the
information H = J^T J and the vector b = J^T r. The landmarks are
eliminated (Schur complement with the pseudo-inverse of their block),
then frame 0 (Schur complement with the pseudo-inverse of its 15 x 15
block). The remaining frames move up by one slot; the last slot is empty.
Returns (H, b), (W * 15) square and long, in the inputs' dtype.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch.func import jacfwd

from vio_bench.reference.solve import ES, _take, exp_q, log_q, preint, qconj, qmul, reproj


def _residuals(states, invd, pb):
    ext, S2 = pb["ext"], pb["sqrt_inv_cov2"]
    rf = pb["reproj"]
    t, r = rf["tgt"].long(), rf["ref"].long()
    d = torch.clamp(invd[rf["lm"].long()], min=1e-12)
    r_v = reproj(states["q"][t], states["p"][t], states["q"][r], states["p"][r], d,
                 rf["z_ref"], rf["z_tgt"], ext, S2)
    im = pb["imu"]
    r_m = preint(_take(states, im["i"]), _take(states, im["j"]), im["delta"],
                 im["sqrt_inv_cov"], im["bg0"], im["ba0"], ext)
    pr = pb["prior"]
    dx = torch.cat([log_q(qmul(qconj(pr["q_lin"]), states["q"])),
                    states["p"] - pr["p_lin"], states["v"] - pr["v_lin"],
                    states["bg"] - pr["bg_lin"], states["ba"] - pr["ba_lin"]], dim=-1)
    r_p = pr["sqrt_inv_cov"] @ dx.reshape(-1) + pr["infovec"]
    on = lambda v: v.to(r_m.dtype)[..., None]  # noqa: E731
    return torch.cat([r_p, (r_m * on(im["valid"])).reshape(-1),
                      (r_v * on(rf["valid"])).reshape(-1)])


def _moved(states, invd, delta, W):
    """The states moved by delta (rotation right-multiplied), taken as
    given at delta = 0."""
    d = delta[: W * ES].reshape(W, ES)
    return {"q": qmul(states["q"], exp_q(d[:, 0:3])), "p": states["p"] + d[:, 3:6],
            "v": states["v"] + d[:, 6:9], "bg": states["bg"] + d[:, 9:12],
            "ba": states["ba"] + d[:, 12:15]}, invd + delta[W * ES:]


def _schur(H, b, k: int, rtol: float):
    """Eliminate the first k variables of (H, b)."""
    Hi = torch.linalg.pinv(H[:k, :k], hermitian=True, rtol=rtol)
    B = H[k:, :k]
    return H[k:, k:] - B @ Hi @ B.T, b[k:] - B @ Hi @ b[:k]


def marginalize(states, invd, pb, rtol: float = 1e-12) -> Tuple[torch.Tensor, torch.Tensor]:
    W, L = states["q"].shape[0], invd.shape[0]
    D = W * ES
    zero = torch.zeros(D + L, dtype=invd.dtype, device=invd.device)

    def res(delta):
        return _residuals(*_moved(states, invd, delta, W), pb)

    J = jacfwd(res)(zero)
    r = res(zero)
    H = J.T @ J
    b = J.T @ r
    # landmarks first (their block is diagonal: one inverse depth each,
    # seen by its own observations only), then frame 0
    perm = torch.cat([torch.arange(D, D + L), torch.arange(D)]).to(invd.device)
    H, b = _schur(H[perm][:, perm], b[perm], L, rtol)
    H, b = _schur(H, b, ES, rtol)
    Hn = torch.zeros((D, D), dtype=H.dtype, device=H.device)
    bn = torch.zeros(D, dtype=H.dtype, device=H.device)
    Hn[:D - ES, :D - ES] = H
    bn[:D - ES] = b
    return Hn, bn


def gap(Hp, bp, H, b) -> float:
    """How far a prior's information Hp and vector bp lie from the
    reference's (H, b), in float64: the larger of the relative (Frobenius)
    error of Hp and the error e = bp - b in standard deviations of the
    reference's prior, sqrt(e^T H^+ e)."""
    f = lambda x: x.to(torch.float64)  # noqa: E731
    Hp, bp, H, b = f(Hp), f(bp), f(H), f(b)
    info = float(torch.linalg.norm(Hp - H) / torch.linalg.norm(H))
    e = bp - b
    vec = float(torch.sqrt(torch.clamp(e @ torch.linalg.pinv(H, hermitian=True, rtol=1e-12) @ e,
                                       min=0.0)))
    return max(info, vec)
