"""Plain reference of IMU preintegration between two frame times, from a
sequence's raw IMU samples.

The signal is held from each sample until the next (zero-order hold): the
interval (t_i, t_j] starts with the latest sample at or before t_i, and
every later sample before t_j starts a segment of its own. Over a segment
of length dt with gyro w and accelerometer a, at the bias linearization
point (bg, ba):

    p <- p + dt v + dt^2 / 2 R(q) (a - ba)
    v <- v + dt R(q) (a - ba)
    q <- q exp((w - bg) dt)

from q = identity, p = v = 0. The bias Jacobians are the derivatives of
the result by the biases (rotation in the right tangent: q(bg + d) =
q(bg) exp(dq_dbg d)), taken by reverse-mode differentiation. The
covariance of (rotation, position, velocity) is the first-order
propagation of white sample noise, the gyro's and the accelerometer's
covariances over dt on every segment (J Q J^T, J again by reverse mode);
the bias blocks grow by their random-walk covariances times the
interval's length and are uncorrelated with the rest.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch.func import jacrev

from vio_bench.reference.solve import exp_q, log_q, qconj, qmul, rot

TOL = 1e-9  # s: a sample this close to a frame time is at the frame time


def segments(t_imu: np.ndarray, t_i: float, t_j: float):
    """(dt, sample index) of each held segment of (t_i, t_j], and the
    first and last index of the samples that the interval reads (the
    last one at t_j, where a sample falls there, is held for no time)."""
    first = int(np.searchsorted(t_imu, t_i + TOL, side="right")) - 1
    if first < 0:
        raise ValueError(f"no IMU sample at or before {t_i}")
    starts = [t_i]
    idx = [first]
    c = first + 1
    while c < len(t_imu) and t_imu[c] < t_j - TOL:
        starts.append(float(t_imu[c]))
        idx.append(c)
        c += 1
    last = c if c < len(t_imu) and abs(t_imu[c] - t_j) <= TOL else c - 1
    return np.diff(np.array(starts + [t_j])), np.array(idx), (first, last)


def _mean(dt, w, a, bg, ba):
    q = torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=dt.dtype, device=dt.device)
    p = torch.zeros(3, dtype=dt.dtype, device=dt.device)
    v = torch.zeros(3, dtype=dt.dtype, device=dt.device)
    for m in range(dt.shape[0]):
        acc = rot(q, a[m] - ba)
        p = p + dt[m] * v + 0.5 * dt[m] * dt[m] * acc
        v = v + dt[m] * acc
        q = qmul(q, exp_q((w[m] - bg) * dt[m]))
        q = q / torch.linalg.vector_norm(q)
    return q, p, v


def integrate(dt, w, a, bg, ba, cov_w, cov_a, cov_bg, cov_ba) -> Dict[str, torch.Tensor]:
    """The delta of one interval in the dtype and device of the inputs:
    t, q, p, v, cov (15 x 15: rotation, position, velocity, bg, ba) and
    the bias Jacobians dq_dbg, dp_dbg, dp_dba, dv_dbg, dv_dba."""
    n = dt.shape[0]
    q0, p0, v0 = _mean(dt, w, a, bg, ba)

    def tangent(x):
        nz = x[:6 * n].reshape(n, 6)
        db = x[6 * n:]
        q, p, v = _mean(dt, w + nz[:, :3], a + nz[:, 3:], bg + db[:3], ba + db[3:])
        return torch.cat([log_q(qmul(qconj(q0), q)), p, v])

    J = jacrev(tangent)(torch.zeros(6 * n + 6, dtype=dt.dtype, device=dt.device))
    Jn = J[:, :6 * n].reshape(9, n, 6)
    Jb = J[:, 6 * n:]
    Q = torch.zeros((n, 6, 6), dtype=dt.dtype, device=dt.device)
    Q[:, :3, :3] = cov_w[None] / dt[:, None, None]
    Q[:, 3:, 3:] = cov_a[None] / dt[:, None, None]
    cov9 = torch.einsum("inj,njk,lnk->il", Jn, Q, Jn)
    T = dt.sum()
    cov = torch.zeros((15, 15), dtype=dt.dtype, device=dt.device)
    cov[:9, :9] = cov9
    cov[9:12, 9:12] = cov_bg * T
    cov[12:15, 12:15] = cov_ba * T
    return {"t": T, "q": q0, "p": p0, "v": v0, "cov": cov,
            "dq_dbg": Jb[0:3, 0:3], "dp_dbg": Jb[3:6, 0:3], "dp_dba": Jb[3:6, 3:6],
            "dv_dbg": Jb[6:9, 0:3], "dv_dba": Jb[6:9, 3:6]}


def inv_sqrt(cov: torch.Tensor) -> torch.Tensor:
    """S with S cov S^T = I (on cov's range)."""
    lam, V = torch.linalg.eigh(0.5 * (cov + cov.T))
    keep = lam > lam.max() * torch.finfo(cov.dtype).eps * cov.shape[0]
    return (torch.where(keep, 1.0 / torch.sqrt(torch.clamp(lam, min=1e-300)), 0.0)[:, None]
            * V.T)


def gap(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """How far a delta (`prog`) lies from the reference's, all in float64:
    `mean` the largest error of its rotation, position and velocity in
    standard deviations of the reference's own covariance; `jac` the
    largest relative (Frobenius) error of a bias Jacobian; `cov` the
    largest entry of S (C - C_ref) S^T, C the delta's covariance and S the
    square-root inverse of the reference's C_ref (the error of C in units
    of C_ref)."""
    f = lambda x: torch.as_tensor(x, dtype=torch.float64).cpu()  # noqa: E731
    P = {k: f(v) for k, v in prog.items()}
    R = {k: f(v) for k, v in ref.items()}
    err = torch.zeros(15, dtype=torch.float64)
    err[0:3] = log_q(qmul(qconj(R["q"]), P["q"]))
    err[3:6] = P["p"] - R["p"]
    err[6:9] = P["v"] - R["v"]
    S = inv_sqrt(R["cov"])
    mean = float((S @ err).abs().max())
    jac = max(float(torch.linalg.norm(P[k] - R[k]) / torch.clamp(torch.linalg.norm(R[k]),
                                                                   min=1e-300))
              for k in ("dq_dbg", "dp_dbg", "dp_dba", "dv_dbg", "dv_dba"))
    cov = float((S @ (P["cov"] - R["cov"]) @ S.T).abs().max())
    return {"mean": mean, "jac": jac, "cov": cov}
