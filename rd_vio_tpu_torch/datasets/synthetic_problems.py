"""Build BA window problems from synthetic sequences (tests, chip_smoke.py).

Port of the JAX package's datasets/synthetic_problems.py. The landmark table
and observations are assembled on the host with NumPy; the IMU factors are
integrated on `device` with the port's `preintegration.integrate`.
"""

from __future__ import annotations

import numpy as np
import torch

from rd_vio_tpu_torch.datasets import synthetic
from rd_vio_tpu_torch.estimation import ba, factors as F
from rd_vio_tpu_torch.estimation.state import FrameStates, retract
from rd_vio_tpu_torch.ops import preintegration as pre


def identity_ext(dtype=torch.float64, device="cuda") -> F.Extrinsics:
    unit_w = torch.tensor([1.0, 0, 0, 0], dtype=dtype, device=device)
    return F.Extrinsics(q_bc=unit_w, p_bc=torch.zeros(3, dtype=dtype, device=device),
                        q_bi=unit_w.clone(), p_bi=torch.zeros(3, dtype=dtype, device=device))


def build_window_problem(
    seq: synthetic.SyntheticSequence,
    f0: int,
    W: int,
    L_max: int = 256,
    O_max: int = 2048,
    sigma_px: float = 0.7,
    dtype=torch.float64,
    device="cuda",
):
    """Build (states_gt, inv_depth_gt, BAProblem, n_tracks, n_obs) for frames
    [f0, f0+W). As in the JAX package, the IMU factors, the prior and the
    extrinsics are f64 whatever `dtype` says."""
    t = lambda a, dt=dtype: torch.as_tensor(np.asarray(a), dtype=dt, device=device)  # noqa: E731
    Km = seq.K_mat
    frames = list(range(f0, f0 + W))

    # ground-truth states
    states = FrameStates(
        q=t(seq.q_wb[frames]), p=t(seq.p_wb[frames]), v=t(seq.v_wb[frames]),
        bg=t(np.zeros((W, 3))), ba=t(np.zeros((W, 3))),
    )

    # landmark table: ids seen in >= 2 frames of the window
    seen = {}
    for wi, f in enumerate(frames):
        for k in range(seq.kp_id.shape[1]):
            lid = seq.kp_id[f, k]
            if lid < 0:
                continue
            seen.setdefault(lid, []).append((wi, k))
    track_ids = [lid for lid, obs in seen.items() if len(obs) >= 2][:L_max]

    def bearing(f, k):
        pix = seq.kp_pixel[f, k]
        b = np.array([(pix[0] - Km[0, 2]) / Km[0, 0], (pix[1] - Km[1, 2]) / Km[1, 1], 1.0])
        return b / np.linalg.norm(b)

    inv_depth = np.ones(L_max)
    obs_tgt, obs_ref, obs_lm, z_ref, z_tgt = [], [], [], [], []
    for li, lid in enumerate(track_ids):
        obs = seen[lid]
        wi_ref, k_ref = obs[0]
        f_ref = frames[wi_ref]
        b_ref = bearing(f_ref, k_ref)
        # gt inverse depth along the anchor bearing
        Rr = np.asarray(synthetic._quat_to_R(seq.q_wb[f_ref]))
        x_cam = Rr.T @ (seq.landmarks[lid] - seq.p_wb[f_ref])
        inv_depth[li] = 1.0 / np.linalg.norm(x_cam)
        for wi, k in obs[1:]:
            obs_tgt.append(wi)
            obs_ref.append(wi_ref)
            obs_lm.append(li)
            z_ref.append(b_ref)
            z_tgt.append(bearing(frames[wi], k))

    O = len(obs_tgt)
    assert O <= O_max, (O, O_max)
    tgt_a = np.zeros(O_max, np.int32)
    ref_a = np.zeros(O_max, np.int32)
    lm_a = np.zeros(O_max, np.int32)
    zr_a = np.tile([0.0, 0.0, 1.0], (O_max, 1))  # unit-z padding avoids 0-div
    zt_a = np.tile([0.0, 0.0, 1.0], (O_max, 1))
    tgt_a[:O], ref_a[:O], lm_a[:O] = obs_tgt, obs_ref, obs_lm
    if O:
        zr_a[:O] = np.asarray(z_ref)
        zt_a[:O] = np.asarray(z_tgt)
    reproj = F.ReprojFactors(
        tgt=t(tgt_a, torch.int32), ref=t(ref_a, torch.int32), lm=t(lm_a, torch.int32),
        z_ref=t(zr_a), z_tgt=t(zt_a), valid=t(np.arange(O_max) < O, torch.bool),
    )

    # IMU factors between consecutive frames, integrated on the device in f64
    f64 = lambda a: t(a, torch.float64)  # noqa: E731
    covs = [f64(np.eye(3) * c) for c in [2.9e-8, 4e-6, 3.8e-10, 9e-6]]
    zero3 = f64(np.zeros(3))
    eye15 = f64(np.eye(15))
    deltas, sics = [], []
    for wi in range(W - 1):
        t0, t1 = seq.t_frame[frames[wi]], seq.t_frame[frames[wi + 1]]
        m = (seq.t_imu >= t0 - 1e-9) & (seq.t_imu < t1 - 1e-9)
        ts = seq.t_imu[m]
        dts = np.diff(np.concatenate([ts, [t1]]))
        d = pre.integrate(f64(dts), f64(seq.gyro[m]), f64(seq.accel[m]), zero3, zero3, *covs)
        deltas.append(d)
        sics.append(pre.sqrt_inv_cov(d.cov + 1e-14 * eye15))
    imu = F.ImuFactors(
        i=t(np.arange(W - 1), torch.int32),
        j=t(np.arange(1, W), torch.int32),
        delta=pre.PreintDelta(*(torch.stack(xs) for xs in zip(*deltas))),
        sqrt_inv_cov=torch.stack(sics),
        bg0=t(np.zeros((W - 1, 3))),
        ba0=t(np.zeros((W - 1, 3))),
        valid=t(np.ones(W - 1, bool), torch.bool),
    )

    rot = F.RotFactors(
        tgt=t(np.zeros(1), torch.int32),
        q_ref=t([[1.0, 0, 0, 0]]),
        z_ref=t([[0.0, 0, 1]]),
        z_tgt=t([[0.0, 0, 1]]),
        valid=t(np.zeros(1, bool), torch.bool),
    )

    sic2 = t(np.diag([Km[0, 0] / sigma_px, Km[1, 1] / sigma_px]))
    pb = ba.BAProblem(
        reproj=reproj, reproj_prior=F.empty_reproj_prior(device=device), imu=imu,
        imu_prior=F.empty_imu_prior(device=device), rot=rot,
        prior=F.initial_prior(W, states),
        prior_valid=t(True, torch.bool),
        ext=identity_ext(device=device), sqrt_inv_cov2=sic2,
        opt_pose=t(np.ones(W, bool), torch.bool), opt_motion=t(np.ones(W, bool), torch.bool),
        opt_lm=t(np.arange(L_max) < len(track_ids), torch.bool),
    )
    return states, t(inv_depth), pb, len(track_ids), O


def perturbed_start(states: FrameStates, inv_depth, pb: ba.BAProblem, seed: int = 7):
    """A solver's start away from the ground truth, with frame 0 held fixed
    (the gauge), by the recipe of the JAX package's tests/test_ba.py: from a
    seeded NumPy generator, rotations 0.02, positions 0.05 and velocities
    0.05 (standard deviations) on frames 1.., and inverse depths x (1 +
    0.2 N(0, 1)) floored at 1e-3. Returns (states0, inv_depth0, pb)."""
    W = states.q.shape[0]
    rng = np.random.default_rng(seed)
    d = np.zeros((W, 15))
    d[1:, 0:3] = rng.standard_normal((W - 1, 3)) * 0.02
    d[1:, 3:6] = rng.standard_normal((W - 1, 3)) * 0.05
    d[1:, 6:9] = rng.standard_normal((W - 1, 3)) * 0.05
    noise = rng.standard_normal(inv_depth.shape) * pb.opt_lm.cpu().numpy()
    to = lambda a: torch.as_tensor(a, dtype=inv_depth.dtype, device=inv_depth.device)  # noqa: E731
    states0 = retract(states, to(d))
    inv_depth0 = torch.clamp(inv_depth * (1.0 + 0.2 * to(noise)), min=1e-3)
    free = torch.arange(W, device=pb.opt_pose.device) > 0
    return states0, inv_depth0, pb._replace(opt_pose=free, opt_motion=free.clone())


def _rotvec(w):
    """Rotation matrix of a rotation vector (Rodrigues), NumPy."""
    th = float(np.linalg.norm(w))
    k = np.asarray(w, float) / max(th, 1e-300)
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K


def pnp_scene(seed: int, n: int = 128, outliers: float = 0.2, invalid: float = 0.1,
              dynamic: float = 0.0, noise: float = 2e-4):
    """A PnP / IMU-PARSAC problem as the tracker's judge builds it, NumPy f64:
    world points seen by a camera at a known pose, their normalized
    observations with `noise`, a share of mismatches (`outliers`), invalid
    (zero) slots and track lengths. A share `dynamic` of the points moves
    with an object: those are seen at another pose.

    Returns dict(x_world (n, 3), p_norm (n, 2), valid (n,), lens (n,),
    R_cw, t_cw (the static pose), dynamic (n,) bool)."""
    rng = np.random.default_rng(seed)
    X = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n), rng.uniform(4, 12, n)], -1)
    R = _rotvec([0.03, -0.05, 0.02])
    t = np.array([0.2, -0.1, 0.3])
    dyn = rng.uniform(size=n) < dynamic
    x_cam = X @ R.T + t
    x_cam[dyn] = X[dyn] @ _rotvec([0.0, 0.2, 0.0]).T + np.array([1.5, 0.0, 0.5])
    p = x_cam[:, :2] / x_cam[:, 2:] + rng.normal(0, noise, (n, 2))
    bad = rng.uniform(size=n) < outliers
    p[bad] += rng.normal(0, 0.05, (int(bad.sum()), 2))
    valid = rng.uniform(size=n) > invalid
    X[~valid], p[~valid] = 0.0, 0.0
    lens = np.where(valid, rng.integers(1, 30, n), 0).astype(np.float64)
    return dict(x_world=X, p_norm=p, valid=valid, lens=lens, R_cw=R, t_cw=t, dynamic=dyn)
