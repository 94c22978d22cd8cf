"""Port parity of the slice as a whole: `Odometry` with the perfect-match
synthetic backend on the CPU.

The JAX package's Odometry runs in a spawned process that keeps the
persistent compilation cache (`jax_side`, tests/test_torch_image.py; with
tests/test_e2e_synthetic.py's Caps and profile, so it runs that test's
programs), and the port's in the spawned child, over the same short `synthetic.generate` sequence with the same
config: a window of 4 keyframes (so the window slides and marginalizes from
the first keyframe after the initialization on) and PARSAC on. Everything
random is shared: the feature tracker's mask RANSAC and PARSAC draw from the
same host seeds in both packages, and the port's Initializer is fed the
Gumbel noise of the JAX Initializer's key chain.
"""

import numpy as np

from rd_vio_tpu.config import Config as ConfigJ
from rd_vio_tpu.datasets import synthetic as synth_j
from rd_vio_tpu.models import builders as builders_j
from rd_vio_tpu.models.feature_tracker import SyntheticBackend as SyntheticBackendJ
from rd_vio_tpu.models.odometry import Odometry as OdometryJ
from rd_vio_tpu.utils.trajectory import ate_rmse as ate_rmse_j
from tests.test_torch_image import IN_CHILD, child, jax_side  # noqa: F401
from tests.test_torch_initializer import JaxKeyNoise

if IN_CHILD:  # the port loads only where the checks run (test_torch_image)
    from rd_vio_tpu_torch import convert
    from rd_vio_tpu_torch.models import builders as builders_t
    from rd_vio_tpu_torch.models.feature_tracker import SyntheticBackend as SyntheticBackendT
    from rd_vio_tpu_torch.models.odometry import Odometry as OdometryT
    from rd_vio_tpu_torch.utils.trajectory import ate_rmse

CAPS = dict(W=13, L=256, O=1536, Fi=16, R=128, IMU=64, IMU_KF=384)
DURATION_S = 2.3
ATE_BOUND_M = 0.05  # tests/test_e2e_synthetic.py's bound
ATE_DIFF_M = 0.005


def make_config(K):
    cfg = ConfigJ()
    cfg.camera_intrinsic = K
    cfg.sliding_window_size = 4
    cfg.parsac_flag = True
    cfg.parsac_dynamic_probability = 0.15
    cfg.parsac_threshold = 1.0
    cfg.ransac_hypotheses = 128
    return cfg


def run(odo, seq, caps_mod):
    """bench.py's event order; per frame the state, and once tracking the
    latest state's (t, p) as bench.py collects them. Returns (states, est_t,
    est_p, keyframe steps)."""
    caps_mod.KF_FUSED_COUNT.n = 0
    events = sorted([(t, 1, i) for i, t in enumerate(seq.t_imu)]
                    + [(t, 0, i) for i, t in enumerate(seq.t_frame)])
    states, est_t, est_p = [], [], []
    for t, kind, i in events:
        if kind == 1:
            odo.add_motion(t, seq.gyro[i], seq.accel[i])
            continue
        odo.add_frame(t, i)
        states.append(odo.state())
        if states[-1] == 1:
            ls = odo.handler.get_latest_state()
            if ls is not None and (not est_t or ls[0] != est_t[-1]):
                est_t.append(ls[0])
                est_p.append(ls[2])
    return states, np.asarray(est_t), np.asarray(est_p), caps_mod.KF_FUSED_COUNT.n


def _ate(seq, est_t, est_p, fn):
    gt_by_t = {round(t, 6): p for t, p in zip(seq.t_frame, seq.p_wb)}
    return float(fn(est_p, np.stack([gt_by_t[round(t, 6)] for t in est_t])))


def _seq():
    return synth_j.generate(duration=DURATION_S, n_landmarks=1200, max_keypoints=150,
                            seed=648)


def _check_port(cfg_j, want):
    """The same initialization frame within 2, the same count of tracked
    frames within 2, the fused keyframe step reached, finite estimates, and
    the ATEs within ATE_DIFF_M of each other and both under ATE_BOUND_M."""
    seq = _seq()
    cfg = convert.config_from(cfg_j)
    odo = OdometryT(cfg, SyntheticBackendT(seq), caps=builders_t.Caps(**CAPS), device="cpu",
                    init_noise=lambda: JaxKeyNoise(cfg.random))
    states, est_t, est_p, n_kf = run(odo, seq, builders_t)
    assert 1 in states, "the port never initialized"
    init = states.index(1)
    assert abs(init - want["init"]) <= 2, (init, want["init"])
    assert all(s == 1 for s in states[init:]), "the port lost tracking"
    assert abs(len(est_p) - want["tracked"]) <= 2, (len(est_p), want["tracked"])
    assert n_kf >= 1 and np.isfinite(est_p).all()
    ate = _ate(seq, est_t, est_p, ate_rmse)
    assert ate < ATE_BOUND_M and want["ate"] < ATE_BOUND_M, (ate, want["ate"])
    assert abs(ate - want["ate"]) <= ATE_DIFF_M, (ate, want["ate"])


def _jax_run():
    seq = _seq()
    cfg = make_config(seq.K_mat)
    odo = OdometryJ(cfg, SyntheticBackendJ(seq), caps=builders_j.Caps(**CAPS))
    states, est_t, est_p, n_kf = run(odo, seq, builders_j)
    assert 1 in states and n_kf >= 1, (states, n_kf)
    return cfg, dict(init=states.index(1), tracked=len(est_p),
                     ate=_ate(seq, est_t, est_p, ate_rmse_j))


def test_odometry_matches_jax(child, jax_side):
    child(_check_port, *jax_side(_jax_run))
