"""Port parity of the slice as a whole: `Odometry` with the perfect-match
synthetic backend on the CPU, synchronous and threaded.

The JAX package's Odometry runs in a spawned process that keeps the
persistent compilation cache (`jax_side`, tests/test_torch_image.py; with
tests/test_e2e_synthetic.py's Caps and profile, so it runs that test's
programs), and the port's in the spawned child at the same time, over the
same short `synthetic.generate` sequence with the same config: a window of 4 keyframes (so the window slides and marginalizes from
the first keyframe after the initialization on) and PARSAC on. Everything
random is shared: the feature tracker's mask RANSAC and PARSAC draw from the
same host seeds in both packages, and the port's Initializer is fed the
Gumbel noise of the JAX Initializer's key chain.

The threaded check runs the JAX package synchronously with the device
PARSAC (`parsac_host_masks=False`) and the port threaded with its device
PARSAC, fed the JAX sliding-window tracker's key chain (`JaxSwtNoise`). A
threaded frontend skips frames while it initializes (Frontend.run takes the
oldest pending frame and drops the rest), so it may start tracking a few
frames later; from then on every frame is estimated. A last check makes the
tracker worker fail and holds the pipeline to surfacing that error.
"""

import numpy as np
import jax
import jax.numpy as jnp

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
# the threaded port against the synchronous JAX run
THREADED_ATE_DIFF_M = 0.01
THREADED_INIT_FRAMES = 4  # first tracked frames (the first estimate's) within 4


class JaxSwtNoise:
    """The Gumbel noise of the JAX sliding-window tracker's key chain,
    rooted in PRNGKey(seed): one split per device-PARSAC call; a chain of K
    checks splits that key again into K, one (H, N) draw each, as its scan
    does."""

    def __init__(self, seed):
        self.key = jax.random.PRNGKey(seed)

    def __call__(self, shape):
        self.key, sub = jax.random.split(self.key)
        if len(shape) == 3:
            return np.stack([np.array(jax.random.gumbel(k, shape[1:], jnp.float32))
                             for k in jax.random.split(sub, shape[0])])
        return np.array(jax.random.gumbel(sub, shape, jnp.float32))


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


def _port_run():
    """The port's synchronous run over the JAX run's sequence and config
    (make_config)."""
    seq = _seq()
    cfg = convert.config_from(make_config(seq.K_mat))
    odo = OdometryT(cfg, SyntheticBackendT(seq), caps=builders_t.Caps(**CAPS), device="cpu",
                    init_noise=lambda: JaxKeyNoise(cfg.random))
    return run(odo, seq, builders_t)


def _check_port(port, cfg_j, want):
    """The same initialization frame within 2, the same count of tracked
    frames within 2, the fused keyframe step reached, finite estimates, and
    the ATEs within ATE_DIFF_M of each other and both under ATE_BOUND_M."""
    seq = _seq()
    states, est_t, est_p, n_kf = port
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
    want = jax_side.submit(_jax_run)  # the JAX run goes on while the port's runs
    child(_check_port, child(_port_run), *want())


def _jax_run_device_parsac():
    """The JAX run with the device PARSAC; in a `jax_side` process that ran
    `_jax_run` it reuses that run's compiled programs but the two PARSAC
    ones."""
    seq = _seq()
    cfg = make_config(seq.K_mat)
    cfg.parsac_host_masks = False
    odo = OdometryJ(cfg, SyntheticBackendJ(seq), caps=builders_j.Caps(**CAPS))
    states, est_t, est_p, n_kf = run(odo, seq, builders_j)
    assert 1 in states and n_kf >= 1, (states, n_kf)
    first = int(np.flatnonzero(np.isclose(seq.t_frame, est_t[0]))[0])
    return cfg, dict(first=first, tracked=len(est_p), ate=_ate(seq, est_t, est_p, ate_rmse_j))


def _port_run_threaded():
    """The port's threaded run with the device PARSAC: the published
    (t, p), once no worker failed, the latest state is the last frame's,
    the device judge ran and both worker threads exited on close()."""
    seq = _seq()
    cfg_j = make_config(seq.K_mat)
    cfg_j.parsac_host_masks = False
    cfg = convert.config_from(cfg_j)
    odo = OdometryT(cfg, SyntheticBackendT(seq), caps=builders_t.Caps(**CAPS), device="cpu",
                    threaded=True, init_noise=lambda: JaxKeyNoise(cfg.random),
                    swt_noise=lambda: JaxSwtNoise(cfg.random))
    published = []
    odo.frontend.on_publish = lambda lo: published.append((lo[0], lo[3].copy()))
    from rd_vio_tpu_torch.models import sliding_window_tracker as swt_t

    judged = swt_t.PARSAC_STATS["judge"]
    try:
        events = sorted([(t, 1, i) for i, t in enumerate(seq.t_imu)]
                        + [(t, 0, i) for i, t in enumerate(seq.t_frame)])
        for t, kind, i in events:
            if kind == 1:
                odo.add_motion(t, seq.gyro[i], seq.accel[i])
            else:
                odo.add_frame(t, i)
        odo.join()
        assert odo.healthy()
        assert odo.handler.get_latest_state()[0] == seq.t_frame[-1]
    finally:
        odo.close()
    assert swt_t.PARSAC_STATS["judge"] > judged, "the device judge never ran"
    assert not odo.handler._ft_worker.is_alive() and not odo.handler._fe_worker.is_alive()
    return published


def _check_port_threaded(published, cfg_j, want):
    """Threaded, device PARSAC: the first tracked frame within
    THREADED_INIT_FRAMES of JAX's, every later frame estimated, the ATEs
    within THREADED_ATE_DIFF_M of each other and both under ATE_BOUND_M."""
    seq = _seq()
    assert not cfg_j.parsac_host_masks
    assert published, "the port never initialized"
    est_t = np.array([t for t, _ in published])
    first = int(np.flatnonzero(np.isclose(seq.t_frame, est_t[0]))[0])
    assert abs(first - want["first"]) <= THREADED_INIT_FRAMES, (first, want["first"])
    np.testing.assert_array_equal(est_t, seq.t_frame[first:])  # every frame after it
    est_p = np.stack([p for _, p in published])
    assert np.isfinite(est_p).all()
    ate = _ate(seq, est_t, est_p, ate_rmse)
    assert ate < ATE_BOUND_M and want["ate"] < ATE_BOUND_M, (ate, want["ate"])
    assert abs(ate - want["ate"]) <= THREADED_ATE_DIFF_M, (ate, want["ate"])


def test_threaded_device_parsac_matches_jax(child, jax_side):
    want = jax_side.submit(_jax_run_device_parsac)
    child(_check_port_threaded, child(_port_run_threaded), *want())


def _check_worker_failure():
    """The tracker worker raises on its FAIL_AT-th frame: join() raises a
    RuntimeError chained from that error, close() raises it again within
    15 s, and both worker threads have exited."""
    import time

    seq = _seq()
    cfg = convert.config_from(make_config(seq.K_mat))

    class Failing(Exception):
        pass

    class FailingBackend(SyntheticBackendT):
        calls = 0

        def track(self, *a):
            FailingBackend.calls += 1
            if FailingBackend.calls == 3:
                raise Failing("frame 3")
            return super().track(*a)

    odo = OdometryT(cfg, FailingBackend(seq), caps=builders_t.Caps(**CAPS), device="cpu",
                    threaded=True)
    t_last = seq.t_frame[6]
    events = sorted([(t, 1, i) for i, t in enumerate(seq.t_imu) if t <= t_last + 0.02]
                    + [(t, 0, i) for i, t in enumerate(seq.t_frame[:7])])
    for t, kind, i in events:
        if kind == 1:
            odo.add_motion(t, seq.gyro[i], seq.accel[i])
        else:
            odo.add_frame(t, i)
    try:
        odo.join()
    except RuntimeError as e:
        assert isinstance(e.__cause__, Failing), repr(e.__cause__)
    else:
        raise AssertionError("join() did not raise the worker's error")
    assert not odo.healthy()
    t0 = time.perf_counter()
    try:
        odo.close()
    except RuntimeError as e:
        assert isinstance(e.__cause__, Failing)
    else:
        raise AssertionError("close() did not raise the worker's error")
    assert time.perf_counter() - t0 < 15
    assert not odo.handler._ft_worker.is_alive() and not odo.handler._fe_worker.is_alive()


def test_threaded_worker_failure_surfaces(child):
    child(_check_worker_failure)
