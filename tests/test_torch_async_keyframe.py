"""Port parity of the async keyframe step
(`Config.sliding_window_keyframe_async=True`): the fused keyframe step
dispatched with no blocking fetch, its localize anchor chained from the
previous subwindow solve's device states, its results applied one frame
later through the ordered FIFO of deferred results.

The setup is tests/test_async_keyframe.py's (the JAX package's own test of
the step): `synthetic.generate(duration=5.0, n_landmarks=900,
max_keypoints=120)`, the code-default profile with 128 RANSAC hypotheses and
the async flag, its Caps, the perfect-match synthetic backend. It is
shortened to the first N_FRAMES frames, with tests/test_torch_odometry.py's
window of 4 keyframes, so that the window fills, and the async step
engages, within the frames (with the default window of 10 the JAX run's
first async dispatch comes too late for this test's time budget), and with
tests/test_torch_checkpoint.py's 5 LM iterations per solve (the port's run
to the second async dispatch takes ~50 s on the CPU with the default 10,
~35 s with 5; the two packages dispatch at the same frames either way). The JAX
run comes from the `jax_side` process, or from its stored output
(tests/torch_ref, `jax_ref`); the port's runs in the child, fed the JAX
Initializer's Gumbel noise (tests/test_torch_odometry.py). Both record, per
frame, the state, the published estimate, the async dispatches (calls of
`_keyframe_dispatch_async`), the synchronous fused steps the gate fell
through to, the frames that are keyframes and the window's size.

Checks: the same async dispatches at the same frames, the same synchronous
fall-throughs, the same keyframes, the same first tracked frame and the
same count of estimates; the ATEs within ATE_DIFF_M of each other; the JAX
test's invariants on both (tracking kept after the first tracked frame,
the window at most `sliding_window_size + 1` keyframes after each deferred
slide). The run ends at the frame of the second async dispatch, whose
keyframe apply is then pending: the port's tracker saved there by
`utils/checkpoint.save_tracker` (which drains the FIFO first, as
`Odometry.close()` does) writes the applied states, the keyframe solve's
window states bit for bit, and loads back equal to the drained tracker bit
for bit; `Odometry.close()` then leaves the window's host states equal to
the solve's, nothing pending and the window slid.
"""

import numpy as np

from rd_vio_tpu.config import Config as ConfigJ
from rd_vio_tpu.datasets import synthetic as synth_j
from rd_vio_tpu.models import builders as builders_j
from rd_vio_tpu.models.feature_tracker import SyntheticBackend as SyntheticBackendJ
from rd_vio_tpu.models.odometry import Odometry as OdometryJ
from rd_vio_tpu.utils.trajectory import ate_rmse as ate_rmse_j
from tests.test_torch_image import IN_CHILD, child, jax_ref, jax_side  # noqa: F401
from tests.test_torch_initializer import JaxKeyNoise

if IN_CHILD:  # the port loads only where the checks run (test_torch_image)
    import os

    from rd_vio_tpu_torch import convert
    from rd_vio_tpu_torch.models import builders as builders_t
    from rd_vio_tpu_torch.models.feature_tracker import SyntheticBackend as SyntheticBackendT
    from rd_vio_tpu_torch.models.odometry import Odometry as OdometryT
    from rd_vio_tpu_torch.utils import checkpoint as ck_t
    from rd_vio_tpu_torch.utils.trajectory import ate_rmse

CAPS = dict(W=13, L=256, O=1536, Fi=16, R=128, IMU=64, IMU_KF=384)
WINDOW = 4
ITERATIONS = 5
# the JAX run's second async dispatch is at frame N_FRAMES - 1
N_FRAMES = 43
# tests/test_torch_odometry.py's ATE_DIFF_M (the runs agree to ~2e-7 m here)
ATE_DIFF_M = 0.005


def make_config(K):
    cfg = ConfigJ()
    cfg.camera_intrinsic = K
    cfg.ransac_hypotheses = 128
    cfg.sliding_window_keyframe_async = True
    cfg.sliding_window_size = WINDOW
    cfg.solver_iteration_limit = ITERATIONS
    return cfg


def _seq():
    return synth_j.generate(duration=5.0, n_landmarks=900, max_keypoints=120)


def _events(seq, first, last):
    """bench.py's event order for frames [first, last): the IMU samples up to
    the last frame's time, then no more."""
    t_end = seq.t_frame[last - 1]
    t_start = seq.t_frame[first - 1] if first else -np.inf
    return sorted([(t, 1, i) for i, t in enumerate(seq.t_imu) if t_start < t <= t_end]
                  + [(t, 0, i) for i, t in enumerate(seq.t_frame[first:last], first)])


def run(odo, seq, first, last, rec):
    """Frames [first, last) into `odo`, recording into `rec` (see the module
    docstring); `rec` carries over between calls."""
    index_of = {round(t, 6): k for k, t in enumerate(seq.t_frame)}
    for t, kind, i in _events(seq, first, last):
        if kind == 1:
            odo.add_motion(t, seq.gyro[i], seq.accel[i])
            continue
        odo.add_frame(t, i)
        swt = odo.frontend.swt
        if swt is not None and id(swt) not in rec["hooked"]:
            rec["hooked"].add(id(swt))

            def counted(*a, _orig=swt._keyframe_dispatch_async, **kw):
                rec["dispatch_frames"].append(len(rec["states"]))
                return _orig(*a, **kw)

            swt._keyframe_dispatch_async = counted
        rec["states"].append(odo.state())
        if swt is not None:
            rec["keyframes"].update(index_of[round(f.t, 6)] for f in swt.map.frames)
            rec["frame_num"].append(swt.map.frame_num)
        if rec["states"][-1] == 1:
            ls = odo.handler.get_latest_state()
            if ls is not None and (not rec["est_t"] or ls[0] != rec["est_t"][-1]):
                rec["est_t"].append(ls[0])
                rec["est_p"].append(np.array(ls[2]))


def _new_rec():
    return dict(hooked=set(), dispatch_frames=[], states=[], keyframes=set(), frame_num=[],
                est_t=[], est_p=[])


def _summary(rec, seq, kf_fused, ate_fn):
    """What the checks compare, as plain values."""
    gt_by_t = {round(t, 6): p for t, p in zip(seq.t_frame, seq.p_wb)}
    est_p = np.asarray(rec["est_p"])
    ate = float(ate_fn(est_p, np.stack([gt_by_t[round(t, 6)] for t in rec["est_t"]])))
    index_of = {round(t, 6): k for k, t in enumerate(seq.t_frame)}
    # the window after each deferred slide: at the frame after a dispatch
    first = len(rec["states"]) - len(rec["frame_num"])  # the tracker's first frame
    after = [rec["frame_num"][k + 1 - first] for k in rec["dispatch_frames"]
             if k + 1 < len(rec["states"])]
    return dict(states=list(rec["states"]), dispatch_frames=list(rec["dispatch_frames"]),
                sync_fused=kf_fused - len(rec["dispatch_frames"]),
                keyframes=sorted(rec["keyframes"]), frame_num_after_slides=after,
                first_tracked=index_of[round(rec["est_t"][0], 6)], n_est=len(est_p),
                finite=bool(np.isfinite(est_p).all()), ate=ate)


def _jax_run():
    seq = _seq()
    cfg = make_config(seq.K_mat)
    odo = OdometryJ(cfg, SyntheticBackendJ(seq), caps=builders_j.Caps(**CAPS))
    builders_j.KF_FUSED_COUNT.n = 0
    rec = _new_rec()
    run(odo, seq, 0, N_FRAMES, rec)
    return _summary(rec, seq, builders_j.KF_FUSED_COUNT.n, ate_rmse_j)


def _window_equals_solve(swt, tree, slot_of, what):
    """The host states of the window's frames still in the map equal the
    keyframe solve's fetched window states (tree[:5]) bit for bit."""
    by_id = {f.id: f for f in swt.map.frames}
    left = [fid for fid in slot_of if fid in by_id]
    assert left, what
    for fid in left:
        f, i = by_id[fid], slot_of[fid]
        for k, name in enumerate(("q", "p", "v", "bg", "ba")):
            np.testing.assert_array_equal(np.asarray(getattr(f, name)), tree[k][i],
                                          err_msg=f"{what}: frame {fid} {name}")


def _pending_keyframe(swt, what):
    """The pending keyframe apply's fetched results (not applied yet) and
    the solve's window slots."""
    assert swt._pending_subs and swt._pending_subs[-1][2], f"{what}: no keyframe apply pending"
    return swt._pending_subs[-1][0].wait(), dict(swt._dev_sub[1])


def _port_run(tmp):
    """The port's run (see the module docstring) and its checkpoint and
    close() checks; returns its summary."""
    seq = _seq()
    cfg = convert.config_from(make_config(seq.K_mat))
    odo = OdometryT(cfg, SyntheticBackendT(seq), caps=builders_t.Caps(**CAPS), device="cpu",
                    init_noise=lambda: JaxKeyNoise(cfg.random))
    builders_t.KF_FUSED_COUNT.n = 0
    rec = _new_rec()
    run(odo, seq, 0, N_FRAMES, rec)
    out = _summary(rec, seq, builders_t.KF_FUSED_COUNT.n, ate_rmse)

    # the checkpoint of a tracker with a keyframe apply pending
    swt = odo.frontend.swt
    tree, slot_of = _pending_keyframe(swt, "at the second async dispatch")
    path = os.path.join(tmp, "async.npz")
    ck_t.save_tracker(path, swt)
    assert not swt._pending_subs
    saved = dict(np.load(path, allow_pickle=True))
    drained = ck_t.tracker_state(swt)
    loaded = ck_t.tracker_state(ck_t.load_tracker(path, cfg, odo.calib, odo.caps))
    assert set(saved) == set(drained) == set(loaded)
    for k in saved:
        for other, what in ((drained, "the drained tracker"), (loaded, "the loaded tracker")):
            x, y = np.asarray(saved[k]), np.asarray(other[k])
            if x.dtype == object:
                assert x.tolist() == y.tolist(), (what, k)
            else:
                np.testing.assert_array_equal(x, y, err_msg=f"{what}: {k}")
    _window_equals_solve(swt, tree, slot_of, "the saved tracker")
    odo.close()
    assert not swt._pending_subs
    _window_equals_solve(swt, tree, slot_of, "after close()")
    out["frame_num_after_slides"].append(swt.map.frame_num)
    return out


def _check(port, want):
    init = want["states"].index(1)
    for got in (port, want):  # the JAX test's invariants, on both
        assert all(s == 1 for s in got["states"][got["states"].index(1):]), "tracking lost"
        assert max(got["frame_num_after_slides"]) <= WINDOW + 1, got["frame_num_after_slides"]
        assert got["finite"]
    assert len(want["dispatch_frames"]) == 2 and want["dispatch_frames"][-1] == N_FRAMES - 1
    assert port["dispatch_frames"] == want["dispatch_frames"]
    assert port["sync_fused"] == want["sync_fused"]
    assert port["keyframes"] == want["keyframes"]
    assert port["states"].index(1) == init
    assert port["first_tracked"] == want["first_tracked"]
    assert port["n_est"] == want["n_est"]
    assert abs(port["ate"] - want["ate"]) <= ATE_DIFF_M, (port["ate"], want["ate"])


def test_async_keyframe_matches_jax(child, jax_side, tmp_path):
    seq = _seq()
    want = jax_ref(jax_side, "async_keyframe", (seq, make_config(seq.K_mat), CAPS, N_FRAMES),
                   _jax_run)
    _check(child(_port_run, str(tmp_path)), want())
