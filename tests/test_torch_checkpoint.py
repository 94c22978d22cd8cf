"""Port parity of the tracker checkpoint (rd_vio_tpu_torch/utils/checkpoint.py)
and of the sliding-window tracker's sharded branch (`dist_mesh`).

One short run of the port's Odometry on the CPU with bench.py phase 2's
perfect-match synthetic backend (1.6 s of `synthetic.generate`, a window of
4 keyframes, an initializer of 4 keyframes 4 frames apart so that it
bootstraps early, 5 LM iterations per solve, tests/test_torch_builders.py's
Caps, the device PARSAC so that the checkpoint carries a generator state;
the run is the port's alone, so its settings serve the time budget) stops
at the first frame after a keyframe step whose tracker holds a
marginalization prior. From its tracker:
- (c) the checkpoint round-trips: the file of a tracker loaded from the
  file equals the file bit for bit, key for key, and so does the live
  tracker's state; the restored tracker and the original then take the
  run's next frame (the same mirrored frame, the same feature-tracking map)
  and their states after it are equal bit for bit (track ids compared by
  their order, since new tracks draw ids from a process-wide counter);
- (d) the port's file loads in the JAX package's `load_tracker`; the JAX
  package's `save_tracker` of that tracker writes a subset of the port's
  keys (the port adds its generator state), the port's `rng_key` is the JAX
  package's PRNGKey(config.random), and the JAX file loads back into the
  port with every array of every JAX key equal to the original's;
- (e) a restored copy with `dist_mesh` set to a group of 4 gloo ranks on
  the CPU runs `refine_window` sharded, and its window states agree within
  1e-8 with `build_problem` + `ba.solve_ba` of the same spec on a second
  restored copy (f64, the same LM iterations on every rank), after which the
  landmark validation ran.
The checks share the run, so they are one test.
"""

import os

import numpy as np

from rd_vio_tpu.config import Config as ConfigJ
from rd_vio_tpu.datasets import synthetic as synth_j
from tests.test_torch_image import IN_CHILD, child  # noqa: F401

if IN_CHILD:  # the port loads only where the checks run (test_torch_image)
    import jax
    import torch

    from rd_vio_tpu.models import builders as builders_j
    from rd_vio_tpu.utils import checkpoint as ck_j
    from rd_vio_tpu_torch import convert
    from rd_vio_tpu_torch.estimation import ba as ba_t
    from rd_vio_tpu_torch.models import builders as builders_t
    from rd_vio_tpu_torch.models.feature_tracker import SyntheticBackend
    from rd_vio_tpu_torch.models.odometry import Odometry
    from rd_vio_tpu_torch.parallel import dist_ba
    from rd_vio_tpu_torch.utils import checkpoint as ck_t

CAPS = dict(W=13, L=256, O=1536, Fi=16, R=128, IMU=64, IMU_KF=384)
DURATION_S = 1.6
N_RANKS = 4
SHARDED_TOL = 1e-8


def make_config(K):
    cfg = ConfigJ()
    cfg.camera_intrinsic = K
    cfg.sliding_window_size = 4
    cfg.initializer_keyframe_num = 4
    cfg.initializer_keyframe_gap = 4
    cfg.ransac_hypotheses = 128
    cfg.parsac_host_masks = False
    cfg.solver_iteration_limit = 5
    return cfg


def _canonical(state: dict) -> dict:
    """A checkpoint's arrays with track ids replaced by their order in the
    map (frames' track_ids and the tracks' records)."""
    import json

    tracks = json.loads(str(state["tracks_json"]))
    order = {t["id"]: k for k, t in enumerate(tracks)}
    out = {}
    for key, a in state.items():
        if key.endswith("track_ids"):
            a = np.array([order.get(int(t), -2) if t >= 0 else -1 for t in a], np.int64)
        elif key == "tracks_json":
            for t in tracks:
                t["id"] = order[t["id"]]
            a = json.dumps(tracks)
        out[key] = a
    return out


def _assert_same(a: dict, b: dict, keys, what):
    for k in keys:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        if x.dtype == object or y.dtype == object:
            assert x.tolist() == y.tolist(), (what, k)
        else:
            assert x.dtype == y.dtype and x.shape == y.shape, (what, k, x.dtype, y.dtype)
            np.testing.assert_array_equal(x, y, err_msg=f"{what}: {k}")


def _events(seq):
    return sorted([(t, 1, i) for i, t in enumerate(seq.t_imu)]
                  + [(t, 0, i) for i, t in enumerate(seq.t_frame)])


def _feed(odo, seq, events):
    for t, kind, i in events:
        if kind == 1:
            odo.add_motion(t, seq.gyro[i], seq.accel[i])
        else:
            odo.add_frame(t, i)


def _check_checkpoint(tmp):
    seq = synth_j.generate(duration=DURATION_S, n_landmarks=1200, max_keypoints=150,
                           seed=648)
    cfg_j = make_config(seq.K_mat)
    cfg = convert.config_from(cfg_j)
    # the serving ranks of (e) start now, so that their start overlaps the run
    init = dist_ba.local_init_method()
    ranks = dist_ba.RankProcesses(N_RANKS, "gloo", init, device="cpu", timeout_s=300.0,
                                  threads=1)
    try:
        _run_checks(tmp, seq, cfg_j, cfg, init)
    finally:
        dist_ba.close_group()
        exits = ranks.wait(30.0)
    assert all(rc == 0 for rc, _ in exits), exits


def _run_checks(tmp, seq, cfg_j, cfg, init):
    odo = Odometry(cfg, SyntheticBackend(seq), caps=builders_t.Caps(**CAPS), device="cpu")
    events = _events(seq)
    for n, (t, kind, i) in enumerate(events):
        _feed(odo, seq, [(t, kind, i)])
        swt = odo.frontend.swt
        if (kind == 0 and swt is not None and swt.prior is not None
                and swt._dev_sub is None and not swt._pending_subs):
            break
    else:
        raise AssertionError("the run never reached a window with a prior")
    rest = events[n + 1:]
    assert swt.gumbel_source is not None

    # (c) the round trip, bit for bit
    path = os.path.join(tmp, "port.npz")
    ck_t.save_tracker(path, swt)
    saved = dict(np.load(path, allow_pickle=True))
    live = ck_t.tracker_state(swt)
    assert set(saved) == set(live)
    _assert_same(saved, live, saved, "file against the live tracker")
    restored = ck_t.load_tracker(path, cfg, odo.calib, odo.caps)
    assert restored.calib.device == "cpu" and restored.prior.sqrt_inv_cov.device.type == "cpu"
    again = ck_t.tracker_state(restored)
    assert set(again) == set(saved)
    _assert_same(again, saved, saved, "file of the restored tracker")

    # (c) the next frame on both: the restored tracker first (its mirror and
    # track see the feature-tracking map as the original's mirror does)
    done = []
    mirror, track = swt.mirror_frame, swt.track

    def mirror_both(ft_map, fid):
        if not done:
            restored.feature_tracking_map = ft_map
            assert restored.mirror_frame(ft_map, fid)
            assert restored.track()
            done.append(fid)
        return mirror(ft_map, fid)

    def track_once():
        out = track()
        done.append("tracked")
        return out

    swt.mirror_frame, swt.track = mirror_both, track_once
    for ev in rest:
        _feed(odo, seq, [ev])
        if "tracked" in done:
            break
    swt.mirror_frame, swt.track = mirror, track
    assert done and done[-1] == "tracked", "the run ended before the next frame"
    a, b = _canonical(ck_t.tracker_state(swt)), _canonical(ck_t.tracker_state(restored))
    assert set(a) == set(b)
    _assert_same(a, b, a, "the next frame, original against restored")

    # (d) the JAX package reads the port's file, and the port the JAX file
    calib_j = builders_j.CalibArrays.from_config(cfg_j)
    swt_j = ck_j.load_tracker(path, cfg_j, calib_j, builders_j.Caps(**CAPS))
    path_j = os.path.join(tmp, "jax.npz")
    ck_j.save_tracker(path_j, swt_j)
    from_j = dict(np.load(path_j, allow_pickle=True))
    assert set(from_j) <= set(saved), sorted(set(from_j) - set(saved))
    assert all(k.startswith("torch_") for k in set(saved) - set(from_j))
    np.testing.assert_array_equal(saved["rng_key"],
                                  np.asarray(jax.random.PRNGKey(cfg_j.random)))
    back = ck_t.tracker_state(ck_t.load_tracker(path_j, cfg, odo.calib, odo.caps))
    _assert_same(back, saved, from_j, "the JAX package's file, loaded by the port")

    # (e) the sharded refine_window on a restored copy against one solve
    sharded = ck_t.load_tracker(path, cfg, odo.calib, odo.caps)
    single = ck_t.load_tracker(path, cfg, odo.calib, odo.caps)
    group = dist_ba.make_group(0, N_RANKS, "gloo", init, device="cpu", timeout_s=300.0)
    sharded.dist_mesh = group
    validated = []
    validate = sharded._validate_landmarks
    sharded._validate_landmarks = lambda: validated.append(validate())
    sharded.refine_window()
    info = dict(group.last_solve)
    dist_ba.stop_serving(group)
    assert validated == [None], "the landmark validation did not run"
    assert info["rank_iterations"] == [info["iterations"]] * N_RANKS, info
    frames = list(single.map.frames)
    spec = single._window_spec(frames, {f.id: f for f in single.map.all_frames()})
    st, invd, pb, _ = builders_t.build_problem(spec, single.calib, single.caps)
    assert st.p.dtype == torch.float64 and pb.prior_valid
    res = ba_t.solve_ba(st, invd, pb, max_iterations=cfg.solver_iteration_limit)
    got = np.stack([f.p for f in sharded.map.frames])
    assert len(got) == len(frames) == N_RANKS
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, res.states.p.numpy()[: len(frames)], rtol=0,
                               atol=SHARDED_TOL)
    q = np.stack([f.q for f in sharded.map.frames])
    np.testing.assert_allclose(q, res.states.q.numpy()[: len(frames)], rtol=0,
                               atol=SHARDED_TOL)


def test_checkpoint_and_sharded_window(child, tmp_path):
    child(_check_checkpoint, str(tmp_path))
