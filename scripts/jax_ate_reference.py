"""ATE of the JAX package on the main path's rendered sequence, on the CPU.

    JAX_PLATFORMS=cpu python scripts/jax_ate_reference.py [n_frames] [--device-parsac] [--out FILE]
    JAX_PLATFORMS=cpu python scripts/jax_ate_reference.py --lockstep [n_ticks] [--out FILE]
    JAX_PLATFORMS=cpu python scripts/jax_ate_reference.py --euroc [n_frames] [--out FILE]
    JAX_PLATFORMS=cpu python scripts/jax_ate_reference.py --async [n_frames] [--out FILE]

Runs `rd_vio_tpu.models.odometry.Odometry` synchronously (threaded=False) with
the JaxImageBackend over the first `n_frames` (default 160) frames of
bench.py's phase-1 sequence (8 s, rendered at 752x480), with bench.py's
`make_config(light=False)` (the fallback block used when the reference
setting.yaml is absent) and its `Caps(W=15, L=256, O=2560, Fi=16, R=128,
IMU=64, IMU_KF=384)`. Events go in bench.py's order (IMU and frames sorted by
time) and the estimate of a frame is `handler.get_latest_state()` after it,
once `state() == 1`, as bench.py collects them.

Prints, for every prefix of N frames that a run of N frames would give (the
run is synchronous, so the first N frames of a longer run are that run), the
SE3-aligned ATE of the estimates collected so far (`utils.trajectory.ate_rmse`,
bench.py's definition), the tracked frames, the fully fused keyframe steps
(`builders.KF_FUSED_COUNT`) and the system state. chip_smoke.py's phase F
holds the PyTorch port's ATE against the line of its N.

`--device-parsac` runs the IMU-PARSAC judge and the 2D-2D keyframe check as
the device programs (`parsac_host_masks=False`: `ops/parsac.imu_parsac_pnp`
and `parsac_essential_chain`) instead of their NumPy twins, and each line
also gives the calls of the two programs so far (`judge_calls`,
`chain_calls`); chip_smoke.py's phase G holds the port's threaded run
against the line of its N.

`--lockstep` runs bench.py's phase 4 instead: the JAX package's
`rd_vio_tpu.batch.run_sequences_lockstep` over N=4 sequences
`synthetic.generate(duration=10.0, n_landmarks=1200, max_keypoints=150,
seed=648 + 7*i)`, each with the `SyntheticBackend` and
`make_config(light=False)` with the sequence's camera, and the same Caps, for
`n_ticks` ticks (default 200, the whole sequence). The lockstep run is
synchronous, so its first T ticks are the run of T ticks: for every T it
prints the batched keyframe flushes so far, `steady_window_start` of that
run, each sequence's ATE over its estimates up to tick T, and the tick at
which the third batched keyframe flush ran. chip_smoke.py's phase H runs
`H_TICKS = (that tick) + 16` ticks, the smallest count whose steady window
(from 5 ticks past the third flush) spans >= 10 ticks, and holds the port's
ATEs against that line.

`--euroc` runs the EuRoC runner's path instead: the first `n_frames`
(default 120) frames of the phase-1 sequence, rendered at 752x480 and
distorted with EuRoC cam0's radtan coefficients, written as a mav0 layout
with a sensor.yaml and bench.py's reference profile as setting.yaml
(scripts/euroc_layout.py, the writer chip_smoke.py's phase I uses), then
`rd_vio_tpu.datasets.euroc.run_euroc` over it (synchronous, PIL reader,
undistortion on). For every prefix of N frames it prints the ATE of the
estimates run_euroc has collected after frame N (`associate` against the
layout's ground truth, then `ate_rmse`; a synchronous run's first N frames
are the run with max_frames=N), the tracked estimates and the fused
keyframe steps so far. chip_smoke.py's phase I runs the least N past the
third fused keyframe step and holds the port's ATE against that line.

`--async` runs the async keyframe step instead: `Odometry` synchronously
with the perfect-match `SyntheticBackend` (bench.py's phase 2 backend) over
the first `n_frames` (default 160) frames of the phase-1 sequence, with
`make_config(light=False)`, `camera_intrinsic = seq.K_mat` and
`sliding_window_keyframe_async = True`, and the same Caps. For every prefix
of N frames it prints the ATE so far, the tracked frames, the async
keyframe dispatches (`_keyframe_dispatch_async` calls) and the synchronous
fused steps the gate fell through to (`KF_FUSED_COUNT` less the
dispatches), the ids of the frames that were keyframes after any frame so
far (the frames of `swt.map.frames`, by index), the window size
(`map.frame_num`) and the most it has been. A last line gives the frame of
the third async dispatch and `k_frames`, that frame's index + 2 (the least
count whose run also applies the third dispatch's deferred results);
chip_smoke.py's phase K runs that many frames and holds the port to that
line.
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS", "cpu"))

import numpy as np  # noqa: E402

from rd_vio_tpu.config import Config  # noqa: E402
from rd_vio_tpu.datasets import synthetic  # noqa: E402
from rd_vio_tpu.datasets.renderer import SequenceRenderer  # noqa: E402
from rd_vio_tpu.models import builders  # noqa: E402
from rd_vio_tpu.models.image_backend import JaxImageBackend  # noqa: E402
from rd_vio_tpu.models.odometry import Odometry  # noqa: E402
from rd_vio_tpu.ops import parsac  # noqa: E402
from rd_vio_tpu.utils.trajectory import ate_rmse  # noqa: E402

CAPS = builders.Caps(W=15, L=256, O=2560, Fi=16, R=128, IMU=64, IMU_KF=384)


def make_config(K) -> Config:
    cfg = Config()
    cfg.sliding_window_size = 12
    cfg.sliding_window_subframe_size = 5
    cfg.sliding_window_force_keyframe_landmarks = 50
    cfg.feature_tracker_min_keypoint_distance = 10.0
    cfg.feature_tracker_max_keypoint_detection = 200
    cfg.feature_tracker_max_frames = 20
    cfg.solver_iteration_limit = 30
    cfg.rotation_misalignment_threshold = 0.02
    cfg.parsac_flag = True
    cfg.parsac_dynamic_probability = 0.15
    cfg.parsac_threshold = 1.0
    cfg.parsac_keyframe_check_size = 1
    cfg.ransac_hypotheses = 128
    cfg.camera_intrinsic = K
    cfg.camera_resolution = (752, 480)
    return cfg


def lockstep(argv):
    from rd_vio_tpu.batch import runtime
    from rd_vio_tpu.models.feature_tracker import SyntheticBackend

    i = argv.index("--lockstep")
    n_ticks = int(argv[i + 1]) if len(argv) > i + 1 and not argv[i + 1].startswith("-") \
        else 200
    out = argv[argv.index("--out") + 1] if "--out" in argv else None
    seqs, cfgs = [], []
    for s_i in range(4):
        seq = synthetic.generate(duration=10.0, n_landmarks=1200, max_keypoints=150,
                                 seed=648 + 7 * s_i)
        # run_sequences_lockstep runs min(len(t_frame)) ticks
        seq.t_frame = seq.t_frame[:n_ticks]
        cfg = make_config(seq.K_mat)
        seqs.append(seq)
        cfgs.append(cfg)
    t0 = time.perf_counter()
    n, est, stamps, kf = runtime.run_sequences_lockstep(
        cfgs, [SyntheticBackend(s) for s in seqs], seqs, caps=CAPS,
        on_tick=lambda k: print(f"tick {k} at {time.perf_counter() - t0:.1f} s",
                                file=sys.stderr, flush=True))
    third = next((k for k, c in enumerate(kf) if c >= 3), None)
    rows = []
    for T in range(1, n + 1):
        t_end = seqs[0].t_frame[T - 1]
        ates = []
        for seq, e in zip(seqs, est):
            gt = {round(t, 6): p for t, p in zip(seq.t_frame, seq.p_wb)}
            pts = [(p, gt[round(t, 6)]) for t, p in e if t <= t_end + 1e-9]
            ates.append(float(ate_rmse(np.stack([a for a, _ in pts]),
                                       np.stack([b for _, b in pts])))
                        if len(pts) >= 3 else None)
        rows.append({"ticks": T, "kf_flushes": kf[T - 1],
                     "steady_window_start": runtime.steady_window_start(kf[:T]),
                     "tracked": [int(sum(t <= t_end + 1e-9 for t, _ in e)) for e in est],
                     "ate_m": ates, "third_kf_flush_tick": third,
                     "h_ticks": None if third is None else third + 16})
        print(json.dumps(rows[-1]), flush=True)
    print(json.dumps({"wall_s": time.perf_counter() - t0, "ticks": n,
                      "third_kf_flush_tick": third}), flush=True)
    if out:
        with open(out, "w") as fh:
            json.dump(rows, fh)
    return 0


def euroc(argv):
    import tempfile

    import jax.numpy as jnp

    from rd_vio_tpu.datasets import euroc as euroc_j
    from rd_vio_tpu.models import odometry as odometry_j
    from rd_vio_tpu.ops import camera
    from rd_vio_tpu.utils.trajectory import associate
    from scripts.euroc_layout import EUROC_CAM0_RADTAN, write_layout

    i = argv.index("--euroc")
    n_frames = int(argv[i + 1]) if len(argv) > i + 1 and not argv[i + 1].startswith("-") \
        else 120
    out = argv[argv.index("--out") + 1] if "--out" in argv else None
    seq = synthetic.generate(duration=8.0, n_landmarks=1200, max_keypoints=150,
                             excitation=0.05)
    rend = SequenceRenderer(seq, image_size=(752, 480))
    K, dist = rend.K, np.asarray(EUROC_CAM0_RADTAN)
    rows = []

    class Recording(odometry_j.Odometry):
        """Collects after each frame what run_euroc collects, and prints the
        prefix's line."""

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.est_t, self.est_p = [], []

        def add_frame(self, t, image):
            super().add_frame(t, image)
            if self.state() == 1:
                ls = self.handler.get_latest_state()
                if ls is not None:
                    self.est_t.append(ls[0])
                    self.est_p.append(ls[2])
            ate = None
            if len(self.est_p) >= 3:
                ie, ig = associate(np.asarray(self.est_t), gt["t"])
                ate = float(ate_rmse(np.asarray(self.est_p)[ie], gt["p"][ig]))
            rows.append({"n": len(rows) + 1, "state": self.state(),
                         "tracked": len(self.est_p), "kf_fused": builders.KF_FUSED_COUNT.n,
                         "ate_m": ate, "wall_s": round(time.perf_counter() - t0, 1)})
            print(json.dumps(rows[-1]), flush=True)

    with tempfile.TemporaryDirectory() as tmp:
        mav0, sensor_yaml, setting_yaml = write_layout(
            tmp, seq, [rend.render(k) for k in range(n_frames)], K, dist,
            lambda p: np.asarray(camera.undistort_points_pixel(
                jnp.asarray(p), jnp.asarray(K), jnp.asarray(dist))))
        gt = euroc_j.EurocDataset._read_gt(
            os.path.join(mav0, "state_groundtruth_estimate0", "data.csv"))
        builders.KF_FUSED_COUNT.n = 0
        odometry_j.Odometry = Recording  # run_euroc imports it at its call
        t0 = time.perf_counter()
        est_t, est_p, _, odo = euroc_j.run_euroc(mav0, sensor_yaml, setting_yaml)
    third = next((r["n"] for r in rows if r["kf_fused"] >= 3), None)
    print(json.dumps({"wall_s": time.perf_counter() - t0, "frames": len(rows),
                      "third_kf_fused_frame": third,
                      "same_estimates": bool(np.array_equal(est_p, np.asarray(odo.est_p)))}),
          flush=True)
    if out:
        with open(out, "w") as fh:
            json.dump(rows, fh)
    return 0


def async_keyframe(argv):
    from rd_vio_tpu.models.feature_tracker import SyntheticBackend

    i = argv.index("--async")
    n_frames = int(argv[i + 1]) if len(argv) > i + 1 and not argv[i + 1].startswith("-") \
        else 160
    out = argv[argv.index("--out") + 1] if "--out" in argv else None
    seq = synthetic.generate(duration=8.0, n_landmarks=1200, max_keypoints=150,
                             excitation=0.05)
    cfg = make_config(seq.K_mat)
    cfg.sliding_window_keyframe_async = True
    odo = Odometry(cfg, SyntheticBackend(seq), caps=CAPS, threaded=False)
    index_of = {round(t, 6): k for k, t in enumerate(seq.t_frame)}
    gt_by_t = {round(t, 6): p for t, p in zip(seq.t_frame, seq.p_wb)}
    events = sorted([(t, 1, k) for k, t in enumerate(seq.t_imu)]
                    + [(t, 0, k) for k, t in enumerate(seq.t_frame[:n_frames])])
    dispatches, keyframes, est_t, est_p, rows = [], set(), [], [], []
    hooked, max_frame_num = [], 0
    builders.KF_FUSED_COUNT.n = 0
    t0 = time.perf_counter()
    for t, kind, k in events:
        if kind == 1:
            odo.add_motion(t, seq.gyro[k], seq.accel[k])
            continue
        odo.add_frame(t, k)
        swt = odo.frontend.swt
        if swt is not None and swt not in hooked:
            hooked.append(swt)

            def counted(*a, _orig=swt._keyframe_dispatch_async, **kw):
                dispatches.append(len(rows))
                return _orig(*a, **kw)

            swt._keyframe_dispatch_async = counted
        if swt is not None:
            keyframes.update(index_of[round(f.t, 6)] for f in swt.map.frames)
            max_frame_num = max(max_frame_num, swt.map.frame_num)
        if odo.state() == 1:
            ls = odo.handler.get_latest_state()
            if ls is not None and (not est_t or ls[0] != est_t[-1]):
                est_t.append(ls[0])
                est_p.append(ls[2])
        ate = None
        if len(est_p) >= 3:
            gt = np.stack([gt_by_t[round(tt, 6)] for tt in est_t])
            ate = float(ate_rmse(np.asarray(est_p), gt))
        rows.append({"n": len(rows) + 1, "state": odo.state(), "tracked": len(est_p),
                     "first_tracked_frame": (index_of[round(est_t[0], 6)] if est_t else None),
                     "async_dispatches": len(dispatches),
                     "sync_fused": builders.KF_FUSED_COUNT.n - len(dispatches),
                     "dispatch_frames": list(dispatches), "keyframes": sorted(keyframes),
                     "frame_num": None if swt is None else swt.map.frame_num,
                     "max_frame_num": max_frame_num, "ate_m": ate,
                     "wall_s": round(time.perf_counter() - t0, 1)})
        print(json.dumps(rows[-1]), flush=True)
    odo.close()
    third = dispatches[2] if len(dispatches) >= 3 else None
    print(json.dumps({"wall_s": time.perf_counter() - t0, "frames": len(rows),
                      "third_async_dispatch_frame": third,
                      "k_frames": None if third is None else third + 2}), flush=True)
    if out:
        with open(out, "w") as fh:
            json.dump(rows, fh)
    return 0


def main(argv):
    if "--lockstep" in argv:
        return lockstep(argv)
    if "--async" in argv:
        return async_keyframe(argv)
    if "--euroc" in argv:
        return euroc(argv)
    n_frames = int(argv[0]) if argv and not argv[0].startswith("-") else 160
    out = argv[argv.index("--out") + 1] if "--out" in argv else None
    device_parsac = "--device-parsac" in argv
    calls = {"judge_calls": 0, "chain_calls": 0}
    for name, key in (("imu_parsac_pnp", "judge_calls"),
                      ("parsac_essential_chain", "chain_calls")):
        def counted(*a, _fn=getattr(parsac, name), _key=key, **kw):
            calls[_key] += 1
            return _fn(*a, **kw)

        # the tracker calls both through the module (parsac.<name>)
        setattr(parsac, name, counted)
    seq = synthetic.generate(duration=8.0, n_landmarks=1200, max_keypoints=150,
                             excitation=0.05)
    rend = SequenceRenderer(seq, image_size=(752, 480))
    frames = [np.asarray(rend.render(i), np.uint8) for i in range(n_frames)]
    cfg = make_config(rend.K)
    cfg.parsac_host_masks = not device_parsac
    odo = Odometry(cfg, JaxImageBackend(cfg, kp_cap=384), caps=CAPS, threaded=False)
    gt_by_t = {round(t, 6): p for t, p in zip(seq.t_frame, seq.p_wb)}
    events = sorted([(t, 1, i) for i, t in enumerate(seq.t_imu)]
                    + [(t, 0, i) for i, t in enumerate(seq.t_frame[:n_frames])])
    est_t, est_p, rows = [], [], []
    n, t0 = 0, time.perf_counter()
    builders.KF_FUSED_COUNT.n = 0
    for t, kind, i in events:
        if kind == 1:
            odo.add_motion(t, seq.gyro[i], seq.accel[i])
            continue
        odo.add_frame(t, frames[i])
        n += 1
        if odo.state() == 1:
            ls = odo.handler.get_latest_state()
            if ls is not None and (not est_t or ls[0] != est_t[-1]):
                est_t.append(ls[0])
                est_p.append(ls[2])
        ate = None
        if len(est_p) >= 3:
            gt = np.stack([gt_by_t[round(tt, 6)] for tt in est_t])
            ate = float(ate_rmse(np.asarray(est_p), gt))
        rows.append({"n": n, "state": odo.state(), "tracked": len(est_p),
                     "kf_fused": builders.KF_FUSED_COUNT.n, "ate_m": ate,
                     **(calls if device_parsac else {}),
                     "wall_s": round(time.perf_counter() - t0, 1)})
        print(json.dumps(rows[-1]), flush=True)
        if n >= n_frames:
            break
    if out:
        with open(out, "w") as fh:
            json.dump(rows, fh)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
