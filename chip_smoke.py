"""Drive the PyTorch port's main path once on an NVIDIA GPU.

    python3 chip_smoke.py

Builds the LK kernels (rd_vio_tpu_torch/csrc/lk_track.cu: the fused forward +
reverse track and one level of it) from the checkout, then:

  A. kernels against plain: a rendered 752x480 pair of the bench sequence,
     384 GFTT keypoints tracked forward + reverse over the 4-level pyramid
     through the fused kernel (one launch), through the per-level kernel (8
     launches) and through plain PyTorch; status agreement >= 0.995 and
     median flow difference <= 1e-3 px on agreed tracks; a second set of 384
     keypoints that trips every status rule (borders, far and NaN
     predictions, a flat patch, invalid slots), on which the fused kernel's
     status must equal the plain version's exactly; one level-0 call of the
     level kernel against the plain level; the time of each (CUDA events,
     in alternation after a warm-up) and each kernel's bound, computed from
     the shapes and from the iterations this run's keypoints took;
  B. the slice: the first B_FRAMES (45) frames of the bench's phase-1
     sequence (8 s, rendered at 752x480 before the clock starts) through Handler -> FeatureTracker ->
     TorchImageBackend with the reference-yaml profile of bench.py; frames/s
     over the second half, device ms per stage, keypoints per frame, the
     share of keypoints continued, and the fused kernel's launch count
     (exactly one per tracked frame), median keypoints per frame >= 100;
  C. the first 10 frames of B again with the plain LK tracker on the card;
     keypoint slots agree with B on >= 98%;
  D. the same 10 frames through the per-level kernel (8 launches per
     tracked frame, counted), with the same agreement;
  E. the estimator: the window VI-BA problem of B's sequence at the main
     path's shapes (bench.py's Caps: W=15 frames, L=256 landmarks, O=2560
     observations; frames 10-24), started from test_ba.py's perturbation
     with frame 0 fixed, solved by `solve_ba` (30 LM iterations at most) in
     f64 and, cast, in f32; then `marginalize_frame0` in f64 on the f64
     solution. Checks: in f64 and f32 the cost falls >= 1e3 x and positions
     land within 5e-3 m of the truth; every tensor is finite; the prior's
     information S^T S is symmetric positive semi-definite; the card's f64
     solve equals the port's CPU solve of the same inputs (accepted steps
     within 1, positions within 1e-6 m). Prints iterations, costs, device ms per
     solve and per iteration (CUDA events: one f64 solve after a warm-up;
     the f32 solve is checked, not timed), ms per call with the host, host
     syncs per call, the device spans of build_normal_system /
     solve_normal_system, kernels per f64 solve (torch.profiler); and
     a two-view triangulation of the tracks of slots 0 and 1 against the
     true points (within 1e-6 m), with its host syncs;
  F. the main path: `Odometry(cfg, TorchImageBackend(cfg, kp_cap=384),
     caps=bench.py's Caps)` over the first F_FRAMES frames of B's sequence
     in bench.py's event order (synchronous). Checks: it reaches tracking
     and never reports a crash; every published pose and window state is
     finite; one fused LK launch per tracked frame pair and no level launch;
     the fused keyframe step and its marginalization ran >= 3 times each;
     the ATE (bench.py's SE3-aligned RMSE) within F_ATE_BOUND_M of the JAX
     package's ATE on the CPU over the same frames (F_ATE_JAX_CPU_M); the
     first fused keyframe step, run again on the card and on the CPU, agrees
     (see keyframe_card_vs_cpu). Prints frames/s over the tracked frames, ms
     per subframe and per keyframe, host syncs per frame, solves and LM
     iterations per device program, the host spans by name, and kernels per
     frame and the device busy share over the last frame (torch.profiler);
  G. the threaded main path with the device PARSAC, in a second process
     that runs at once with F (see PhaseGChild): `Odometry(cfg_g,
     TorchImageBackend(cfg_g, kp_cap=384), caps=F's Caps, threaded=True)`
     with F's config but parsac_host_masks=False, over the first G_FRAMES
     (88) frames in bench.py's event order, then join() and close().
     Checks: no worker error; tracking reached with finite poses; after
     join() the latest state is the last frame's; device judge calls equal
     the frames that judged, >= 1 chained 2D-2D check; one fused LK launch
     per frame pair and no level launch; both worker threads exited after
     close(); the ATE within G_ATE_BOUND_M of the JAX package's synchronous
     CPU run with the device PARSAC; the first judge's and the first chain's
     inputs (noise included) replayed on the CPU (see parsac_card_vs_cpu).
     Prints threaded frames/s beside F's synchronous frames/s over the same
     frame indices, each worker's summed span time, the device judge's span
     beside F's host twin, and the host syncs per judge and per chain call.
     F and G also check that the native host library (rd_vio_tpu_torch/
     native, built with g++ from the checkout) was called;
  H. bench.py's phase 4 in a third process, started first and run at once
     with A-G (see phase_h): `batch.run_sequences_lockstep` over H_N (4)
     synthetic sequences with bench.py's config and Caps for H_TICKS (94)
     ticks, each tick's solves in one batched program per stage. Checks:
     every sequence tracks with finite poses and never loses tracking; >= 3
     batched keyframe flushes; per tick at most one batched keyframe
     program, as many marginalizations, at most one subwindow program; vmap
     never fell back to a loop over rows; the native library was called;
     each sequence's ATE within its bound of the JAX package's lockstep CPU
     run; the first batched keyframe flush replayed row by row through the
     single-sequence step on the card and as a batch on the CPU (see
     batch_replay). Prints the steady aggregate frames/s (bench.py's
     batch_fps_per_chip) beside F's frames/s, kernels per steady tick
     beside F's kernels per frame, the busy share, LM iterations per
     batched solve, host syncs per tick and the spans;
  I. the EuRoC runner's path in a fourth process, started with H: the first
     I_FRAMES (84) frames of B's sequence rendered at 752x480, distorted on
     the host with EuRoC cam0's published radtan coefficients and written
     as a EuRoC mav0 layout (uint8 PNGs, imu0 / cam0 / ground-truth CSVs, a
     sensor.yaml with camera_distortion_flag 1, bench.py's reference
     profile as setting.yaml; scripts/euroc_layout.py), then
     examples/torch_run_euroc.py's `run` over it, threaded, on the card
     (load_config of both files, the native EuRoC loader where libpng
     builds, else PIL, the remap tables on the card, TorchImageBackend,
     Odometry). Checks: the config carries both files' values; the reader
     is the native loader exactly when it builds (and then read every
     frame); tracking reached with finite published poses, no worker error;
     one fused LK launch per frame pair and no level launch; the ATE
     (`associate` against the layout's ground truth) within I_ATE_BOUND_M
     of the JAX package's run_euroc on the CPU over the same layout; the
     card's remap of frame 0 against the CPU's (integer parts equal on
     >= 99.9% of pixels). Prints the reader, frames/s over the tracked
     frames, the spans ds.load and ds.undistort per frame, host syncs per
     frame, the remap's max |difference|, the pixels whose integer part
     differs and its device ms;
  J. the JAX package's last modules, when F ends (see phase_j): J.3 in this
     process, F's tracker through `utils/checkpoint.save_tracker` and
     `load_tracker` onto the card (every array bit for bit, the JAX
     package's keys all present; under G's config the device PARSAC's
     generator state and the host seed counter carried); then, in a fifth
     process (`--phase-child J OUT CHECKPOINT`), J.1 phase E's problem
     solved by `parallel/dist_ba.solve_ba_sharded` over NCCL at world size
     1 and over J_RANKS (4) gloo ranks on the one card (each rank a
     process; collectives staged through pinned host buffers), each within
     1e-6 m of the single-card `solve_ba` of the same relaid problem, with
     ms per LM iteration beside the single solve's, ms in collectives,
     bytes all-reduced and host syncs per iteration; J.2 F's window
     restored twice from the checkpoint, `refine_window` sharded over the
     4-rank group on one copy against `build_problem` + `solve_ba` (f64) of
     the same spec on the other, within 1e-6 m, the landmark validation
     run; J.4 `ops/image/intensity.evaluate_pyramid` at phase A's 384
     keypoints on every level of the 4-level pyramid, card against CPU
     within 1e-3, with ms per call. A rank that fails or a collective that
     times out (J_TIMEOUT_S) fails the phase;
  K. the async keyframe step, in a sixth process started with H and I (see
     phase_k): `Odometry(cfg, SyntheticBackend(seq), caps=F's Caps)` with
     F's config and sliding_window_keyframe_async=True over the first
     K_FRAMES frames of B's sequence, synchronous, then close(). Checks:
     the async dispatches, the synchronous fall-throughs, the first tracked
     frame and the frames that were keyframes equal the JAX package's run
     of the same input on the CPU; the window never over
     sliding_window_size + 1 keyframes; close() applied the pending
     keyframe step; the ATE within K_ATE_DIFF_M of the JAX run's; the first
     async step replayed on the CPU and K_CARD_REPLAYS more times on the
     card (see keyframe_card_vs_cpu and K_COST_REL). Prints the
     mean span of swt.keyframe_fused and the host syncs per tick for async
     and for synchronous keyframe ticks, and ms per frame.

Exits non-zero, with no result line, without a CUDA device or when any
check fails. Before the last line come an `{"estimator": ...}` line with
phase E's numbers, an `{"odometry": ...}` line with phase F's, an
`{"odometry_threaded": ...}` line with phase G's, a `{"batch": ...}` line
with phase H's, an `{"euroc": ...}` line with phase I's, a
`{"checkpoint": ...}` line with J.3's, an `{"async_keyframe": ...}` line
with K's and a `{"dist": ...}` line with J.1, J.2 and J.4's, and the
`{"kernels": ...}` line with both LK kernels' launch counts (the fused
kernel's: phases F, G and I, the main path and the runner's, each counted
from 0 just before it; the level kernel's: phase D), errors, times and
bounds (the estimator, the batch runtime, the dataset layer, the sharded
BA, intensity and the async keyframe step add no kernel: they are plain
PyTorch, as they are XLA in the JAX package, and the native libraries and
the checkpoint are host code in both); the last line of stdout
is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import statistics
import os
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch

from rd_vio_tpu_torch.config import Config
from rd_vio_tpu_torch.datasets import synthetic
from rd_vio_tpu_torch.datasets.renderer import SequenceRenderer
from rd_vio_tpu_torch.datasets.synthetic_problems import build_window_problem, perturbed_start
from rd_vio_tpu_torch.estimation import ba, marginalization
from rd_vio_tpu_torch.estimation import factors as F
from rd_vio_tpu_torch.models import builders
from rd_vio_tpu_torch.models import sliding_window_tracker as swt_mod
from rd_vio_tpu_torch.models.feature_tracker import FeatureTracker
from rd_vio_tpu_torch.models.handler import Handler
from rd_vio_tpu_torch.models.image_backend import TorchImageBackend
from rd_vio_tpu_torch.models.odometry import Odometry
from rd_vio_tpu_torch.ops import lie, parsac, triangulate
from rd_vio_tpu_torch.ops.image import intensity, klt
from rd_vio_tpu_torch.ops.image import pyramid as pyr_mod
from rd_vio_tpu_torch.parallel import dist_ba
from rd_vio_tpu_torch.tools import lk_bench
from rd_vio_tpu_torch.utils import checkpoint
from rd_vio_tpu_torch.utils.metrics import GLOBAL_TIMER, DeviceStageTimer
from rd_vio_tpu_torch.utils.trajectory import ate_rmse

W_IMG, H_IMG = 752, 480
DEV = torch.device("cuda", 0)
KP_CAP = FeatureTracker.KP_CAP  # 384


def check(cond: bool, what: str):
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def make_config(K) -> Config:
    """bench.py make_config(light=False), the fallback block used when the
    reference setting.yaml is absent, plus the phase-1 camera."""
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
    cfg.camera_resolution = (W_IMG, H_IMG)
    return cfg


H100_BYTES_PER_S = 3.35e12  # HBM3, NVIDIA H100 SXM data sheet
H100_F32_FLOP_PER_S = 67e12  # f32 outside the tensor cores, same sheet
# operations of csrc/lk_track.cu per keypoint and level: the 23x23 bilinear
# template (9 each), 441 gradients (4) and normal-matrix terms (6); per
# iteration 441 x (4-tap blend 7 + residual 1 + two gradient sums 4)
FLOP_LEVEL_SETUP = 23 * 23 * 9 + 441 * (4 + 6)
FLOP_ITERATION = 441 * 12
FLAT = (200, 280, 330, 410)  # y0, y1, x0, x1 of phase A's painted flat patch


def bound(n_bytes: int, flop: int):
    """(least ms the card could take, which of the two binds)."""
    t_bytes = n_bytes / H100_BYTES_PER_S * 1e3
    t_flop = flop / H100_F32_FLOP_PER_S * 1e3
    return max(t_bytes, t_flop), "bytes" if t_bytes >= t_flop else "operations"


def agreement(out_a, out_b):
    """(status agreement, agreed tracks, median and max flow difference)."""
    (tr_a, st_a), (tr_b, st_b) = out_a, out_b
    st_a, st_b = st_a.cpu().numpy(), st_b.cpu().numpy()
    both = st_a & st_b
    d = np.linalg.norm(tr_a.cpu().numpy()[both] - tr_b.cpu().numpy()[both], axis=-1)
    return float((st_a == st_b).mean()), int(both.sum()), float(np.median(d)), \
        float(d.max())


def phase_a(cfg, frames, dev):
    """Both kernels against their plain versions on one frame pair at the
    slice's shapes; returns the two entries of the `kernels` line (without
    their launch counts)."""
    be = TorchImageBackend(cfg, dev)
    pa = be.preprocess(frames[0]).pyramid
    pb = be.preprocess(frames[1]).pyramid
    pix, corner = lk_bench.main_path_keypoints(pa, KP_CAP, W_IMG, H_IMG, dev)
    n_gftt = int(corner.sum())
    val = torch.ones(KP_CAP, dtype=torch.bool, device=dev)
    check(n_gftt >= 100, f"phase A: only {n_gftt} GFTT keypoints")
    args = (pa, pb, pix, pix, val)

    # the per-level kernel path that also records, per launch, the keypoints
    # it iterated and the iterations they ran: the operations of this run
    work = []

    def level_counting(img_prev, img_next, pts, guess, valid, iters, eps):
        tracked, min_eig, n_iter = klt.lk_level_iters(
            img_prev, img_next, pts, guess, valid, iters, eps)
        work.append((valid.sum(), n_iter.sum()))
        return tracked, min_eig

    run_f = lambda: klt.lk_track_fwd_rev(*args)  # noqa: E731
    run_l = lambda: klt.lk_track_fwd_rev_plain(*args, level=klt.lk_level)  # noqa: E731
    run_p = lambda: klt.lk_track_fwd_rev_plain(*args)  # noqa: E731
    out_f, out_p = run_f(), run_p()
    out_l = klt.lk_track_fwd_rev_plain(*args, level=level_counting)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(out_f[0][out_f[1]]).all()),
          "phase A: non-finite kernel tracks")
    agree, n_both, med, mx = agreement(out_f, out_p)
    agree_l, _, med_l, _ = agreement(out_l, out_p)
    print(f"[A] {KP_CAP} keypoints ({n_gftt} GFTT) x {len(pa)} levels x 2 "
          f"directions at {W_IMG}x{H_IMG}, fused kernel against plain: status "
          f"agreement {agree:.4f}, tracked {int(out_f[1].sum())} (kernel) / "
          f"{int(out_p[1].sum())} (plain), flow diff on {n_both} agreed "
          f"tracks: median {med:.3e} px, max {mx:.3e} px; per-level kernel "
          f"path against plain: status agreement {agree_l:.4f}, median "
          f"{med_l:.3e} px")
    check(agree >= 0.995, f"phase A: status agreement {agree:.4f} < 0.995")
    check(med <= 1e-3, f"phase A: median flow difference {med:.3e} > 1e-3 px")
    check(agree_l >= 0.995 and med_l <= 1e-3, "phase A: per-level kernel path")

    # a second set of keypoints built to trip every status rule: the fused
    # kernel's status must equal the plain version's on every slot
    ea = pyr_mod.build_pyramid(lk_bench.paint_flat_patch(pa[0], FLAT), len(pa) - 1)
    eb = pyr_mod.build_pyramid(lk_bench.paint_flat_patch(pb[0], FLAT), len(pb) - 1)
    good, corner = lk_bench.main_path_keypoints(ea, KP_CAP, W_IMG, H_IMG, dev)
    pts, pred, valid, kind = lk_bench.edge_case_keypoints(
        good[corner].cpu().numpy(), KP_CAP, H_IMG, W_IMG, FLAT, seed=648,
        per_kind=24)
    edge = (ea, eb, *(torch.from_numpy(x).to(dev) for x in (pts, pred, valid)))
    st_k = klt.lk_track_fwd_rev(*edge)[1].cpu().numpy()
    st_p = klt.lk_track_fwd_rev_plain(*edge)[1].cpu().numpy()
    print(f"[A] edge-case set ({', '.join(lk_bench.EDGE_KINDS)}: 24 each among "
          f"{int((kind < 0).sum())} ordinary points): status differs on "
          f"{int((st_k != st_p).sum())} of {KP_CAP} slots; edge cases tracked "
          f"{int(st_k[kind >= 0].sum())}, ordinary tracked {int(st_k[kind < 0].sum())}")
    check((st_k == st_p).all(), "phase A: status differs on the edge-case set")
    check(not st_k[kind >= 0].any(), "phase A: an edge case was tracked")
    check(st_k[kind < 0].mean() >= 0.5, "phase A: ordinary points of the edge set lost")

    # one level-0 call on identical inputs: the level kernel's own time
    lvl = (pa[0], pb[0], (pix + klt.PADB).contiguous(),
           (pix + klt.PADB).contiguous(), val)
    lvl_k = lambda: klt.lk_level(*lvl)  # noqa: E731
    lvl_p = lambda: klt.lk_level_plain(*lvl)  # noqa: E731
    (lt_k, le_k), (lt_p, le_p) = lvl_k(), lvl_p()
    lvl_iters = int(klt.lk_level_iters(*lvl)[2].sum())
    ok = le_p > 1e-4  # the status rule's conditioning gate
    lvl_d = torch.linalg.vector_norm(lt_k - lt_p, dim=-1)[ok]
    lvl_err = float((lt_k - lt_p)[ok].abs().max())
    eig_err = float(((le_k - le_p).abs() / le_p.abs().clamp(min=1e-6)).max())
    print(f"[A] one level-0 call, same inputs: max |tracked diff| {lvl_err:.3e} "
          f"px over {int(ok.sum())} keypoints with min_eig > 1e-4, max relative "
          f"min_eig diff {eig_err:.3e}")
    check(float(lvl_d.median()) <= 1e-3 and float((lvl_d <= 1e-2).float().mean())
          >= 0.995, "phase A: level-0 kernel against plain: median tracked "
          "difference > 1e-3 px or fewer than 99.5% of keypoints within 1e-2 px")

    # times, in alternation: fused launch, per-level kernel path (8 launches
    # and the tensor operations around them), plain; one level, plain level.
    # Device time is taken with the host running ahead of the device; "loop"
    # is the time per call of a caller that waits for nothing, host included
    for fn in (run_f, run_l, run_p, lvl_k, lvl_p):  # warm-up
        fn()
    times = {}
    for name, fn, reps in (("fused", run_f, 200), ("levels", run_l, 20),
                           ("plain", run_p, 5), ("level", lvl_k, 200),
                           ("level_plain", lvl_p, 10)) * 3:
        times.setdefault(name, []).append(lk_bench.cuda_ms(fn, reps))
        if name in ("fused", "levels", "level"):
            times.setdefault(name + "_loop", []).append(
                lk_bench.cuda_ms(fn, reps, run_ahead=False))
            times.setdefault(name + "_host", []).append(
                lk_bench.host_us(fn, reps) * 1e-3)
    ms = {k: float(np.mean(v)) for k, v in times.items()}
    print(f"[A] device ms per call (CUDA events, host running ahead, 3 "
          f"alternating runs): lk_track_fwd_rev fused kernel (1 launch) "
          f"{ms['fused']:.4f}, per-level kernel path (8 launches) "
          f"{ms['levels']:.4f}, plain {ms['plain']:.4f}; lk_level kernel "
          f"{ms['level']:.4f}, plain {ms['level_plain']:.4f}")
    print(f"[A] ms per call in a loop, host included (and the host's own time "
          f"to enqueue a call): fused {ms['fused_loop']:.4f} "
          f"({ms['fused_host']:.4f}), per-level kernel path "
          f"{ms['levels_loop']:.4f} ({ms['levels_host']:.4f}), lk_level "
          f"{ms['level_loop']:.4f} ({ms['level_host']:.4f})")

    # bounds from this run's shapes and counted iterations: every input read
    # once, every output written once; a keypoint that is not iterated
    # (invalid, or rejected before the reverse track) costs the fused kernel
    # nothing, while one level call computes min_eig for every slot
    n = KP_CAP
    work = [(int(v), int(i)) for v, i in work]
    pyr_bytes = sum(2 * a.numel() * 4 for a in pa)
    b_f, by_f = bound(pyr_bytes + n * (8 + 8 + 1) + n * (8 + 1),
                      sum(v * FLOP_LEVEL_SETUP + i * FLOP_ITERATION for v, i in work))
    b_l, by_l = bound(2 * pa[0].numel() * 4 + n * (8 + 8 + 1) + n * (8 + 4),
                      n * FLOP_LEVEL_SETUP + lvl_iters * FLOP_ITERATION)
    it_f = sum(i for _, i in work) / max(sum(v for v, _ in work), 1)
    print(f"[A] bounds: lk_fwd_rev {b_f * 1e3:.3f} us by {by_f} ("
          f"{sum(v for v, _ in work)} keypoint-levels, {it_f:.2f} iterations "
          f"each on average), lk_level {b_l * 1e3:.3f} us by {by_l} "
          f"({lvl_iters / n:.2f} iterations per keypoint); bound over time: "
          f"fused kernel {b_f / ms['fused']:.4f}, level kernel "
          f"{b_l / ms['level']:.4f}")
    common = {"route": "cuda", "source": "rd_vio_tpu_torch/csrc/lk_track.cu",
              "replaces": "rd_vio_tpu/ops/image/klt_pallas.py:67",
              "library_ms": None}
    return [
        {"name": "lk_fwd_rev", **common, "max_abs_err": mx, "ms": ms["fused"],
         "plain_ms": ms["plain"], "bound_ms": b_f, "bound_by": by_f,
         "loop_ms": ms["fused_loop"], "levels_path_ms": ms["levels"],
         "levels_path_loop_ms": ms["levels_loop"]},
        {"name": "lk_level", **common, "max_abs_err": lvl_err, "ms": ms["level"],
         "plain_ms": ms["level_plain"], "bound_ms": b_l, "bound_by": by_l,
         "loop_ms": ms["level_loop"]},
    ]


class FrameSink:
    """Stands where the estimator's frontend sits: receives every finalized
    frame (FeatureTracker.frontend.issue_frame) and records its keypoints."""

    initializing = True
    latest_optimized = None

    def __init__(self, ft: FeatureTracker):
        self.ft = ft
        self.frames = []  # (t, pix (n, 2), continued (n,) bool)
        self.prev = None

    def issue_frame(self, frame):
        pix = self.ft._pix_from_bearings(frame)
        cont = np.zeros(len(pix), bool)
        if self.prev is not None:
            tracks = self.ft.map.tracks
            for k, tid in enumerate(frame.track_ids):
                t = tracks.get(int(tid))
                cont[k] = t is not None and self.prev.id in t.obs
        self.frames.append((frame.t, pix, cont))
        self.prev = frame


def run_slice(cfg, seq, frames, dev, lk, timer=None):
    """Handler -> FeatureTracker -> TorchImageBackend over `frames`; returns
    (sink, wall-clock stamps after each frame, tracker)."""
    backend = TorchImageBackend(cfg, dev, kp_cap=KP_CAP, lk=lk)
    ft = FeatureTracker(cfg, builders.CalibArrays.from_config(cfg),
                        builders.Caps(), backend)
    sink = FrameSink(ft)
    ft.frontend = sink
    ft.device_timer = timer
    handler = Handler(cfg, ft, None)
    t_last = seq.t_frame[len(frames) - 1]
    events = sorted([(t, 1, i) for i, t in enumerate(seq.t_imu) if t <= t_last + 0.02]
                    + [(t, 0, i) for i, t in enumerate(seq.t_frame[:len(frames)])])
    stamps = []
    for t, kind, i in events:
        if kind == 1:
            handler.track_motion(t, seq.gyro[i], seq.accel[i])
        else:
            if timer is not None:
                with timer.time("preprocess"):
                    img = backend.preprocess(frames[i])
            else:
                img = backend.preprocess(frames[i])
            handler.track_camera(t, img)
            stamps.append(time.perf_counter())
    ft.flush()
    torch.cuda.synchronize()
    stamps.append(time.perf_counter())
    return sink, stamps, ft


B_FRAMES = 45  # phase B's frames (90 before phase G was added)


def phase_b(cfg, seq, frames, dev):
    frames = frames[:B_FRAMES]
    timer = DeviceStageTimer()
    GLOBAL_TIMER.reset()
    klt.launches = klt.fwd_rev_launches = 0
    sink, stamps, ft = run_slice(cfg, seq, frames, dev, klt.lk_track_fwd_rev, timer)
    launches, level_launches = klt.fwd_rev_launches, klt.launches
    n = len(frames)
    half = n // 2
    fps = (n - half) / (stamps[-1] - stamps[half])
    dev_stats = timer.stats()
    host = GLOBAL_TIMER.stats()
    kp = np.array([len(p) for _, p, _ in sink.frames])
    cont = np.array([c.mean() if len(c) else 0.0 for _, _, c in sink.frames[1:]])
    check(len(sink.frames) == n - 1, f"phase B: {len(sink.frames)} frames issued")
    for _, p, _ in sink.frames:
        check(np.isfinite(p).all() and (p[:, 0] >= 0).all() and (p[:, 0] < W_IMG).all()
              and (p[:, 1] >= 0).all() and (p[:, 1] < H_IMG).all(),
              "phase B: keypoint outside the image")
    st = ft.latest_state
    check(st is not None and all(np.isfinite(np.asarray(x)).all() for x in st[1:]),
          "phase B: non-finite IMU-predicted state")
    print(f"[B] {n} frames {W_IMG}x{H_IMG}: frontend {fps:.2f} frames/s over "
          f"the second half ({stamps[-1] - stamps[0]:.1f} s in all)")
    for k in ("preprocess", "ft.step", "ft.lk", "ft.masks", "ft.poisson", "ft.gftt"):
        s = dev_stats[k]
        print(f"[B] device span {k}: mean {s['mean_ms']:.3f} ms p50 "
              f"{s['p50_ms']:.3f} p90 {s['p90_ms']:.3f} (n={s['n']})")
    for k, s in sorted(host.items()):
        print(f"[B] host {k}: mean {s['mean_ms']:.3f} ms p50 {s['p50_ms']:.3f} "
              f"p90 {s['p90_ms']:.3f} (n={s['n']})")
    print(f"[B] keypoints per frame: median {np.median(kp):.0f} min {kp.min()} "
          f"max {kp.max()}; share continued from the previous frame: mean "
          f"{cont.mean():.3f}; FT_NO_TRANSLATION frames "
          f"{sum(f.tag('no_translation') for f in ft.map.frames)} of the last "
          f"{ft.map.frame_num}")
    print(f"[B] lk_fwd_rev kernel launches: {launches} (frames - 1 = {n - 1}); "
          f"lk_level launches: {level_launches}")
    check(launches == n - 1, f"phase B: {launches} fused launches, not {n - 1}")
    check(level_launches == 0, "phase B: the main path launched the level kernel")
    check(np.median(kp) >= 100, f"phase B: median keypoints {np.median(kp)} < 100")
    return sink, launches, {"fps": fps, "device": dev_stats, "host": host}


def rerun(cfg, seq, frames, dev, sink_b, lk, label):
    """The first frames of B again with another tracker on the card; its
    keypoint slots must agree with B on >= 98%."""
    sink, _, _ = run_slice(cfg, seq, frames, dev, lk)
    agree = []
    for (_, pb, _), (_, pc, _) in zip(sink_b.frames, sink.frames):
        m = max(len(pb), len(pc))
        if m == 0:
            continue
        d = np.linalg.norm(pb[:, None] - pc[None], axis=-1) if len(pb) and len(pc) else None
        hit = 0 if d is None else int((d.min(axis=1) <= 0.01).sum())
        agree.append(hit / m)
    a = float(np.mean(agree))
    print(f"{label}: keypoint slots agreeing with B (within 0.01 px, over the "
          f"larger count): {a:.4f} (per frame min {min(agree):.4f})")
    check(a >= 0.98, f"{label}: slot agreement {a:.4f} < 0.98")
    return a


def phase_c(cfg, seq, frames, dev, sink_b):
    rerun(cfg, seq, frames[:10], dev, sink_b, klt.lk_track_fwd_rev_plain,
          "[C] first 10 frames with the plain LK tracker on the card")


def phase_d(cfg, seq, frames, dev, sink_b):
    """The per-level kernel's path: the slice with one `lk_level` launch per
    level and direction (8 per tracked frame), over the first 10 frames."""
    klt.launches = klt.fwd_rev_launches = 0
    rerun(cfg, seq, frames[:10], dev, sink_b,
          functools.partial(klt.lk_track_fwd_rev_plain, level=klt.lk_level),
          "[D] first 10 frames through the per-level kernel")
    launches = klt.launches
    print(f"[D] lk_level kernel launches: {launches} (8 x 9 tracked frames)")
    check(launches == 8 * 9, f"phase D: {launches} lk_level launches, not 72")
    check(klt.fwd_rev_launches == 0, "phase D: the fused kernel was launched")
    return launches


# phase E: bench.py's Caps (W, L, O) and the reference profile's budget
E_W, E_L, E_O, E_ITERS = 15, 256, 2560, 30
H100_F64_FLOP_PER_S = 67e12  # f64 on the tensor cores, NVIDIA H100 SXM data sheet


def count_syncs(fn):
    """(fn(), the host syncs it made) as torch.cuda's sync debug mode
    reports them (each a warning)."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum("synchronizing CUDA operation" in str(w.message) for w in caught)


def time_call(fn, reps=3):
    """fn() once to warm up, then reps times: (median device ms between two
    CUDA events around the call, median ms of the call with the host and a
    final synchronise)."""
    fn()
    torch.cuda.synchronize()
    dev_ms, host_ms = [], []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        host_ms.append((time.perf_counter() - t0) * 1e3)
        dev_ms.append(start.elapsed_time(end))
    return statistics.median(dev_ms), statistics.median(host_ms)


def profile_call(fn):
    """(kernels the device ran, their summed ms) in one fn() under
    torch.profiler, tracing the device only (host-side tracing of the
    ~10^5 operator calls of a solve costs minutes to post-process)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels, kernel_us = 0, 0.0
    for e in prof.key_averages():
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            kernels += e.count
            kernel_us += getattr(e, "self_device_time_total",
                                 getattr(e, "self_cuda_time_total", 0.0))
    return kernels, kernel_us * 1e-3


def to_cpu(tree):
    return torch.utils._pytree.tree_map(lambda a: a.cpu(), tree)


def phase_e(seq, dev):
    """The window VI-BA solve and frame-0 marginalization at the main path's
    shapes on the card; returns the `estimator` record."""
    t0 = time.perf_counter()
    gt, invd_gt, pb, n_lm, n_obs = build_window_problem(
        seq, f0=10, W=E_W, L_max=E_L, O_max=E_O, device=dev)
    s0, invd0, pb = perturbed_start(gt, invd_gt, pb)
    torch.cuda.synchronize()
    print(f"[E] window problem W={E_W} L={E_L} O={E_O} on the card: {n_lm} tracks, "
          f"{n_obs} observations, D={E_W * 15} camera columns, built in "
          f"{time.perf_counter() - t0:.2f} s; frame 0 fixed, test_ba.py's perturbation")
    check(n_lm > 100 and n_obs > 1000, "phase E: the window holds too few tracks")
    rec = {"W": E_W, "L": E_L, "O": E_O, "tracks": n_lm, "observations": n_obs}

    for name, dtype in (("f64", torch.float64), ("f32", torch.float32)):
        args = builders.cast_floats((s0, invd0, pb), dtype)
        solve = lambda args=args: ba.solve_ba(*args, max_iterations=E_ITERS)  # noqa: E731
        timed = dtype == torch.float64  # the f32 solve (~7-11 s) is checked, not timed
        if timed:
            dev_ms, host_ms = time_call(solve, 1)  # its first call warms up
        timer = DeviceStageTimer()  # records events only: no sync of its own
        res, syncs = count_syncs(
            lambda: ba.solve_ba(*args, max_iterations=E_ITERS, timer=timer))
        spans = timer.stats()
        steps = spans["ba.build_normal_system"]["n"]
        acc = int(res.iterations)
        c0, c1 = float(res.initial_cost), float(res.cost)
        p_err = float((res.states.p - gt.p.to(dtype)).abs().max())
        finite = all(bool(torch.isfinite(a).all()) for a in (*res.states, res.inv_depth,
                                                             res.cost))
        print(f"[E] solve_ba {name}: {acc} accepted of {steps} LM iterations; cost "
              f"{c0:.6e} -> {c1:.6e} ({c0 / max(c1, 1e-300):.3e} x); max position "
              f"error {p_err:.3e} m; all finite {finite}; host syncs per solve {syncs}")
        print(f"[E] solve_ba {name} device spans per iteration: " + ", ".join(
            f"{k.split('.', 1)[1]} {v['mean_ms']:.3f} ms (n={v['n']})"
            for k, v in spans.items()))
        check(finite, f"phase E: non-finite {name} solve")
        rec[name] = {"accepted": acc, "iterations": steps, "initial_cost": c0, "cost": c1,
                     "max_position_error_m": p_err, "host_syncs": syncs,
                     "spans_ms": {k: v["mean_ms"] for k, v in spans.items()}}
        if timed:
            kernels, kernel_ms = profile_call(solve)
            print(f"[E] solve_ba {name}: device ms per solve {dev_ms:.3f} (CUDA events, "
                  f"one solve after a warm-up), per LM iteration {dev_ms / steps:.3f}; ms "
                  f"per call with the host {host_ms:.3f}; kernels per solve {kernels} "
                  f"({kernels / steps:.0f} per iteration), summed kernel time "
                  f"{kernel_ms:.3f} ms (busy share {kernel_ms / dev_ms:.3f})")
            rec[name].update({"device_ms": dev_ms, "device_ms_per_iteration": dev_ms / steps,
                              "host_ms": host_ms, "kernels": kernels,
                              "kernel_ms": kernel_ms})
        check(c1 <= 1e-3 * c0, f"phase E: {name} cost fell only {c0 / c1:.3e} x")
        check(p_err <= 5e-3, f"phase E: {name} position error {p_err:.3e} m > 5e-3")
        if dtype == torch.float64:
            res64 = res

    # the card against the port's CPU solve of the same inputs
    t0 = time.perf_counter()
    ref = ba.solve_ba(*to_cpu((s0, invd0, pb)), max_iterations=E_ITERS)
    dp = float((res64.states.p.cpu() - ref.states.p).abs().max())
    dit = int(res64.iterations) - int(ref.iterations)
    print(f"[E] f64 card against CPU (same inputs; CPU solve {time.perf_counter() - t0:.1f} "
          f"s): accepted steps {int(res64.iterations)} vs {int(ref.iterations)}, max "
          f"position difference {dp:.3e} m, costs {float(res64.cost):.6e} vs "
          f"{float(ref.cost):.6e}")
    check(abs(dit) <= 1, "phase E: card and CPU differ by more than one accepted step")
    check(dp <= 1e-6, f"phase E: card and CPU positions differ by {dp:.3e} m > 1e-6")
    rec["f64_card_vs_cpu"] = {"accepted_diff": dit, "max_position_diff_m": dp}

    # frame-0 marginalization on the f64 solution: the factors that touch
    # slot 0 (tracks anchored there, the first IMU factor) and the prior
    rf, imu = pb.reproj, pb.imu
    pb_m = pb._replace(reproj=rf._replace(valid=rf.valid & (rf.ref == 0)),
                       imu=imu._replace(valid=imu.valid & (imu.i == 0)))
    marg = lambda: marginalization.marginalize_frame0(  # noqa: E731
        res64.states, res64.inv_depth, pb_m)
    m_dev, m_host = time_call(marg)  # its first call warms up
    prior, m_syncs = count_syncs(marg)
    S, iv = prior.sqrt_inv_cov, prior.infovec
    info = S.mT @ S
    asym = float((info - info.mT).abs().max())
    eig = torch.linalg.eigvalsh(info)
    scale = float(eig.abs().max())
    ok = (bool(torch.isfinite(S).all()) and bool(torch.isfinite(iv).all())
          and asym <= 1e-12 * scale and float(eig.min()) >= -1e-9 * scale)
    ref_m = marginalization.marginalize_frame0(ref.states, ref.inv_depth, to_cpu(pb_m))
    info_ref = ref_m.sqrt_inv_cov.mT @ ref_m.sqrt_inv_cov
    d_info = float((info.cpu() - info_ref).abs().max()) / float(info_ref.abs().max())
    print(f"[E] marginalize_frame0 f64: device ms {m_dev:.3f} (median of 3), ms per call "
          f"with the host {m_host:.3f}, host syncs {m_syncs}; S^T S: max asymmetry "
          f"{asym:.3e}, eigenvalues {float(eig.min()):.3e} .. {scale:.3e}, rank "
          f"{int((eig > 1e-8 * scale).sum())} of {E_W * 15}; against the CPU's "
          f"marginalization of the CPU solution: {d_info:.3e} relative")
    check(ok, "phase E: the marginalization prior is not finite, symmetric and PSD")
    check(d_info <= 1e-6, f"phase E: card and CPU priors differ by {d_info:.3e}")
    rec["marginalize_frame0"] = {"device_ms": m_dev, "host_ms": m_host,
                                 "host_syncs": m_syncs, "info_vs_cpu": d_info}
    # two-view triangulation (one batched eigh) of the tracks that slot 0
    # anchors and slot 1 sees, from the true poses (identity extrinsics:
    # the camera is the body), against the true points
    sel = ((rf.ref == 0) & (rf.tgt == 1) & rf.valid).nonzero()[:, 0]
    q_cw = lie.quat_conj(gt.q[:2])
    p_cw = -lie.quat_rotate(q_cw, gt.p[:2])
    (pts, tri_ok), t_syncs = count_syncs(lambda: triangulate.triangulate_two_view(
        rf.z_ref[sel], rf.z_tgt[sel], q_cw[0], p_cw[0], q_cw[1], p_cw[1]))
    truth = lie.quat_rotate(gt.q[0], rf.z_ref[sel] / invd_gt[rf.lm[sel].long(), None]) + gt.p[0]
    t_err = float((pts - truth).abs().max())
    print(f"[E] triangulate_two_view f64 of {len(sel)} tracks (slots 0 and 1): max error "
          f"{t_err:.3e} m against the true points, all ok {bool(tri_ok.all())}, host "
          f"syncs {t_syncs}")
    check(len(sel) >= 20 and bool(tri_ok.all()) and t_err <= 1e-6,
          "phase E: two-view triangulation")
    rec["triangulate_two_view"] = {"tracks": len(sel), "max_error_m": t_err,
                                   "host_syncs": t_syncs}

    # what the arithmetic needs per LM iteration: J_all^T J_all (2 R D^2
    # operations, f64) and reading J_all once
    rows = 2 * E_O + 2 + 15 * (E_W - 1) + 15 + 2 + 15 * E_W
    flop, nbytes = 2 * rows * (15 * E_W) ** 2, rows * 15 * E_W * 8
    t_min = max(flop / H100_F64_FLOP_PER_S, nbytes / H100_BYTES_PER_S) * 1e3
    print(f"[E] J^T J per LM iteration: {rows} rows x {15 * E_W} columns, {flop / 1e9:.3f} "
          f"GFLOP, {nbytes / 1e6:.1f} MB: >= {t_min * 1e3:.2f} us on this card, against "
          f"{rec['f64']['device_ms_per_iteration']:.3f} ms per f64 iteration")
    rec["normal_matmul_bound_ms"] = t_min
    return rec


# phase F: the main path, Odometry over the first F_FRAMES frames of B's
# sequence with bench.py's Caps (bench.py:269) and profile
F_CAPS = builders.Caps(W=15, L=256, O=2560, Fi=16, R=128, IMU=64, IMU_KF=384)
F_FRAMES = 90
# the JAX package's ATE on the same F_FRAMES frames, config and Caps, on the
# CPU: `JAX_PLATFORMS=cpu python scripts/jax_ate_reference.py 160`, the line
# of n = 90 (jaxlib on the CPU, synchronous, JaxImageBackend)
F_ATE_JAX_CPU_M = 0.007106972188503752
F_ATE_BOUND_M = max(2 * F_ATE_JAX_CPU_M, F_ATE_JAX_CPU_M + 0.01)
F_PROFILE_FRAMES = 1  # frames traced by torch.profiler at the end of the run
# card against CPU on one fused keyframe step. The f32 window solve stops on
# a relative decrease of 1e-6, a few f32 ulps, which the card's atomic sums
# and the CPU's sequential ones cross on different iterations: accepted
# steps differed by 0, 1, 1 and 2 in four runs, the positions by 4.9e-7 to
# 2.7e-5 m. The marginalization prior taken at each side's own solution
# differed by 1.1e-8 to 5.5e-7 relative (the solutions differ); taken at the
# same solution it is the f64 program alone.
F_STEP_DIFFS = 4  # accepted steps the two window solves may differ by
F_MASK_DIFFS = 5  # validation verdicts the card and the CPU may differ on
F_PRIOR_OWN = 1e-5  # S^T S, each at its own solution, relative
F_PRIOR_SAME = 1e-6  # S^T S at the card's solution, relative


def phase_f(cfg, seq, frames, dev):
    """`Odometry(cfg, TorchImageBackend(cfg, kp_cap=384), caps=F_CAPS)` over
    the first F_FRAMES rendered frames in bench.py's event order; returns
    the `odometry` record and the fused LK kernel's launches."""
    klt.launches = klt.fwd_rev_launches = 0
    GLOBAL_TIMER.reset()
    builders.PROGRAM_STATS.clear()
    builders.KF_FUSED_COUNT.n = 0
    builders.CAPTURE_KEYFRAME, builders.CAPTURED_KEYFRAME = True, None
    odo = Odometry(cfg, TorchImageBackend(cfg, dev, kp_cap=KP_CAP), caps=F_CAPS)
    check(odo.device == dev, "phase F: Odometry is not on the card")
    t_last = seq.t_frame[F_FRAMES - 1]
    events = sorted([(t, 1, i) for i, t in enumerate(seq.t_imu) if t <= t_last + 0.02]
                    + [(t, 0, i) for i, t in enumerate(seq.t_frame[:F_FRAMES])])
    est_t, est_p, wall, kinds, syncs, states = [], [], [], [], [], []
    # per frame: the wall time, host syncs and keyframe steps from the end of
    # the previous frame event to the end of this one (the Handler runs a
    # frame's work when the IMU samples after it arrive, inside add_motion)
    marg = lambda: GLOBAL_TIMER.samples.get("swt.marginalize", ())  # noqa: E731
    n_marg = 0
    prof = None
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            n0, t0 = 0, time.perf_counter()
            for t, kind, i in events:
                if kind == 1:
                    odo.add_motion(t, seq.gyro[i], seq.accel[i])
                    continue
                if i == F_FRAMES - F_PROFILE_FRAMES:
                    from torch.profiler import ProfilerActivity, profile

                    torch.cuda.synchronize()
                    p = profile(activities=[ProfilerActivity.CUDA])
                    p.__enter__()
                    prof, t_prof = p, time.perf_counter()
                odo.add_frame(t, frames[i])
                wall.append(time.perf_counter() - t0)
                syncs.append(sum("synchronizing CUDA operation" in str(w.message)
                                 for w in caught[n0:]))
                kinds.append("keyframe" if len(marg()) > n_marg else "subframe")
                n_marg = len(marg())
                n0, t0 = len(caught), time.perf_counter()
                states.append(odo.state())
                if states[-1] == 1:
                    ls = odo.handler.get_latest_state()
                    if ls is not None and (not est_t or ls[0] != est_t[-1]):
                        est_t.append(ls[0])
                        est_p.append(ls[2])
            torch.cuda.synchronize()
        finally:
            torch.cuda.set_sync_debug_mode("default")
            if prof is not None:
                t_prof = time.perf_counter() - t_prof
                prof.__exit__(None, None, None)
    launches = klt.fwd_rev_launches
    level_launches = klt.launches
    builders.CAPTURE_KEYFRAME = False
    programs = {k: dict(v) for k, v in builders.PROGRAM_STATS.items()}
    host = GLOBAL_TIMER.stats()

    check(2 not in states, "phase F: the system reported a crash")
    check(1 in states, "phase F: the system never reached tracking")
    first = states.index(1)
    bootstraps = odo.frontend.bootstraps
    tracked = [k for k, s in enumerate(states) if s == 1]
    est_p = np.asarray(est_p)
    check(np.isfinite(est_p).all(), "phase F: a non-finite published pose")
    swt = odo.frontend.swt
    check(swt is not None, "phase F: no sliding-window tracker at the end")
    for f in swt.map.all_frames():
        check(all(np.isfinite(np.asarray(x)).all() for x in (f.q, f.p, f.v, f.bg, f.ba)),
              "phase F: a non-finite window state")
    n_kf = builders.KF_FUSED_COUNT.n
    n_tail = programs.get("marginalize_tail", {}).get("calls", 0)
    gt_by_t = {round(tt, 6): p for tt, p in zip(seq.t_frame, seq.p_wb)}
    ate = float(ate_rmse(est_p, np.stack([gt_by_t[round(tt, 6)] for tt in est_t])))

    tr_wall = float(sum(wall[k] for k in tracked))
    by_kind = {k: [1e3 * wall[i] for i in tracked if kinds[i] == k]
               for k in ("subframe", "keyframe")}
    kernels = kernel_ms = None
    if prof is not None:
        kernels, kernel_ms = 0, 0.0
        for e in prof.key_averages():
            if str(getattr(e, "device_type", "")).endswith("CUDA"):
                kernels += e.count
                kernel_ms += 1e-3 * getattr(e, "self_device_time_total",
                                            getattr(e, "self_cuda_time_total", 0.0))
    rec = {
        "frames": F_FRAMES, "first_tracked_frame": first, "tracked_frames": len(tracked),
        "bootstraps": bootstraps, "rebootstraps": bootstraps - 1,
        "keyframe_fused_steps": n_kf, "marginalize_tail_runs": n_tail,
        "frames_per_s_tracked": len(tracked) / tr_wall,
        "ms_per_frame": {k: {"n": len(v), "mean": float(np.mean(v)) if v else None,
                             "p50": float(np.median(v)) if v else None,
                             "max": float(np.max(v)) if v else None}
                         for k, v in by_kind.items()},
        "host_syncs_per_frame": {"mean_tracked": float(np.mean([syncs[k] for k in tracked])),
                                 "max": int(max(syncs)), "all_frames": int(sum(syncs))},
        "programs": {k: {"calls": v["calls"], "solves": v["solves"],
                         "lm_iterations": v["iterations"],
                         "lm_iterations_per_solve": v["iterations"] / max(v["solves"], 1)}
                     for k, v in programs.items()},
        "spans_ms": {k: {"n": v["n"], "mean": v["mean_ms"], "p50": v["p50_ms"],
                         "p90": v["p90_ms"]} for k, v in host.items()},
        "profiled_frames": F_PROFILE_FRAMES, "kernels_per_frame":
            None if kernels is None else kernels / F_PROFILE_FRAMES,
        "device_busy_share": None if kernel_ms is None else kernel_ms / (1e3 * t_prof),
        "lk_fwd_rev_launches": launches, "lk_level_launches": level_launches,
        "ate_m": ate, "ate_jax_cpu_m": F_ATE_JAX_CPU_M, "ate_bound_m": F_ATE_BOUND_M,
    }
    print(f"[F] Odometry over {F_FRAMES} frames {W_IMG}x{H_IMG}: first tracked frame "
          f"{first}, {len(tracked)} tracked, bootstraps {bootstraps} (re-bootstraps "
          f"{bootstraps - 1}), fused keyframe steps {n_kf}, marginalize_tail runs {n_tail}")
    print(f"[F] {rec['frames_per_s_tracked']:.3f} frames/s over the tracked frames "
          f"({tr_wall:.1f} s); ms per frame: " + "; ".join(
              f"{k} n={v['n']} mean {v['mean']:.0f} p50 {v['p50']:.0f} max {v['max']:.0f}"
              for k, v in rec["ms_per_frame"].items() if v["n"]))
    print(f"[F] host syncs per tracked frame: mean "
          f"{rec['host_syncs_per_frame']['mean_tracked']:.1f}, max {max(syncs)}")
    for k, v in sorted(rec["programs"].items()):
        print(f"[F] program {k}: {v['calls']} calls, {v['solves']} solves, "
              f"{v['lm_iterations_per_solve']:.1f} LM iterations per solve")
    for k, v in sorted(host.items()):
        print(f"[F] span {k}: mean {v['mean_ms']:.1f} ms p50 {v['p50_ms']:.1f} "
              f"p90 {v['p90_ms']:.1f} (n={v['n']})")
    if kernels is not None:
        print(f"[F] last {F_PROFILE_FRAMES} frames under torch.profiler: "
              f"{kernels / F_PROFILE_FRAMES:.0f} kernels per frame, summed kernel time "
              f"{kernel_ms:.1f} ms in {1e3 * t_prof:.0f} ms (busy share "
              f"{rec['device_busy_share']:.4f})")
    print(f"[F] lk_fwd_rev kernel launches: {launches} (tracked frame pairs = "
          f"{F_FRAMES - 1}); lk_level launches: {level_launches}")
    print(f"[F] ATE (SE3-aligned RMSE of {len(est_p)} estimates) {ate:.5f} m; JAX on the "
          f"CPU {F_ATE_JAX_CPU_M:.5f} m; bound {F_ATE_BOUND_M:.5f} m")
    check(launches == F_FRAMES - 1,
          f"phase F: {launches} fused LK launches, not {F_FRAMES - 1}")
    check(level_launches == 0, "phase F: the main path launched the level kernel")
    check(n_kf >= 3, f"phase F: only {n_kf} fused keyframe steps")
    check(n_tail >= 3, f"phase F: only {n_tail} marginalize_tail runs")
    check(ate <= F_ATE_BOUND_M, f"phase F: ATE {ate:.5f} m > {F_ATE_BOUND_M:.5f} m")
    rec["card_vs_cpu"] = keyframe_card_vs_cpu()
    return rec, launches, wall, swt


def keyframe_card_vs_cpu(ph="F", card_replays=0):
    """The first fused keyframe step after the window filled, as it ran on
    the card (builders.CAPTURED_KEYFRAME kept its inputs and outputs; phase
    K: the first async step, its chain's previous states included), and run
    again on the CPU: the f32 window solve's positions within 1e-4 m, the
    validation verdicts equal on all but F_MASK_DIFFS tracks; the f64
    marginalization prior's S^T S within F_PRIOR_OWN relative, each at its
    own solution, and within F_PRIOR_SAME with the CPU marginalizing at the
    card's solution. Phase F (noisy inputs): the accepted steps within
    F_STEP_DIFFS. Phase K (`card_replays` > 0, noise-free inputs): the step
    is solved `card_replays` more times on the card, and every card solve's
    final cost lies within K_COST_REL of the CPU's."""
    captured = builders.CAPTURED_KEYFRAME
    check(captured is not None, f"phase {ph}: no keyframe step captured")
    (a, prior, calib, it, prev, lip), (res_g, _, v_g, ok_g, tri_g, prior_g) = captured
    info = lambda p: (p.sqrt_inv_cov.to("cpu", torch.float64).mT  # noqa: E731
                      @ p.sqrt_inv_cov.to("cpu", torch.float64))
    prior_c, calib_c = to_cpu((prior, calib))
    prev_c = None if prev is None else to_cpu(prev)
    t0 = time.perf_counter()
    res_c, _, v_c, _, _, prior_cc = builders.run_keyframe_fused(a, prior_c, calib_c, it,
                                                               prev=prev_c, loc_ip_prev=lip)
    t_cpu = time.perf_counter() - t0
    same = builders.marginalize_tail(
        *to_cpu((res_g.states, res_g.inv_depth, v_g, tri_g, ok_g)), a["pa_m"],
        *(torch.from_numpy(a[k]) for k in ("mlm_vti", "mlm_from_w", "mlm_tri")),
        prior_c, calib_c)
    it_g, it_c = int(res_g.iterations), int(res_c.iterations)
    dp = float((res_g.states.p.cpu().double() - res_c.states.p.double()).abs().max())
    n_diff = int((v_g.cpu() != v_c).sum())
    rel = lambda x, y: float((x - y).abs().max() / y.abs().max())  # noqa: E731
    d_own = rel(info(prior_g), info(prior_cc))
    d_same = rel(info(prior_g), info(same))
    rec = {"window_dtype": str(res_g.states.p.dtype), "accepted_steps": [it_g, it_c],
           "max_position_diff_m": dp, "validation_differs": n_diff,
           "validation_tracks": int(v_c.numel()), "prior_info_rel_diff": d_own,
           "prior_info_rel_diff_same_solution": d_same, "cpu_replay_s": t_cpu}
    print(f"[{ph}] keyframe step card against CPU: accepted steps {it_g} / {it_c}, "
          f"positions within {dp:.3e} m, validation differs on {n_diff} of "
          f"{v_c.numel()} slots, prior S^T S within {d_own:.3e} relative (each at its "
          f"own solution), {d_same:.3e} (the CPU at the card's solution); the CPU's "
          f"replay took {t_cpu:.1f} s")
    if card_replays:
        runs = [builders.run_keyframe_fused(a, prior, calib, it, prev=prev,
                                            loc_ip_prev=lip)[0]
                for _ in range(card_replays)]
        steps = [it_g] + [int(r.iterations) for r in runs]
        costs = [float(c) for c in [res_g.cost] + [r.cost for r in runs]]
        cost_c = float(res_c.cost)
        d_cost = max(abs(c - cost_c) for c in costs) / cost_c
        rec.update(card_steps=steps, card_costs=costs, cpu_cost=cost_c,
                   max_cost_rel_diff=d_cost)
        print(f"[{ph}] the step solved {card_replays} more times on the card: accepted "
              f"steps {steps} (CPU {it_c}), final costs within {d_cost:.3e} "
              f"relative of the CPU's {cost_c:.6g}")
        check(d_cost <= K_COST_REL,
              f"phase {ph}: card and CPU final costs differ by {d_cost:.3e} relative")
    else:
        check(abs(it_g - it_c) <= F_STEP_DIFFS,
              f"phase {ph}: card and CPU window solves differ by > {F_STEP_DIFFS} steps")
    check(dp <= 1e-4, f"phase {ph}: card and CPU positions differ by {dp:.3e} m")
    check(n_diff <= F_MASK_DIFFS, f"phase {ph}: validation differs on {n_diff} tracks")
    check(d_own <= F_PRIOR_OWN, f"phase {ph}: card and CPU priors differ by {d_own:.3e}")
    check(d_same <= F_PRIOR_SAME,
          f"phase {ph}: card and CPU marginalizations of one solution differ by {d_same:.3e}")
    return rec


# phase G: the threaded main path (bench.py's default, `threaded = "--sync"
# not in argv`) with the device PARSAC (parsac_host_masks=False). G_FRAMES is
# the smallest frame count >= 50 at which the JAX package's synchronous CPU
# run with the same config has made >= 8 judge calls and >= 1 chained 2D-2D
# check: `JAX_PLATFORMS=cpu python scripts/jax_ate_reference.py 110
# --device-parsac`, whose first line with chain_calls 1 is n = 88 (judge_calls
# 47); its ATE there is G_ATE_JAX_CPU_M
G_FRAMES = 88
G_ATE_JAX_CPU_M = 0.007730035189931318
G_ATE_BOUND_M = max(2 * G_ATE_JAX_CPU_M, G_ATE_JAX_CPU_M + 0.01)
# the first judge's and chain's inputs replayed on the CPU: the f64 bin sums
# (index_add_) are atomic on the card and sequential on the CPU, so a
# hypothesis whose score ties another's at the last bit may win on one side
G_REPLAY_MASK_DIFFS = 2  # mask slots the card and the CPU may differ on
G_REPLAY_CONF_TOL = 1e-9  # bin confidences (each in [0, 1]), absolute


def phase_g(cfg, seq, frames, dev):
    """`Odometry(cfg_g, TorchImageBackend(cfg_g, kp_cap=384), caps=F_CAPS,
    threaded=True)` over the first G_FRAMES frames in bench.py's event order,
    then join() and close(); cfg_g is F's config with parsac_host_masks=False.
    Returns the `odometry_threaded` record (with the published states' clock
    stamps, for compare_g_with_f) and the fused LK kernel's launches."""
    cfg_g = dataclasses.replace(cfg, parsac_host_masks=False)
    klt.launches = klt.fwd_rev_launches = 0
    GLOBAL_TIMER.reset()
    builders.PROGRAM_STATS.clear()
    builders.KF_FUSED_COUNT.n = 0
    swt_mod.PARSAC_STATS.clear()
    swt_mod.CAPTURED_PARSAC.clear()
    swt_mod.CAPTURE_PARSAC = True
    odo = Odometry(cfg_g, TorchImageBackend(cfg_g, dev, kp_cap=KP_CAP), caps=F_CAPS,
                   threaded=True)
    check(odo.device == dev, "phase G: Odometry is not on the card")
    workers = (odo.handler._ft_worker, odo.handler._fe_worker)
    published = []  # (t, p, host clock) of every published state
    odo.frontend.on_publish = lambda lo: published.append(
        (lo[0], lo[3].copy(), time.perf_counter()))
    t_last = seq.t_frame[G_FRAMES - 1]
    events = sorted([(t, 1, i) for i, t in enumerate(seq.t_imu) if t <= t_last + 0.02]
                    + [(t, 0, i) for i, t in enumerate(seq.t_frame[:G_FRAMES])])
    t0 = time.perf_counter()
    try:
        for t, kind, i in events:
            if kind == 1:
                odo.add_motion(t, seq.gyro[i], seq.accel[i])
            else:
                odo.add_frame(t, frames[i])
        odo.join()  # raises a worker's error
        torch.cuda.synchronize()
        t_join = time.perf_counter() - t0
        latest = odo.handler.get_latest_state()
        healthy = odo.healthy()
    finally:
        swt_mod.CAPTURE_PARSAC = False
        odo.close()  # raises a worker's error too
    launches, level_launches = klt.fwd_rev_launches, klt.launches
    host = GLOBAL_TIMER.stats()
    stats = dict(swt_mod.PARSAC_STATS)
    programs = {k: dict(v) for k, v in builders.PROGRAM_STATS.items()}

    check(healthy, "phase G: a pipeline worker failed")
    check(not any(w.is_alive() for w in workers),
          "phase G: a worker thread is alive after close()")
    check(bool(published), "phase G: the system never reached tracking")
    est_t = np.array([t for t, _, _ in published])
    est_p = np.stack([p for _, p, _ in published])
    check(np.isfinite(est_p).all(), "phase G: a non-finite published pose")
    check(latest is not None and latest[0] == seq.t_frame[G_FRAMES - 1],
          "phase G: after join() the latest state is not the last frame's")
    first = int(np.flatnonzero(np.isclose(seq.t_frame, est_t[0]))[0])
    judged = host.get("swt.judge", {}).get("n", 0)  # frames whose judge ran
    n_judge, n_chain = stats.get("judge", 0), stats.get("chain", 0)
    gt_by_t = {round(tt, 6): p for tt, p in zip(seq.t_frame, seq.p_wb)}
    ate = float(ate_rmse(est_p, np.stack([gt_by_t[round(tt, 6)] for tt in est_t])))

    # throughput over the tracked frames: from the first publish to the last
    # (each publish ends a frame's estimate), against F's synchronous
    # per-frame wall times over the same frame indices
    clock = np.array([c for _, _, c in published])
    n_fps = len(published) - 1
    fps_g = n_fps / (clock[-1] - clock[0]) if n_fps > 0 else float("nan")
    span_sum = lambda k: host[k]["mean_ms"] * host[k]["n"] * 1e-3 if k in host else 0.0  # noqa: E731
    busy_tr, busy_est = span_sum("worker.tracker"), span_sum("worker.estimator")
    judge_g = host.get("swt.judge.parsac", {})
    rec = {
        "frames": G_FRAMES, "first_tracked_frame": first, "tracked_frames": len(published),
        "bootstraps": odo.frontend.bootstraps, "wall_s_to_join": t_join,
        "frames_per_s_tracked": fps_g,
        "worker_busy_s": {"tracker": busy_tr, "estimator": busy_est},
        "judge_calls": n_judge, "frames_judged": judged, "chain_calls": n_chain,
        "judge_parsac_span_ms": judge_g.get("mean_ms"),
        "chain_parsac_span_ms": host.get("swt.status.parsac", {}).get("mean_ms"),
        "programs": {k: {"calls": v["calls"], "solves": v["solves"],
                         "lm_iterations": v["iterations"]} for k, v in programs.items()},
        "spans_ms": {k: {"n": v["n"], "mean": v["mean_ms"], "p50": v["p50_ms"],
                         "p90": v["p90_ms"]} for k, v in host.items()},
        "lk_fwd_rev_launches": launches, "lk_level_launches": level_launches,
        "ate_m": ate, "ate_jax_cpu_m": G_ATE_JAX_CPU_M, "ate_bound_m": G_ATE_BOUND_M,
    }
    print(f"[G] threaded Odometry, device PARSAC, over {G_FRAMES} frames {W_IMG}x{H_IMG}: "
          f"first tracked frame {first}, {len(published)} tracked, bootstraps "
          f"{odo.frontend.bootstraps}, join after {t_join:.1f} s")
    print(f"[G] {fps_g:.3f} frames/s over the tracked frames (threaded)")
    print(f"[G] worker spans summed: tracker {busy_tr:.1f} s, estimator {busy_est:.1f} s, "
          f"wall to join {t_join:.1f} s (overlap share "
          f"{(busy_tr + busy_est - t_join) / max(min(busy_tr, busy_est), 1e-9):.3f} of the "
          f"smaller worker's time)")
    print(f"[G] device judge: {n_judge} imu_parsac_pnp calls on {judged} judged frames; "
          f"{n_chain} parsac_essential_chain calls; span swt.judge.parsac mean "
          f"{judge_g.get('mean_ms', float('nan')):.2f} ms")
    for k, v in sorted(host.items()):
        print(f"[G] span {k}: mean {v['mean_ms']:.1f} ms p50 {v['p50_ms']:.1f} "
              f"p90 {v['p90_ms']:.1f} (n={v['n']})")
    print(f"[G] lk_fwd_rev kernel launches: {launches} (tracked frame pairs = "
          f"{G_FRAMES - 1}); lk_level launches: {level_launches}")
    print(f"[G] ATE (SE3-aligned RMSE of {len(est_p)} estimates) {ate:.5f} m; JAX on the "
          f"CPU (synchronous, device PARSAC) {G_ATE_JAX_CPU_M:.5f} m; bound {G_ATE_BOUND_M:.5f} m")
    check(n_judge == judged and n_judge >= 1,
          f"phase G: {n_judge} device judge calls on {judged} judged frames")
    check(n_chain >= 1, "phase G: no chained 2D-2D check ran")
    check(launches == G_FRAMES - 1,
          f"phase G: {launches} fused LK launches, not {G_FRAMES - 1}")
    check(level_launches == 0, "phase G: the main path launched the level kernel")
    check(ate <= G_ATE_BOUND_M, f"phase G: ATE {ate:.5f} m > {G_ATE_BOUND_M:.5f} m")
    rec["replay"] = parsac_card_vs_cpu()
    from rd_vio_tpu_torch import native

    rec["native_calls"] = dict(native.CALLS)  # this process runs G alone
    return rec, launches


def compare_g_with_f(g_rec, f_rec, wall_f):
    """G's threaded frames/s beside F's synchronous frames/s over the same
    frame indices (G's tracked frames after its first), and G's device judge
    span beside F's host twin; added to G's record."""
    first = g_rec["first_tracked_frame"]
    same = range(first + 1, G_FRAMES)
    fps_f = len(same) / sum(wall_f[k] for k in same)
    twin = f_rec["spans_ms"].get("swt.judge.parsac", {}).get("mean", float("nan"))
    g_rec["frames_per_s_tracked_sync_f_same_frames"] = fps_f
    g_rec["judge_parsac_span_ms_host_twin_f"] = twin
    g_rec["host_cpu_count"] = os.cpu_count()
    print(f"[G] {g_rec['frames_per_s_tracked']:.3f} frames/s over the tracked frames "
          f"(threaded) against F's synchronous {fps_f:.3f} over frames "
          f"{first + 1}-{G_FRAMES - 1} (ratio {g_rec['frames_per_s_tracked'] / fps_f:.3f}; "
          f"F, G and H ran at once, each in its own process, on a host of "
          f"{os.cpu_count()} CPUs)")
    print(f"[G] span swt.judge.parsac: device PARSAC {g_rec['judge_parsac_span_ms']:.2f} ms "
          f"against F's host twin {twin:.2f} ms")


class PhaseChild:
    """Phase G or H in a process of its own (`python3 chip_smoke.py
    --phase-child G|H OUT`), started before phase F (H before phase A) so
    that the main-path runs, each bound by its host's Python dispatch, take
    their time at once: one after the other they would pass the script's
    time limit. Its stdout goes to a file; `finish()` waits for it (the
    process is killed if it outlives its time limit or the parent fails),
    relays its output and returns its record."""

    def __init__(self, tmp, phase, timeout_s, *args):
        self.phase = phase
        self.timeout_s = timeout_s
        self.out = os.path.join(tmp, f"phase_{phase}.json")
        self.log = open(os.path.join(tmp, f"phase_{phase}.log"), "w+")
        self.t0 = time.perf_counter()
        # a session of its own: stop() ends the processes it starts too
        # (phase J's ranks)
        self.proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--phase-child", phase, self.out,
             *args],
            stdout=self.log, stderr=subprocess.STDOUT, start_new_session=True)

    def finish(self):
        try:
            rc = self.proc.wait(timeout=max(self.timeout_s - (time.perf_counter() - self.t0),
                                            1))
        finally:
            self.stop()
        self.log.seek(0)
        text = self.log.read()
        self.log.close()
        sys.stdout.write(text)
        if rc != 0:  # its reason, on stderr too
            sys.stderr.write("".join(text.splitlines(True)[-30:]))
        check(rc == 0, f"phase {self.phase}: its process exited with {rc}")
        with open(self.out) as fh:
            out = json.load(fh)
        print(f"[{self.phase}] phase took {out['wall_s']:.1f} s in its own process "
              f"(concurrent with the others; collected after "
              f"{time.perf_counter() - self.t0:.1f} s)")
        return out

    def stop(self):
        import signal

        try:
            os.killpg(self.proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        self.proc.wait()


G_CHILD_TIMEOUT_S = 900
H_CHILD_TIMEOUT_S = 1080


def phase_child(phase, out_path, *args):
    """The body of a phase's own process: the same setup as main's, then
    phase G, H, I or J (J's argument: F's checkpoint), its record written
    to `out_path`."""
    if not torch.cuda.is_available():
        return 1
    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if phase == "G":
        klt.load_kernel()  # built by the parent: loaded by its source hash
        seq, rend, frames = render(G_FRAMES)
        rec, launches = phase_g(make_config(rend.K), seq, frames, DEV)
        out = {"record": rec, "launches": launches}
    elif phase == "I":
        rec, launches = phase_i(DEV)
        out = {"record": rec, "launches": launches}
    elif phase == "J":
        out = {"record": phase_j(DEV, args[0])}
    elif phase == "K":
        out = {"record": phase_k(DEV)}
    else:
        out = {"record": phase_h(DEV)}
    out["wall_s"] = time.perf_counter() - t0
    with open(out_path, "w") as fh:
        json.dump(out, fh)
    return 0


def render(n):
    """bench.py phase 1's sequence and its first n frames at 752x480."""
    seq = synthetic.generate(duration=8.0, n_landmarks=1200, max_keypoints=150,
                             excitation=0.05)
    rend = SequenceRenderer(seq, image_size=(W_IMG, H_IMG))
    return seq, rend, [np.asarray(rend.render(i), np.uint8) for i in range(n)]


def parsac_card_vs_cpu():
    """The first device judge call's and the first chain call's inputs (their
    Gumbel noise included) as G ran them on the card, run again on the card
    (its host syncs counted) and on the CPU: masks within G_REPLAY_MASK_DIFFS
    slots, bin confidences within G_REPLAY_CONF_TOL."""
    out = {}
    for kind, fn in (("judge", parsac.imu_parsac_pnp),
                     ("chain", parsac.parsac_essential_chain)):
        check(kind in swt_mod.CAPTURED_PARSAC, f"phase G: no {kind} call captured")
        args, res_g = swt_mod.CAPTURED_PARSAC[kind]
        on_card = {k: v.to(DEV) if isinstance(v, torch.Tensor) else v
                   for k, v in args.items()}
        _, syncs = count_syncs(lambda: fn(**on_card))
        res_c = fn(**args)
        if kind == "judge":
            m_g, m_c = res_g[1], res_c.inlier_mask
            c_g, c_c = res_g[4], res_c.bin_confidences
        else:
            (m_g, c_g), (m_c, c_c) = res_g, res_c
        n_diff = int((m_g != m_c).sum())
        dc = float((c_g - c_c).abs().max())
        out[kind] = {"mask_slots_differ": n_diff, "mask_slots": int(m_c.numel()),
                     "bin_conf_max_diff": dc, "host_syncs_per_call": syncs,
                     "inliers": int(m_c.sum())}
        print(f"[G] first {kind} call, card against CPU on its inputs: masks differ on "
              f"{n_diff} of {m_c.numel()} slots ({int(m_c.sum())} inliers on the CPU), bin "
              f"confidences within {dc:.3e}; host syncs per call on the card {syncs}")
        check(n_diff <= G_REPLAY_MASK_DIFFS,
              f"phase G: {kind} masks differ on {n_diff} slots")
        check(dc <= G_REPLAY_CONF_TOL, f"phase G: {kind} bin confidences differ by {dc:.3e}")
    return out


# phase H: bench.py's phase 4 (bench.py:483-548), the lockstep batch
# runtime over H_N sequences at its full width: make_config(light=False)
# (bench.py:232-261, here make_config with each sequence's camera), F's
# Caps, synthetic.generate(duration=10.0, n_landmarks=1200,
# max_keypoints=150, seed=648 + 7*i) and the SyntheticBackend. H_TICKS is
# cut from bench.py's 200 (the whole 10 s): the JAX package's lockstep run on
# the CPU with the same config, Caps and seeds (`JAX_PLATFORMS=cpu python
# scripts/jax_ate_reference.py --lockstep 200`) ran its third batched
# keyframe flush at tick 78, so steady_window_start is 83 and 94 = 78 + 16
# ticks give a steady window of 10 ticks; its ATEs over the 94 ticks, one per
# sequence, are H_ATE_JAX_CPU_M
H_N = 4
H_TICKS = 94
H_ATE_JAX_CPU_M = (0.0004713562526300411, 0.0004803668716731617,
                   0.00047802011384077346, 0.0004725987292656507)
H_ATE_BOUND_M = tuple(max(2 * a, a + 0.01) for a in H_ATE_JAX_CPU_M)
# the replay of the first batched keyframe flush: F's bounds (see
# keyframe_card_vs_cpu), its accepted steps within 2 (in f64: batch_replay)
H_STEP_DIFFS = 2


def phase_h(dev):
    """`batch.run_sequences_lockstep` over H_N sequences for H_TICKS ticks on
    the card (see above). Returns the `batch` record."""
    from rd_vio_tpu_torch import native
    from rd_vio_tpu_torch.batch import dispatcher, run_sequences_lockstep, steady_window_start
    from rd_vio_tpu_torch.models.feature_tracker import SyntheticBackend

    check(native.available(), "phase H: the native library did not build")
    seqs, cfgs = [], []
    for i in range(H_N):
        seq = synthetic.generate(duration=10.0, n_landmarks=1200, max_keypoints=150,
                                 seed=648 + 7 * i)
        seqs.append(seq)
        cfgs.append(make_config(seq.K_mat))
    GLOBAL_TIMER.reset()
    builders.PROGRAM_STATS.clear()
    builders.KF_FUSED_COUNT.n = 0
    ba.ROW_ITERATIONS.clear()
    native.CALLS.clear()
    dispatcher.CAPTURE_BATCH, dispatcher.CAPTURED_BATCH = True, None
    # vmap's per-row fallback warns from here on (the dispatcher also turns
    # it off while its programs run, so there it raises)
    torch._C._functorch._set_vmap_fallback_warning_enabled(True)
    vio_box, per_tick, prof_box = [], [], {}
    calls = lambda k: builders.PROGRAM_STATS.get(k, {}).get("calls", 0)  # noqa: E731

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        if dev.type == "cuda":
            torch.cuda.set_sync_debug_mode("warn")
        n_seen = [0]

        def on_tick(k):
            if dev.type == "cuda":
                torch.cuda.synchronize()
            if k % 10 == 9:
                print(f"[H] tick {k + 1} of {H_TICKS} after {time.perf_counter() - t0:.1f} s",
                      flush=True)
            new = caught[n_seen[0]:]
            n_seen[0] = len(caught)
            per_tick.append({
                "kf": calls("batched_kf"), "marg": calls("batched_marg"),
                "sub": calls("batched_sub"),
                "syncs": sum("synchronizing CUDA operation" in str(w.message) for w in new),
                "fallbacks": sum("performance drop" in str(w.message) for w in new),
                "states": [odo.state() for odo in vio_box[0].odos]})
            if "prof" in prof_box:  # the profiled tick ends here
                p, t_p = prof_box.pop("prof")
                prof_box["result"] = (k, p, time.perf_counter() - t_p)
                p.__exit__(None, None, None)
            elif "tick" not in prof_box and calls("batched_kf") >= 3:
                # profile the first tick of the steady window (its end is
                # steady_window_start's stamp, outside the timed intervals)
                prof_box["tick"] = k + 5
            if prof_box.get("tick") == k + 1:
                from torch.profiler import ProfilerActivity, profile

                p = profile(activities=[ProfilerActivity.CUDA])
                p.__enter__()
                prof_box["prof"] = (p, time.perf_counter())

        t0 = time.perf_counter()
        try:
            n_tick, est, stamps, kf_fl = run_sequences_lockstep(
                cfgs, [SyntheticBackend(q) for q in seqs], seqs, caps=F_CAPS,
                device=dev, n_ticks=H_TICKS, on_tick=on_tick, on_start=vio_box.append)
        finally:
            if dev.type == "cuda":
                torch.cuda.set_sync_debug_mode("default")
            dispatcher.CAPTURE_BATCH = False
            if "prof" in prof_box:
                prof_box.pop("prof")[0].__exit__(None, None, None)
        wall = time.perf_counter() - t0
    host = GLOBAL_TIMER.stats()
    programs = {k: dict(v) for k, v in builders.PROGRAM_STATS.items()}
    native_calls = dict(native.CALLS)

    check(n_tick == H_TICKS, f"phase H: {n_tick} ticks, not {H_TICKS}")
    ates = []
    for i, (seq, e) in enumerate(zip(seqs, est)):
        check(len(e) > 0, f"phase H: sequence {i} never reached tracking")
        est_p = np.stack([p for _, p in e])
        check(np.isfinite(est_p).all(), f"phase H: sequence {i} published a non-finite pose")
        gt = {round(t, 6): p for t, p in zip(seq.t_frame, seq.p_wb)}
        ates.append(float(ate_rmse(est_p, np.stack([gt[round(t, 6)] for t, _ in e]))))
    states = np.array([t["states"] for t in per_tick])
    check(not (states == 2).any(), "phase H: a sequence reported a crash")
    first = [int(np.flatnonzero(states[:, i] == 1)[0]) for i in range(H_N)]
    check(all((states[f:, i] == 1).all() for i, f in enumerate(first)),
          "phase H: a sequence lost tracking")
    n_kf = kf_fl[-1]
    # programs per tick, from the counts after each tick
    prev = {"kf": 0, "marg": 0, "sub": 0}
    for t in per_tick:
        d = {k: t[k] - prev[k] for k in prev}
        prev = {k: t[k] for k in prev}
        check(d["kf"] <= 1 and d["marg"] == d["kf"] and d["sub"] <= 1,
              f"phase H: a tick ran {d} batched programs")
    fallbacks = sum(t["fallbacks"] for t in per_tick)

    h = steady_window_start(kf_fl)
    st = np.asarray(stamps)
    steady_fps = (len(st) - 1 - h) * H_N / max(st[-1] - st[h], 1e-9)
    whole_fps = n_tick * H_N / wall
    steady_syncs = [t["syncs"] for t in per_tick[h + 1:]]
    rows_it = list(ba.ROW_ITERATIONS)
    max_it = [max(r) for r in rows_it]
    kernels = kernel_ms = None
    prof_tick = None
    if "result" in prof_box:
        prof_tick, p, t_prof = prof_box["result"]
        kernels, kernel_ms = 0, 0.0
        for e in p.key_averages():
            if str(getattr(e, "device_type", "")).endswith("CUDA"):
                kernels += e.count
                kernel_ms += 1e-3 * getattr(e, "self_device_time_total",
                                            getattr(e, "self_cuda_time_total", 0.0))
    d_tick = {k: per_tick[prof_tick][k] - per_tick[prof_tick - 1][k]
              for k in ("kf", "sub")} if prof_tick else None
    rec = {
        "sequences": H_N, "ticks": n_tick, "bench_ticks": 200, "wall_s": wall,
        "first_tracked_tick": first, "tracked": [len(e) for e in est],
        "batched_kf_flushes": n_kf, "steady_window_start": h,
        "batch_fps_per_chip": steady_fps, "batch_fps_whole_run": whole_fps,
        "ate_m": ates, "max_ate_m": max(ates), "ate_jax_cpu_m": list(H_ATE_JAX_CPU_M),
        "ate_bound_m": list(H_ATE_BOUND_M),
        "programs": {k: {"calls": v["calls"], "solves": v["solves"],
                         "lm_iterations": v["iterations"]} for k, v in programs.items()},
        "lm_iterations_per_batched_solve": {
            "max": max(max_it) if max_it else None,
            "mean_of_max": float(np.mean(max_it)) if max_it else None,
            "rows_mean": np.mean(np.array(rows_it), axis=0).tolist() if rows_it else None,
            "solves": len(rows_it)},
        "host_syncs_per_tick": {"steady_mean": float(np.mean(steady_syncs)),
                                "steady_max": int(max(steady_syncs)),
                                "all_ticks": int(sum(t["syncs"] for t in per_tick))},
        "vmap_fallbacks": fallbacks,
        "profiled_tick": prof_tick, "profiled_tick_programs": d_tick,
        "kernels_per_steady_tick": kernels,
        "device_busy_share": None if kernel_ms is None else kernel_ms / (1e3 * t_prof),
        "native_calls": native_calls,
        "spans_ms": {k: {"n": v["n"], "mean": v["mean_ms"], "p50": v["p50_ms"],
                         "p90": v["p90_ms"]} for k, v in host.items()},
    }
    print(f"[H] lockstep batch runtime: {H_N} sequences x {n_tick} ticks (bench.py runs "
          f"200), first tracked ticks {first}, tracked {rec['tracked']}, batched keyframe "
          f"flushes {n_kf}, {wall:.1f} s")
    print(f"[H] steady aggregate {steady_fps:.3f} frames/s over ticks {h + 1}-{n_tick - 1} "
          f"(bench.py's batch_fps_per_chip); whole run {whole_fps:.3f} frames/s")
    print(f"[H] batched programs: " + ", ".join(
        f"{k} {v['calls']} calls, {v['solves']} solves, {v['iterations']} LM iterations"
        for k, v in sorted(programs.items()) if k.startswith("batched")))
    print(f"[H] LM iterations per batched solve: max {rec['lm_iterations_per_batched_solve']['max']}, "
          f"mean of the maxima {rec['lm_iterations_per_batched_solve']['mean_of_max']:.1f}, per "
          f"row mean {rec['lm_iterations_per_batched_solve']['rows_mean']}")
    print(f"[H] host syncs per steady tick: mean {rec['host_syncs_per_tick']['steady_mean']:.1f}, "
          f"max {rec['host_syncs_per_tick']['steady_max']}; vmap per-row fallbacks {fallbacks}")
    if kernels is not None:
        print(f"[H] tick {prof_tick} under torch.profiler ({d_tick}): {kernels} kernels, "
              f"summed kernel time {kernel_ms:.1f} ms in {1e3 * t_prof:.0f} ms (busy share "
              f"{rec['device_busy_share']:.4f})")
    # the host assembly's spans on the NumPy loops, before the native
    # library (phase F on this card, PERF.md): 83-171 and 6.6-11.6 ms
    numpy_path = {"bld.kf.assemble": "83-171", "bld.sub.assemble": "6.6-11.6"}
    for k in ("batch.kf", "batch.sub", "bld.kf.assemble", "bld.sub.assemble"):
        v = host.get(k)
        if v:
            print(f"[H] span {k}: mean {v['mean_ms']:.1f} ms p50 {v['p50_ms']:.1f} "
                  f"p90 {v['p90_ms']:.1f} (n={v['n']})" + (
                      f"; {numpy_path[k]} ms on the NumPy path" if k in numpy_path else ""))
    print(f"[H] native calls: {native_calls}")
    for i, (a, b) in enumerate(zip(ates, H_ATE_BOUND_M)):
        print(f"[H] sequence {i}: ATE {a:.5f} m; JAX lockstep on the CPU "
              f"{H_ATE_JAX_CPU_M[i]:.5f} m; bound {b:.5f} m")
    check(n_kf >= 3, f"phase H: only {n_kf} batched keyframe flushes")
    check(calls("batched_kf") == n_kf, "phase H: batched keyframe programs != flushes")
    check(fallbacks == 0, f"phase H: vmap fell back to a loop over rows {fallbacks} times")
    check(native_calls.get("preintegrate_batch", 0) > 0 and
          native_calls.get("predict_mean", 0) > 0, "phase H: the native library was not used")
    for i, (a, b) in enumerate(zip(ates, H_ATE_BOUND_M)):
        check(a <= b, f"phase H: sequence {i} ATE {a:.5f} m > {b:.5f} m")
    rec["replay"] = batch_replay(dev)
    return rec


def batch_replay(dev):
    """The first batched keyframe flush (dispatcher.CAPTURED_BATCH kept its
    stacked inputs and outputs), run again: its active rows one by one
    through the single-sequence `builders.run_keyframe_fused` on the card,
    and the whole batch on the CPU. In f32, as the run made it, and cast to
    f64. The f32 window solves of perfect-match synthetic data start at the
    f32 noise floor, where a step's acceptance is decided by rounding, not
    by the problem (accepted steps 3 / 7 single against batched and 6 / 0
    card against CPU in the first card run, positions within 4.2e-7 m), so
    the accepted steps are held in f64, where the problem decides them:
    within H_STEP_DIFFS; both dtypes: positions within 1e-4 m, the
    marginalization prior's S^T S within F_PRIOR_OWN relative (each at its
    own solution) and F_PRIOR_SAME (at the batched solution). The f64 batch
    also runs with eager LM iterations against the graphed ones."""
    from rd_vio_tpu_torch.batch import dispatcher

    cap = dispatcher.CAPTURED_BATCH
    check(cap is not None, "phase H: no batched keyframe flush captured")
    a, mask, priors, it, ct = (cap[k] for k in ("arrays", "mask", "priors",
                                                "max_iterations", "calib"))
    out = {"f32": replay_rows(a, mask, priors, ct, it, cap["out"], dev)}
    a64 = host64(a)
    up = builders._up(a64, dev)
    kf_mask = torch.from_numpy(mask).to(dev)

    def batched(graphs):
        ba.ROW_GRAPHS = graphs
        try:
            res, res_loc, v, ok, tri, _ = dispatcher.batched_kf(up, priors, ct, it)
            return res, res_loc, v, ok, tri, dispatcher.batched_marg(
                res.states, res.inv_depth, v, ok, tri, up, priors, kf_mask, ct)
        finally:
            ba.ROW_GRAPHS = True

    out64 = batched(True)  # captures the f64 graphs
    out["f64"] = replay_rows(a64, mask, priors, ct, it, out64, dev)

    def timed(graphs):
        t0 = time.perf_counter()
        o = batched(graphs)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        return o, time.perf_counter() - t0

    eager, t_eager = timed(False)
    _, t_graph = timed(True)
    out["f64_graph_vs_eager"] = {
        "accepted_steps": [out64[0].iterations.tolist(), eager[0].iterations.tolist()],
        "max_position_diff_m": float((out64[0].states.p - eager[0].states.p).abs().max()),
        "s": [t_graph, t_eager]}
    print(f"[H] f64 batch, graphed LM iterations against eager: accepted steps "
          f"{out['f64_graph_vs_eager']['accepted_steps']}, positions within "
          f"{out['f64_graph_vs_eager']['max_position_diff_m']:.3e} m; the batch's two "
          f"programs {t_graph:.2f} s graphed against {t_eager:.2f} s eager")
    for dt in ("f32", "f64"):
        for r in out[dt]["rows"] + out[dt]["cpu"]:
            d = r["accepted_steps"]
            check(dt == "f32" or abs(d[0] - d[1]) <= H_STEP_DIFFS,
                  f"phase H: {dt} replay row {r['row']} accepted steps {d}")
            check(r["max_position_diff_m"] <= 1e-4, f"phase H: {dt} replay row {r['row']} "
                  f"positions differ by {r['max_position_diff_m']:.3e}")
            check(r["prior_info_rel_diff"] <= F_PRIOR_OWN, f"phase H: {dt} replay row "
                  f"{r['row']} priors differ by {r['prior_info_rel_diff']:.3e}")
        for r in out[dt]["cpu"]:
            check(r["prior_info_rel_diff_same_solution"] <= F_PRIOR_SAME,
                  f"phase H: {dt} row {r['row']}: card and CPU marginalizations of one "
                  f"solution differ")
    ge = out["f64_graph_vs_eager"]
    check(all(abs(x - y) <= H_STEP_DIFFS for x, y in zip(*ge["accepted_steps"])) and
          ge["max_position_diff_m"] <= 1e-4, "phase H: graphed and eager batches differ")
    return out


def host64(tree):
    """A host tree (dicts, NamedTuples, arrays) with its float arrays f64."""
    if isinstance(tree, dict):
        return {k: host64(v) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(host64(x) for x in tree))
    a = np.asarray(tree)
    return a.astype(np.float64) if np.issubdtype(a.dtype, np.floating) else a


def replay_rows(a, mask, priors, ct, it, out_b, dev):
    """One replay of batch_replay: `out_b` (the batched outputs on the card
    for stacked host arrays `a`) against each active row's single-sequence
    step on the card and against the batch on the CPU."""
    from rd_vio_tpu_torch.batch import dispatcher
    from rd_vio_tpu_torch.estimation import factors as Fa

    res_b, _, v_b, ok_b, tri_b, priors_b = out_b
    dt = str(res_b.states.p.dtype).replace("torch.", "")
    info = lambda S: S.to("cpu", torch.float64).mT @ S.to("cpu", torch.float64)  # noqa: E731
    rel = lambda x, y: float((x - y).abs().max() / y.abs().max())  # noqa: E731

    def row(tree, i):  # row i of a stacked host tree
        if isinstance(tree, dict):
            return {k: row(v, i) for k, v in tree.items()}
        if hasattr(tree, "_fields"):
            return type(tree)(*(row(x, i) for x in tree))
        return tree[i]

    out = {"rows": []}
    for i in np.flatnonzero(mask):
        prior_i = Fa.PriorFactor(*(t[i] for t in priors))
        res, _, v, _, _, prior_new = builders.run_keyframe_fused(row(a, i), prior_i, ct, it)
        out["rows"].append({
            "row": int(i), "accepted_steps": [int(res_b.iterations[i]), int(res.iterations)],
            "max_position_diff_m": float((res_b.states.p[i].double()
                                          - res.states.p.double()).abs().max()),
            "prior_info_rel_diff": rel(info(priors_b.sqrt_inv_cov[i]),
                                       info(prior_new.sqrt_inv_cov)),
            "validation_differs": int((v_b[i] != v).sum())})
    t0 = time.perf_counter()
    ct_c, priors_c = to_cpu((ct, priors))
    a_c = builders._up(a, "cpu")
    m_c = torch.from_numpy(mask)
    res_c, _, v_c, ok_c, tri_c, _ = dispatcher.batched_kf(a_c, priors_c, ct_c, it)
    priors_cc = dispatcher.batched_marg(res_c.states, res_c.inv_depth, v_c, ok_c, tri_c, a_c,
                                        priors_c, m_c, ct_c)
    same = dispatcher.batched_marg(*to_cpu((res_b.states, res_b.inv_depth, v_b, ok_b, tri_b)),
                                   a_c, priors_c, m_c, ct_c)
    out["cpu_replay_s"] = time.perf_counter() - t0
    out["cpu"] = [{
        "row": int(i),
        "accepted_steps": [int(res_b.iterations[i]), int(res_c.iterations[i])],
        "max_position_diff_m": float((res_b.states.p[i].cpu().double()
                                      - res_c.states.p[i].double()).abs().max()),
        "prior_info_rel_diff": rel(info(priors_b.sqrt_inv_cov[i]),
                                   info(priors_cc.sqrt_inv_cov[i])),
        "prior_info_rel_diff_same_solution": rel(info(priors_b.sqrt_inv_cov[i]),
                                                 info(same.sqrt_inv_cov[i]))}
        for i in np.flatnonzero(mask)]
    for r in out["rows"]:
        print(f"[H] first batched keyframe flush ({dt}), row {r['row']} against the "
              f"single-sequence step on the card: accepted steps {r['accepted_steps'][0]} / "
              f"{r['accepted_steps'][1]}, positions within {r['max_position_diff_m']:.3e} m, "
              f"prior S^T S within {r['prior_info_rel_diff']:.3e}, validation differs on "
              f"{r['validation_differs']} slots")
    for r in out["cpu"]:
        print(f"[H] ({dt}) row {r['row']}, card batch against CPU batch: accepted steps "
              f"{r['accepted_steps'][0]} / {r['accepted_steps'][1]}, positions within "
              f"{r['max_position_diff_m']:.3e} m, prior S^T S within "
              f"{r['prior_info_rel_diff']:.3e} (own solutions), "
              f"{r['prior_info_rel_diff_same_solution']:.3e} (the CPU at the card's solution)")
    print(f"[H] ({dt}) the CPU's replay of the batch took {out['cpu_replay_s']:.1f} s")
    return out


# phase I: the EuRoC runner's path (examples/torch_run_euroc.py) over a
# EuRoC-layout copy of B's sequence at EuRoC cam0's full 752x480, distorted
# with its published radtan coefficients. I_FRAMES is the least count past
# the JAX package's third fused keyframe step on the same layout on the CPU:
# `JAX_PLATFORMS=cpu python scripts/jax_ate_reference.py --euroc 120`, whose
# first line with kf_fused 3 is n = 83 (first tracked frame 40); its ATE at
# n = 84 is I_ATE_JAX_CPU_M (run_euroc, synchronous, PIL reader)
I_FRAMES = 84
I_ATE_JAX_CPU_M = 0.010381161302814345
I_ATE_BOUND_M = max(2 * I_ATE_JAX_CPU_M, I_ATE_JAX_CPU_M + 0.01)
I_REMAP_REPS = 20  # remaps timed back to back for the device ms per remap
I_CHILD_TIMEOUT_S = 960


def load_runner():
    """examples/torch_run_euroc.py as a module (examples/ is no package)."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "examples",
                        "torch_run_euroc.py")
    spec = importlib.util.spec_from_file_location("torch_run_euroc", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def write_euroc_layout(root):
    """B's sequence, its first I_FRAMES frames rendered at 752x480 (in f64,
    before rounding) and distorted with EuRoC cam0's radtan coefficients, as
    a mav0 layout with a sensor.yaml and bench.py's reference profile as
    setting.yaml (scripts/euroc_layout.py). Returns (paths, seq, rend)."""
    from rd_vio_tpu_torch.ops import camera
    from scripts.euroc_layout import EUROC_CAM0_RADTAN, write_layout

    seq = synthetic.generate(duration=8.0, n_landmarks=1200, max_keypoints=150,
                             excitation=0.05)
    rend = SequenceRenderer(seq, image_size=(W_IMG, H_IMG))
    dist = np.asarray(EUROC_CAM0_RADTAN)
    paths = write_layout(
        root, seq, [rend.render(k) for k in range(I_FRAMES)], rend.K, dist,
        lambda p: camera.undistort_points_pixel(torch.from_numpy(p), rend.K, dist).numpy())
    return paths, seq, rend


def remap_card_vs_cpu(cfg, png, dev):
    """`remap_bilinear` on frame 0 of the layout on the card and on the CPU,
    with the runner's tables: max |difference|, pixels whose integer part
    differs, and the device ms per remap (CUDA events around I_REMAP_REPS
    back-to-back remaps after a warm-up)."""
    from PIL import Image

    from rd_vio_tpu_torch.ops.image.undistort import build_remap, remap_bilinear

    img = np.asarray(Image.open(png).convert("L"), dtype=np.float32)
    W, H = cfg.camera_resolution
    my, mx = build_remap(cfg.camera_intrinsic, cfg.camera_distortion,
                         cfg.camera_distortion_model, W, H)
    cpu = remap_bilinear(*(torch.from_numpy(a) for a in (img, my, mx))).numpy()
    args = [torch.from_numpy(a).to(dev) for a in (img, my, mx)]
    card = remap_bilinear(*args)
    for _ in range(3):
        remap_bilinear(*args)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(I_REMAP_REPS):
        remap_bilinear(*args)
    end.record()
    torch.cuda.synchronize()
    card = card.cpu().numpy()
    d = np.abs(card - cpu)
    rec = {"max_abs_diff": float(d.max()),
           "integer_part_differs": int((np.floor(card) != np.floor(cpu)).sum()),
           "pixels": int(card.size), "device_ms_per_remap": start.elapsed_time(end) / I_REMAP_REPS,
           "zero_share": float((card == 0).mean())}
    print(f"[I] remap_bilinear frame 0, card against CPU: max |diff| {rec['max_abs_diff']:.3e}, "
          f"integer part differs on {rec['integer_part_differs']} of {rec['pixels']} pixels; "
          f"device {rec['device_ms_per_remap']:.4f} ms per remap (CUDA events, "
          f"{I_REMAP_REPS} back to back)")
    check(np.isfinite(card).all(), "phase I: a non-finite remapped pixel")
    check(rec["integer_part_differs"] <= 0.001 * card.size,
          "phase I: the card's remap differs in integer part on > 0.1% of pixels")
    return rec


def phase_i(dev):
    """examples/torch_run_euroc.py's `run` (threaded, on the card) over the
    layout of write_euroc_layout; returns the `euroc` record and the fused LK
    kernel's launches."""
    from rd_vio_tpu_torch import native
    from rd_vio_tpu_torch.utils.trajectory import associate
    from scripts.euroc_layout import EUROC_CAM0_RADTAN, REFERENCE_SETTINGS

    runner = load_runner()
    built = runner.build_all(dev)  # before the clock, as the runner does
    print(f"[I] built before the clock: LK kernel, native host library "
          f"{built['native']}, native EuRoC loader {built['euroc_loader']}")
    with tempfile.TemporaryDirectory() as tmp:
        t_w = time.perf_counter()
        (mav0, sensor_yaml, setting_yaml), seq, rend = write_euroc_layout(tmp)
        print(f"[I] wrote a {W_IMG}x{H_IMG} EuRoC layout of {I_FRAMES} frames (radtan "
              f"{list(EUROC_CAM0_RADTAN)}) in {time.perf_counter() - t_w:.1f} s")

        klt.launches = klt.fwd_rev_launches = 0
        GLOBAL_TIMER.reset()
        builders.KF_FUSED_COUNT.n = 0
        native.CALLS.clear()
        published, box = [], {}

        def on_odometry(odo):
            box["odo"] = odo
            box["workers"] = (odo.handler._ft_worker, odo.handler._fe_worker)
            odo.frontend.on_publish = lambda lo: published.append(
                (lo[0], lo[3].copy(), time.perf_counter()))

        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                res = runner.run(mav0, sensor_yaml, setting_yaml, device=dev, threaded=True,
                                 on_odometry=on_odometry)
                torch.cuda.synchronize()
            finally:
                torch.cuda.set_sync_debug_mode("default")
                if "odo" in box:
                    healthy = box["odo"].healthy()
                    box["odo"].close()  # raises a worker's error
        syncs = sum("synchronizing CUDA operation" in str(w.message) for w in caught)
        launches, level_launches = klt.fwd_rev_launches, klt.launches
        host = GLOBAL_TIMER.stats()
        calls = dict(native.CALLS)
        n_kf = builders.KF_FUSED_COUNT.n
        cfg = res["config"]
        remap = remap_card_vs_cpu(cfg, os.path.join(
            mav0, "cam0", "data", sorted(os.listdir(os.path.join(mav0, "cam0", "data")))[0]),
            dev)

    # load_config read both files: the sensor file's camera and distortion,
    # the setting file's profile
    check(cfg.camera_distortion_flag == 1 and cfg.camera_resolution == (W_IMG, H_IMG)
          and np.array_equal(cfg.camera_distortion, EUROC_CAM0_RADTAN)
          and np.allclose(cfg.camera_intrinsic, rend.K, rtol=1e-15, atol=0),
          "phase I: load_config did not take the sensor.yaml's camera")
    s = REFERENCE_SETTINGS
    check(cfg.sliding_window_size == s["sliding_window"]["size"]
          and cfg.feature_tracker_max_keypoint_detection
          == s["feature_tracker"]["max_keypoint_detection"]
          and cfg.solver_iteration_limit == s["solver"]["iteration_limit"]
          and cfg.parsac_flag is True,
          "phase I: load_config did not take the setting.yaml's profile")
    reader = res["reader"]
    check(reader == ("native" if built["euroc_loader"] else "PIL"),
          f"phase I: reader {reader} with the native loader available "
          f"{built['euroc_loader']}")
    if built["euroc_loader"]:
        check(calls.get("euroc_load_image", 0) == I_FRAMES,
              "phase I: the native EuRoC loader did not read every frame")
    check(calls.get("preintegrate_batch", 0) > 0, "phase I: the native library was not used")
    check(healthy, "phase I: a pipeline worker failed")
    check(not any(w.is_alive() for w in box["workers"]),
          "phase I: a worker thread is alive after close()")
    check(res["frames"] == I_FRAMES, f"phase I: {res['frames']} frames read")
    check(bool(published), "phase I: the system never reached tracking")
    est_t = np.array([t for t, _, _ in published])
    est_p = np.stack([p for _, p, _ in published])
    check(np.isfinite(est_p).all(), "phase I: a non-finite published pose")
    gt = res["gt"]
    ie, ig = associate(est_t, gt["t"])
    check(len(ie) == len(est_t), "phase I: an estimate without ground truth")
    ate = float(ate_rmse(est_p[ie], gt["p"][ig]))
    first = int(np.flatnonzero(np.isclose(gt["t"], est_t[0]))[0])
    clock = np.array([c for _, _, c in published])
    fps = (len(published) - 1) / (clock[-1] - clock[0]) if len(published) > 1 else float("nan")
    per_frame = {k: host[k] for k in ("ds.load", "ds.undistort") if k in host}
    check("ds.undistort" in per_frame and per_frame["ds.undistort"]["n"] == I_FRAMES,
          "phase I: not every frame was undistorted")
    rec = {
        "frames": I_FRAMES, "width": W_IMG, "height": H_IMG,
        "distortion": list(EUROC_CAM0_RADTAN), "reader": reader,
        "native_euroc_loader": built["euroc_loader"], "first_tracked_frame": first,
        "tracked_frames": len(published), "keyframe_fused_steps": n_kf,
        "frames_per_s_tracked": fps, "wall_s_to_join": res["wall_s"],
        "spans_ms": {k: {"n": v["n"], "mean": v["mean_ms"], "p50": v["p50_ms"],
                         "p90": v["p90_ms"]} for k, v in host.items()},
        "host_syncs_per_frame": syncs / I_FRAMES, "native_calls": calls,
        "remap": remap, "lk_fwd_rev_launches": launches, "lk_level_launches": level_launches,
        "ate_m": ate, "ate_jax_cpu_m": I_ATE_JAX_CPU_M, "ate_bound_m": I_ATE_BOUND_M,
    }
    print(f"[I] EuRoC runner (threaded) over {I_FRAMES} frames {W_IMG}x{H_IMG}, radtan on, "
          f"reader {reader}: first tracked frame {first}, {len(published)} tracked, fused "
          f"keyframe steps {n_kf}, join after {res['wall_s']:.1f} s")
    print(f"[I] {fps:.3f} frames/s over the tracked frames (threaded)")
    for k, v in sorted(per_frame.items()):
        print(f"[I] span {k} per frame: mean {v['mean_ms']:.2f} ms p50 {v['p50_ms']:.2f} "
              f"p90 {v['p90_ms']:.2f} (n={v['n']})")
    print(f"[I] host syncs per frame: {syncs / I_FRAMES:.1f} ({syncs} in all)")
    print(f"[I] native calls: {calls}")
    print(f"[I] lk_fwd_rev kernel launches: {launches} (tracked frame pairs = "
          f"{I_FRAMES - 1}); lk_level launches: {level_launches}")
    print(f"[I] ATE (SE3-aligned RMSE of {len(est_p)} estimates, associated) {ate:.5f} m; "
          f"JAX on the CPU (run_euroc, synchronous) {I_ATE_JAX_CPU_M:.5f} m; bound "
          f"{I_ATE_BOUND_M:.5f} m")
    check(launches == I_FRAMES - 1,
          f"phase I: {launches} fused LK launches, not {I_FRAMES - 1}")
    check(level_launches == 0, "phase I: the runner launched the level kernel")
    check(ate <= I_ATE_BOUND_M, f"phase I: ATE {ate:.5f} m > {I_ATE_BOUND_M:.5f} m")
    return rec, launches


# phase J: the JAX package's last modules. J.1 the landmark-sharded window
# BA (parallel/dist_ba.py) on phase E's problem: NCCL at world size 1 (the
# backend of a run with a card per rank; NCCL refuses two ranks on one
# card) and J_RANKS gloo ranks on the one card, each against the single-card
# solve_ba of the same relaid problem; J.2 the tracker's sharded
# refine_window on F's window, restored from F's checkpoint; J.3 (in the
# main process) the checkpoint of F's tracker, round trip on the card; J.4
# the bicubic intensity on phase A's frame and keypoints, card against CPU
J_RANKS = 4
J_DIST_TOL_M = 1e-6  # phase E's card-against-CPU bound on positions
J_TIMEOUT_S = 120.0  # every collective's
J_INTENSITY_TOL = 1e-3
J_CHILD_TIMEOUT_S = 600
# what the JAX package's save_tracker writes per frame and subframe
# (rd_vio_tpu/utils/checkpoint.py:25-32)
J_FRAME_KEYS = ("id", "t", "q", "p", "v", "bg", "ba", "bearings", "track_ids",
                "imu_dt", "imu_w", "imu_a", "flags")


def jax_checkpoint_keys(state, has_prior):
    """The keys the JAX package's save_tracker writes for the tracker whose
    state this is (rd_vio_tpu/utils/checkpoint.py:44-75)."""
    keys = {"n_frames", "n_tracks", "tracks_json", "m_th", "bin_conf_imu",
            "bin_conf_2d2d", "rng_key", "host_seed_ctr"}
    for i in range(int(state["n_frames"])):
        keys |= {f"f{i}_{a}" for a in J_FRAME_KEYS} | {f"f{i}_nsub"}
        for j in range(int(state[f"f{i}_nsub"])):
            keys |= {f"f{i}_s{j}_{a}" for a in J_FRAME_KEYS}
    if has_prior:
        keys |= {"prior_" + name for name in F.PriorFactor._fields}
    return keys


def same_state(a, b):
    """Keys of two checkpoint states whose arrays differ (dtype, shape or
    any bit; object arrays by value)."""
    bad = []
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        if x.dtype == object or y.dtype == object:
            ok = x.tolist() == y.tolist()
        else:
            ok = x.dtype == y.dtype and x.shape == y.shape and np.array_equal(x, y)
        if not ok:
            bad.append(k)
    return bad


def phase_j3(swt, cfg, path):
    """F's tracker to `path` with save_tracker and back with load_tracker on
    the card: every array bit for bit; then F's file under G's config (the
    device PARSAC), its generator advanced, saved and loaded again: the
    generator's state and the host seed counter carried. Returns the
    `checkpoint` record."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    checkpoint.save_tracker(path, swt)
    save_ms = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    restored = checkpoint.load_tracker(path, cfg, swt.calib, swt.caps)
    torch.cuda.synchronize()
    load_ms = 1e3 * (time.perf_counter() - t0)
    size = os.path.getsize(path)
    live = checkpoint.tracker_state(swt)
    back = checkpoint.tracker_state(restored)
    bad = same_state(live, back)
    n_sub = sum(int(live[f"f{i}_nsub"]) for i in range(int(live["n_frames"])))
    missing = jax_checkpoint_keys(live, swt.prior is not None) - set(live)
    on_card = swt.prior is None or restored.prior.sqrt_inv_cov.device == DEV
    # the device PARSAC's state: a generator on the card and the seed counter
    cfg_g = dataclasses.replace(cfg, parsac_host_masks=False)
    a = checkpoint.load_tracker(path, cfg_g, swt.calib, swt.caps)
    a._gumbel((3, 64, 256))
    for _ in range(5):
        a._next_seed()
    path_g = path + ".device_parsac.npz"
    checkpoint.save_tracker(path_g, a)
    b = checkpoint.load_tracker(path_g, cfg_g, swt.calib, swt.caps)
    gen_same = bool(torch.equal(a.gumbel_source.gen.get_state(),
                                b.gumbel_source.gen.get_state()))
    draws_same = bool(torch.equal(a._gumbel((64, 256)), b._gumbel((64, 256))))
    seeds_same = a._host_seed_ctr == b._host_seed_ctr == int(live["host_seed_ctr"]) + 5
    conf_on_card = b.bin_conf_imu.device == DEV and b.bin_conf_2d2d.device == DEV
    rec = {"save_ms": save_ms, "load_ms": load_ms, "file_bytes": size,
           "frames": int(live["n_frames"]), "subframes": n_sub, "tracks": int(live["n_tracks"]),
           "arrays": len(live), "arrays_differ": bad, "jax_keys_missing": sorted(missing),
           "generator_state_equal": gen_same, "next_draws_equal": draws_same,
           "host_seed_counter_equal": seeds_same}
    print(f"[J] checkpoint of F's tracker ({rec['frames']} frames, {n_sub} subframes, "
          f"{rec['tracks']} tracks, prior {swt.prior is not None}): save_tracker "
          f"{save_ms:.1f} ms, load_tracker on the card {load_ms:.1f} ms, {size} bytes; "
          f"{len(live)} arrays, {len(bad)} differ; JAX package's keys missing "
          f"{len(missing)}; device PARSAC generator state equal {gen_same}, next draws "
          f"equal {draws_same}, host seed counter equal {seeds_same}")
    check(not bad, f"phase J: the restored tracker differs in {bad[:5]}")
    check(not missing, f"phase J: the file lacks the JAX package's keys {sorted(missing)[:5]}")
    check(on_card and conf_on_card, "phase J: a restored tracker's state is not on the card")
    check(gen_same and draws_same and seeds_same,
          "phase J: the device PARSAC's random state did not carry")
    return rec


def j_sharded_run(group, s0, invd0, pb, label):
    """solve_ba_sharded over `group` (this process its rank 0) on phase E's
    problem relaid for the group, against the single-card solve_ba of the
    same relaid problem; each timed after a two-iteration warm-up."""
    n = group.world_size
    invd_s, pb_s, _ = dist_ba.relayout_for_sharding(invd0, pb, n)
    dist_ba.solve_on_group(group, s0, invd_s, pb_s, max_iterations=2)
    ba.solve_ba(s0, invd_s, pb_s, max_iterations=2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    (s_d, invd_d, cost_d), syncs = count_syncs(
        lambda: dist_ba.solve_on_group(group, s0, invd_s, pb_s, max_iterations=E_ITERS))
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0)
    info = dict(group.last_solve)
    it = info["iterations"]
    it0 = ba.STATS.iterations
    t0 = time.perf_counter()
    ref = ba.solve_ba(s0, invd_s, pb_s, max_iterations=E_ITERS)
    torch.cuda.synchronize()
    single_ms = 1e3 * (time.perf_counter() - t0)
    it_single = ba.STATS.iterations - it0
    dp = float((s_d.p - ref.states.p).abs().max())
    finite = all(bool(torch.isfinite(a).all()) for a in (*s_d, invd_d, cost_d))
    rec = {"backend": group.backend, "world_size": n, "staged_through_host": group.staged,
           "iterations": it, "accepted": info["accepted"],
           "rank_iterations": info["rank_iterations"],
           "single_iterations": it_single, "single_accepted": int(ref.iterations),
           "ms_per_iteration": wall_ms / it, "single_ms_per_iteration": single_ms / it_single,
           "collective_ms_per_iteration": info["collective_ms"] / it,
           "all_reduce_bytes_per_iteration": info["all_reduce_bytes"] / it,
           "broadcast_bytes_per_iteration": info["broadcast_bytes"] / it,
           "host_syncs_per_iteration": syncs / it, "max_position_diff_m": dp,
           "cost": float(cost_d), "single_cost": float(ref.cost)}
    print(f"[J] solve_ba_sharded, {label}: {it} LM iterations ({info['accepted']} accepted) "
          f"on every rank {info['rank_iterations']}; single-card solve_ba {it_single} "
          f"({int(ref.iterations)} accepted); max position difference {dp:.3e} m; ms per "
          f"iteration {rec['ms_per_iteration']:.2f} (scatter and gather included) against "
          f"{rec['single_ms_per_iteration']:.2f}; in collectives "
          f"{rec['collective_ms_per_iteration']:.3f} ms per iteration; all-reduced "
          f"{rec['all_reduce_bytes_per_iteration']:.0f} bytes per iteration (broadcast "
          f"{rec['broadcast_bytes_per_iteration']:.0f}); host syncs per iteration "
          f"{rec['host_syncs_per_iteration']:.1f}; costs {float(cost_d):.6e} vs "
          f"{float(ref.cost):.6e}")
    check(finite, f"phase J: non-finite sharded solve ({label})")
    check(dp <= J_DIST_TOL_M, f"phase J: sharded and single solves differ by {dp:.3e} m "
          f"({label})")
    return rec


def j_tracker(group, ckpt, cfg, dev):
    """F's tracker restored twice on the card: refine_window sharded over
    `group` on one copy, build_problem + solve_ba (f64) of the same window
    spec on the other."""
    calib = builders.CalibArrays.from_config(cfg, dev)
    a = checkpoint.load_tracker(ckpt, cfg, calib, F_CAPS)
    b = checkpoint.load_tracker(ckpt, cfg, calib, F_CAPS)
    a.dist_mesh = group
    validated = []
    validate = a._validate_landmarks
    a._validate_landmarks = lambda: validated.append(validate())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, syncs = count_syncs(a.refine_window)
    wall_ms = 1e3 * (time.perf_counter() - t0)
    info = dict(group.last_solve)
    frames = list(b.map.frames)
    spec = b._window_spec(frames, {f.id: f for f in b.map.all_frames()})
    st, invd, pb, _ = builders.build_problem(spec, b.calib, b.caps)
    ref = ba.solve_ba(st, invd, pb, max_iterations=cfg.solver_iteration_limit)
    got = np.stack([f.p for f in a.map.frames])
    dp = float(np.abs(got - ref.states.p[: len(frames)].cpu().numpy()).max())
    finite = all(np.isfinite(np.asarray(x)).all() for f in a.map.all_frames()
                 for x in (f.q, f.p, f.v, f.bg, f.ba))
    rec = {"window_frames": len(frames), "tracks": len(a.map.tracks),
           "iterations": info["iterations"], "rank_iterations": info["rank_iterations"],
           "single_accepted": int(ref.iterations), "refine_window_ms": wall_ms,
           "host_syncs": syncs, "max_position_diff_m": dp, "validated": len(validated)}
    print(f"[J] F's window restored from its checkpoint, refine_window sharded over "
          f"{group.world_size} gloo ranks: {len(frames)} frames, {info['iterations']} LM "
          f"iterations on every rank {info['rank_iterations']}, {wall_ms:.0f} ms, host syncs "
          f"{syncs}; against build_problem + solve_ba f64 of the same spec: max position "
          f"difference {dp:.3e} m; landmark validation ran {len(validated)} time(s)")
    check(finite, "phase J: a non-finite window state after the sharded refine_window")
    check(validated == [None], "phase J: the landmark validation did not run")
    check(dp <= J_DIST_TOL_M, f"phase J: the sharded window differs by {dp:.3e} m")
    return rec


def j_intensity(cfg, frame, dev):
    """evaluate_pyramid at phase A's keypoints on every level of the frame's
    4-level pyramid, on the card and on the CPU."""
    pyr = TorchImageBackend(cfg, dev).preprocess(frame).pyramid
    pix, corner = lk_bench.main_path_keypoints(pyr, KP_CAP, W_IMG, H_IMG, dev)
    pyr_c, pix_c = [p.cpu() for p in pyr], pix.cpu()
    rec = {"keypoints": KP_CAP, "gftt": int(corner.sum()), "levels": {}}
    for level in range(len(pyr)):
        (v, g), (vc, gc) = (intensity.evaluate_pyramid(pyr, pix, level),
                            intensity.evaluate_pyramid(pyr_c, pix_c, level))
        dv = float((v.cpu() - vc).abs().max())
        dg = float((g.cpu() - gc).abs().max())
        dev_ms, host_ms = time_call(lambda: intensity.evaluate_pyramid(pyr, pix, level), 20)
        rec["levels"][level] = {"value_max_diff": dv, "gradient_max_diff": dg,
                                "device_ms": dev_ms, "host_ms": host_ms}
        print(f"[J] evaluate_pyramid level {level} at {KP_CAP} keypoints: card against CPU "
              f"values within {dv:.3e}, gradients within {dg:.3e}; device ms per call "
              f"{dev_ms:.4f}, ms per call with the host {host_ms:.4f}")
        check(dv <= J_INTENSITY_TOL and dg <= J_INTENSITY_TOL and bool(torch.isfinite(v).all()),
              f"phase J: evaluate_pyramid level {level}, card against CPU")
    return rec


def phase_j(dev, ckpt):
    """J.1, J.2 and J.4 (see above) in their own process; J.2 reads F's
    checkpoint `ckpt`. Returns the `dist` record."""
    seq, rend, frames = render(1)
    cfg = make_config(rend.K)
    gt, invd_gt, pb, n_lm, n_obs = build_window_problem(
        seq, f0=10, W=E_W, L_max=E_L, O_max=E_O, device=dev)
    s0, invd0, pb = perturbed_start(gt, invd_gt, pb)
    print(f"[J] phase E's problem W={E_W} L={E_L} O={E_O}: {n_lm} tracks, {n_obs} "
          f"observations, f64; collectives time out after {J_TIMEOUT_S:.0f} s")
    rec = {"problem": {"W": E_W, "L": E_L, "O": E_O, "tracks": n_lm, "observations": n_obs}}
    group = dist_ba.make_group(0, 1, "nccl", dist_ba.local_init_method(), device=dev,
                               timeout_s=J_TIMEOUT_S)
    try:
        rec["nccl_1"] = j_sharded_run(group, s0, invd0, pb, "nccl, world size 1")
    finally:
        dist_ba.close_group()
    init = dist_ba.local_init_method()
    ranks = dist_ba.RankProcesses(J_RANKS, "gloo", init, device=dev, timeout_s=J_TIMEOUT_S)
    try:
        group = dist_ba.make_group(0, J_RANKS, "gloo", init, device=dev, timeout_s=J_TIMEOUT_S)
        label = (f"gloo, {J_RANKS} ranks on the one card, staged through pinned host "
                 f"buffers" if group.staged else f"gloo, {J_RANKS} ranks")
        rec[f"gloo_{J_RANKS}"] = j_sharded_run(group, s0, invd0, pb, label)
        rec["tracker"] = j_tracker(group, ckpt, cfg, dev)
        dist_ba.stop_serving(group)
    finally:
        dist_ba.close_group()
        exits = ranks.wait(60.0)
    for r, (rc, text) in enumerate(exits, start=1):
        print(f"[J] rank {r} exited {rc}: {text.strip().splitlines()[-1:] }")
    check(all(rc == 0 for rc, _ in exits), "phase J: a serving rank failed")
    rec["intensity"] = j_intensity(cfg, frames[0], dev)
    return rec


# phase K: the async keyframe step (Config.sliding_window_keyframe_async)
# on the main path's full width: `Odometry` (synchronous) with the
# perfect-match SyntheticBackend (bench.py's phase 2 backend) over bench.py
# phase 1's sequence (B's), make_config(light=False) with the sequence's
# camera and the async flag, F's Caps. K_FRAMES is the least frame count past
# the JAX package's third async dispatch on the same input with its deferred
# apply: `JAX_PLATFORMS=cpu python scripts/jax_ate_reference.py --async 160`
# ran its third async dispatch when 67 frames had been added (k_frames 69);
# the K_* constants below are its line of n = K_FRAMES
K_FRAMES = 69
K_ASYNC_DISPATCHES = 3
K_SYNC_FUSED = 1
K_FIRST_TRACKED = 35
K_KEYFRAMES = (0, 5, 10, 15, 20, 25, 30, 35, 41, 45, 46, 47, 53, 59, 60, 66)
K_ATE_JAX_CPU_M = 0.0009678212828067867
# the ATE difference tests/test_torch_async_keyframe.py allows (ATE_DIFF_M)
K_ATE_DIFF_M = 0.005
K_CHILD_TIMEOUT_S = 900
# K's inputs are noise-free (the perfect-match backend), so its f32 window
# solve ends at the noise floor, where rounding decides how many steps are
# accepted: in scripts/k_step_spread.py's three runs (9 card solves of each
# run's captured step, on an H100) the card accepted 8-14, 9-12 and 6-11
# steps on one input where the CPU, deterministic, accepted 12, 10 and 12,
# so F_STEP_DIFFS does not apply. What the solve does fix is its final
# cost: every card solve within 2.7e-4 relative of the CPU's there.
K_CARD_REPLAYS = 4  # more card solves of the captured step
K_COST_REL = 1e-3  # final window cost, each card solve against the CPU's


def phase_k(dev):
    """`Odometry(cfg, SyntheticBackend(seq), caps=F_CAPS)` with
    sliding_window_keyframe_async=True over K_FRAMES frames of B's sequence,
    then close(). Checks: async dispatches, synchronous fall-throughs, the
    first tracked frame and the keyframes' frame indices equal the JAX run's;
    the window never holds more than sliding_window_size + 1 keyframes; the
    pending keyframe apply is applied by close(); tracking kept, finite
    poses; the ATE within K_ATE_DIFF_M of the JAX run's. Returns the
    `async_keyframe` record."""
    from rd_vio_tpu_torch.models.feature_tracker import SyntheticBackend

    seq = synthetic.generate(duration=8.0, n_landmarks=1200, max_keypoints=150,
                             excitation=0.05)
    cfg = make_config(seq.K_mat)
    cfg.sliding_window_keyframe_async = True
    GLOBAL_TIMER.reset()
    builders.PROGRAM_STATS.clear()
    builders.KF_FUSED_COUNT.n = 0
    builders.CAPTURE_KEYFRAME, builders.CAPTURED_KEYFRAME = "chained", None
    odo = Odometry(cfg, SyntheticBackend(seq), caps=F_CAPS, device=dev)
    check(odo.device == dev, "phase K: Odometry is not on the card")
    index_of = {round(t, 6): k for k, t in enumerate(seq.t_frame)}
    t_last = seq.t_frame[K_FRAMES - 1]
    events = sorted([(t, 1, i) for i, t in enumerate(seq.t_imu) if t <= t_last + 0.02]
                    + [(t, 0, i) for i, t in enumerate(seq.t_frame[:K_FRAMES])])
    dispatches, keyframes, hooked = [], set(), []
    est_t, est_p, wall, kinds, syncs, states, frame_num = [], [], [], [], [], [], []
    kf_span = lambda: GLOBAL_TIMER.samples.get("swt.keyframe_fused", ())  # noqa: E731
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            # per frame: from the end of the previous frame event to the end
            # of this one (the Handler runs a frame's work when the IMU
            # samples after it arrive, inside add_motion), as in phase F
            n0, t0 = 0, time.perf_counter()
            n_kf = n_async = 0
            for t, kind, i in events:
                if kind == 1:
                    odo.add_motion(t, seq.gyro[i], seq.accel[i])
                    continue
                odo.add_frame(t, i)
                wall.append(time.perf_counter() - t0)
                syncs.append(sum("synchronizing CUDA operation" in str(w.message)
                                 for w in caught[n0:]))
                n0, t0 = len(caught), time.perf_counter()
                swt = odo.frontend.swt
                if swt is not None and swt not in hooked:
                    hooked.append(swt)

                    def counted(*a, _orig=swt._keyframe_dispatch_async, **kw):
                        dispatches.append(len(states))
                        return _orig(*a, **kw)

                    swt._keyframe_dispatch_async = counted
                kinds.append("async" if len(dispatches) > n_async else
                             "sync" if builders.KF_FUSED_COUNT.n > n_kf else "other")
                n_kf, n_async = builders.KF_FUSED_COUNT.n, len(dispatches)
                states.append(odo.state())
                if swt is not None:
                    keyframes.update(index_of[round(f.t, 6)] for f in swt.map.frames)
                    frame_num.append(swt.map.frame_num)
                if states[-1] == 1:
                    ls = odo.handler.get_latest_state()
                    if ls is not None and (not est_t or ls[0] != est_t[-1]):
                        est_t.append(ls[0])
                        est_p.append(ls[2])
            swt = odo.frontend.swt
            pending = [entry[2] for entry in swt._pending_subs]
            odo.close()
            torch.cuda.synchronize()
        finally:
            torch.cuda.set_sync_debug_mode("default")
            builders.CAPTURE_KEYFRAME = False
    programs = {k: dict(v) for k, v in builders.PROGRAM_STATS.items()}
    host = GLOBAL_TIMER.stats()

    check(2 not in states, "phase K: the system reported a crash")
    check(1 in states, "phase K: the system never reached tracking")
    first = index_of[round(est_t[0], 6)]
    tracked = [k for k, st in enumerate(states) if st == 1]
    check(all(st == 1 for st in states[states.index(1):]), "phase K: tracking was lost")
    est_p = np.asarray(est_p)
    check(np.isfinite(est_p).all(), "phase K: a non-finite published pose")
    for f in swt.map.all_frames():
        check(all(np.isfinite(np.asarray(x)).all() for x in (f.q, f.p, f.v, f.bg, f.ba)),
              "phase K: a non-finite window state")
    check(not swt._pending_subs, "phase K: close() left a deferred result unapplied")
    gt_by_t = {round(tt, 6): p for tt, p in zip(seq.t_frame, seq.p_wb)}
    ate = float(ate_rmse(est_p, np.stack([gt_by_t[round(tt, 6)] for tt in est_t])))
    n_sync = builders.KF_FUSED_COUNT.n - len(dispatches)
    # each keyframe step's span, by the kind of its tick (the spans come in
    # tick order; a tick holds at most one keyframe step)
    kf_kinds = [k for k in kinds if k in ("async", "sync")]
    spans = [1e3 * x for x in kf_span()]
    span_by = {k: [x for x, kk in zip(spans, kf_kinds) if kk == k] for k in ("async", "sync")}
    syncs_by = {k: [syncs[i] for i, kk in enumerate(kinds) if kk == k]
                for k in ("async", "sync", "other")}
    mean = lambda v: float(np.mean(v)) if v else None  # noqa: E731
    tr_wall = float(sum(wall[k] for k in tracked))
    rec = {
        "frames": K_FRAMES, "first_tracked_frame": first, "tracked_frames": len(tracked),
        "async_dispatches": len(dispatches), "sync_fused": n_sync,
        "dispatch_frames": dispatches, "keyframes": sorted(keyframes),
        "max_frame_num": max(frame_num), "window": cfg.sliding_window_size,
        "pending_at_close": pending,
        "span_keyframe_fused_ms": {"all": mean(spans), "async": mean(span_by["async"]),
                                   "sync": mean(span_by["sync"])},
        "host_syncs_per_tick": {k: mean(v) for k, v in syncs_by.items()},
        "ms_per_frame_tracked": 1e3 * tr_wall / len(tracked),
        "frames_per_s_tracked": len(tracked) / tr_wall,
        "programs": {k: {"calls": v["calls"], "solves": v["solves"],
                         "lm_iterations": v["iterations"]} for k, v in programs.items()},
        "spans_ms": {k: {"n": v["n"], "mean": v["mean_ms"], "p50": v["p50_ms"]}
                     for k, v in host.items()},
        "ate_m": ate, "ate_jax_cpu_m": K_ATE_JAX_CPU_M, "ate_diff_bound_m": K_ATE_DIFF_M,
        "jax_cpu": {"async_dispatches": K_ASYNC_DISPATCHES, "sync_fused": K_SYNC_FUSED,
                    "first_tracked_frame": K_FIRST_TRACKED, "keyframes": list(K_KEYFRAMES)},
    }
    print(f"[K] async keyframe Odometry (SyntheticBackend) over {K_FRAMES} frames: first "
          f"tracked frame {first} (JAX {K_FIRST_TRACKED}), {len(tracked)} tracked; async "
          f"dispatches {len(dispatches)} at frames {dispatches} (JAX {K_ASYNC_DISPATCHES}), "
          f"synchronous fall-throughs {n_sync} (JAX {K_SYNC_FUSED})")
    print(f"[K] keyframes (frame indices) {sorted(keyframes)}; equal to the JAX run's: "
          f"{sorted(keyframes) == list(K_KEYFRAMES)}; window at most {max(frame_num)} "
          f"keyframes (size {cfg.sliding_window_size}); entries pending at close() "
          f"{pending} (True: a keyframe apply)")
    print(f"[K] span swt.keyframe_fused mean {mean(spans):.1f} ms: async ticks "
          f"{mean(span_by['async'])} ms, sync ticks {mean(span_by['sync'])} ms; host syncs "
          f"per tick: async {mean(syncs_by['async'])}, sync {mean(syncs_by['sync'])}, "
          f"others {mean(syncs_by['other'])}")
    print(f"[K] {rec['frames_per_s_tracked']:.3f} frames/s over the tracked frames "
          f"({rec['ms_per_frame_tracked']:.0f} ms per frame)")
    print(f"[K] ATE {ate:.5f} m; JAX on the CPU {K_ATE_JAX_CPU_M:.5f} m; bound on the "
          f"difference {K_ATE_DIFF_M} m")
    check(len(dispatches) == K_ASYNC_DISPATCHES,
          f"phase K: {len(dispatches)} async dispatches, JAX {K_ASYNC_DISPATCHES}")
    check(n_sync == K_SYNC_FUSED, f"phase K: {n_sync} synchronous steps, JAX {K_SYNC_FUSED}")
    check(first == K_FIRST_TRACKED, f"phase K: first tracked frame {first}")
    check(sorted(keyframes) == list(K_KEYFRAMES), "phase K: keyframes differ from JAX's")
    check(max(frame_num) <= cfg.sliding_window_size + 1,
          f"phase K: the window held {max(frame_num)} keyframes")
    check(abs(ate - K_ATE_JAX_CPU_M) <= K_ATE_DIFF_M,
          f"phase K: ATE {ate:.5f} m against JAX's {K_ATE_JAX_CPU_M:.5f} m")
    check(programs.get("fused_keyframe_async", {}).get("calls", 0) == len(dispatches),
          "phase K: the async program's calls differ from the dispatches")
    rec["card_vs_cpu"] = keyframe_card_vs_cpu("K", K_CARD_REPLAYS)
    return rec


def main(argv):
    if "--phase-child" in argv:  # phase G's, H's, I's or J's own process (PhaseChild)
        i = argv.index("--phase-child")
        return phase_child(*argv[i + 1:])
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = DEV
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python "
          f"{sys.version.split()[0]}; device {torch.cuda.get_device_name(0)}")

    from rd_vio_tpu_torch import native

    with tempfile.TemporaryDirectory() as tmp:
        # phases H, I and K first, each in its own process: they run at once
        # with A-G
        child_h = PhaseChild(tmp, "H", H_CHILD_TIMEOUT_S)
        child_i = PhaseChild(tmp, "I", I_CHILD_TIMEOUT_S)
        child_k = PhaseChild(tmp, "K", K_CHILD_TIMEOUT_S)
        child_j = None
        try:
            records, fused, level, child_j = run_a_to_g(dev, tmp, native)
            records["batch"] = child_h.finish()["record"]
            out_i = child_i.finish()
            records["async_keyframe"] = child_k.finish()["record"]
            records["dist"] = child_j.finish()["record"]
        finally:
            child_h.stop()
            child_i.stop()
            child_k.stop()
            if child_j is not None:
                child_j.stop()
    compare_h_with_f(records["batch"], records["odometry"])
    records["euroc"] = out_i["record"]
    # phase I's launches, counted from 0 in its process just before its run
    fused["launches_by_phase"]["I"] = out_i["launches"]
    fused["launches"] += out_i["launches"]

    for k, v in records.items():
        print(json.dumps({k: v}))
    print(json.dumps({"kernels": [fused, level]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def run_a_to_g(dev, tmp, native):
    """Phases A-G (G in its own process, at once with F); returns the
    records, and the fused and level kernels' entries of the `kernels` line."""
    t0 = time.perf_counter()
    klt.load_kernel()
    print(f"LK kernels: built in {klt.build_seconds:.2f} s, loaded in "
          f"{time.perf_counter() - t0:.2f} s")
    for line in klt.build_kernel().with_suffix(".ptxas.txt").read_text().splitlines():
        if "registers" in line or "Compiling" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")
    check(native.available(), "the native library did not build")

    t_r = time.perf_counter()
    seq, rend, frames = render(F_FRAMES)
    print(f"rendered {len(frames)} frames at {W_IMG}x{H_IMG} in "
          f"{time.perf_counter() - t_r:.1f} s")
    cfg = make_config(rend.K)

    clock = [time.perf_counter()]

    def lap(phase):
        clock.append(time.perf_counter())
        print(f"[{phase}] phase took {clock[-1] - clock[-2]:.1f} s")

    fused, level = phase_a(cfg, frames, dev)
    lap("A")
    sink_b, _, _ = phase_b(cfg, seq, frames, dev)
    lap("B")
    phase_c(cfg, seq, frames, dev, sink_b)
    lap("C")
    level["launches"] = phase_d(cfg, seq, frames, dev, sink_b)
    lap("D")
    records = {"estimator": phase_e(seq, dev)}
    lap("E")
    child = PhaseChild(tmp, "G", G_CHILD_TIMEOUT_S)  # phase G, at once with F
    child_j = None
    try:
        native.CALLS.clear()
        records["odometry"], launches_f, wall_f, swt_f = phase_f(cfg, seq, frames, dev)
        records["odometry"]["native_calls"] = dict(native.CALLS)
        lap("F")
        # phase J: F's tracker to a checkpoint (J.3 here), then J.1, J.2 and
        # J.4 in a process of their own, collected at the end
        ckpt = os.path.join(tmp, "f_tracker.npz")
        records["checkpoint"] = phase_j3(swt_f, cfg, ckpt)
        lap("J.3")
        child_j = PhaseChild(tmp, "J", J_CHILD_TIMEOUT_S, ckpt)
        out_g = child.finish()
    except BaseException:
        if child_j is not None:
            child_j.stop()
        raise
    finally:
        child.stop()
    records["odometry_threaded"], launches_g = out_g["record"], out_g["launches"]
    compare_g_with_f(records["odometry_threaded"], records["odometry"], wall_f)
    for ph, rec in (("F", records["odometry"]), ("G", records["odometry_threaded"])):
        print(f"[{ph}] native calls: {rec['native_calls']}")
        check(rec["native_calls"].get("preintegrate_batch", 0) > 0
              and rec["native_calls"].get("predict_mean", 0) > 0,
              f"phase {ph}: the native library was not used")
    # the main path's launches: phases F and G, each counted from 0 just
    # before it ran
    fused["launches_by_phase"] = {"F": launches_f, "G": launches_g}
    fused["launches"] = launches_f + launches_g
    return records, fused, level, child_j


def compare_h_with_f(h_rec, f_rec):
    """H's aggregate steady frames/s beside F's single-sequence frames/s,
    and kernels per steady tick beside F's kernels per frame (the two ran
    in the same call, each in its own process); added to H's record."""
    h_rec["frames_per_s_tracked_f"] = f_rec["frames_per_s_tracked"]
    h_rec["kernels_per_frame_f"] = f_rec["kernels_per_frame"]
    kt = h_rec["kernels_per_steady_tick"]
    print(f"[H] steady aggregate {h_rec['batch_fps_per_chip']:.3f} frames/s over {H_N} "
          f"sequences against F's single-sequence {f_rec['frames_per_s_tracked']:.3f} frames/s "
          f"(F: images and the tracker; H: the synthetic backend); kernels per steady tick "
          f"{kt} against F's {f_rec['kernels_per_frame']} per frame")


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
