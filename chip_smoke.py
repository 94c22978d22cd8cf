"""Drive the PyTorch port's feature-tracking stage once on an NVIDIA GPU.

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
  B. the slice: the bench's phase-1 sequence (8 s, 160 frames rendered at
     752x480 before the clock starts) through Handler -> FeatureTracker ->
     TorchImageBackend with the reference-yaml profile of bench.py; frames/s
     over the second half, device ms per stage, keypoints per frame, the
     share of keypoints continued, and the fused kernel's launch count
     (exactly one per tracked frame), median keypoints per frame >= 100;
  C. the first 10 frames of B again with the plain LK tracker on the card;
     keypoint slots agree with B on >= 98%;
  D. the same 10 frames through the per-level kernel (8 launches per
     tracked frame, counted), with the same agreement.

Exits non-zero, with no result line, without a CUDA device or when any
check fails. The line before the last lists both kernels with their launch
counts, errors, times and bounds; the last line of stdout is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import functools
import json
import subprocess
import sys
import time

import numpy as np
import torch

from rd_vio_tpu_torch.config import Config
from rd_vio_tpu_torch.datasets import synthetic
from rd_vio_tpu_torch.datasets.renderer import SequenceRenderer
from rd_vio_tpu_torch.models import builders
from rd_vio_tpu_torch.models.feature_tracker import FeatureTracker
from rd_vio_tpu_torch.models.handler import Handler
from rd_vio_tpu_torch.models.image_backend import TorchImageBackend
from rd_vio_tpu_torch.ops.image import klt
from rd_vio_tpu_torch.ops.image import pyramid as pyr_mod
from rd_vio_tpu_torch.tools import lk_bench
from rd_vio_tpu_torch.utils.metrics import GLOBAL_TIMER, DeviceStageTimer

W_IMG, H_IMG = 752, 480
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


def phase_b(cfg, seq, frames, dev):
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


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python "
          f"{sys.version.split()[0]}; device {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    klt.load_kernel()
    print(f"LK kernels: built in {klt.build_seconds:.2f} s, loaded in "
          f"{time.perf_counter() - t0:.2f} s")
    for line in klt.build_kernel().with_suffix(".ptxas.txt").read_text().splitlines():
        if "registers" in line or "Compiling" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")

    seq = synthetic.generate(duration=8.0, n_landmarks=1200, max_keypoints=150,
                             excitation=0.05)
    rend = SequenceRenderer(seq, image_size=(W_IMG, H_IMG))
    t_r = time.perf_counter()
    frames = [np.asarray(rend.render(i), np.uint8) for i in range(len(seq.t_frame))]
    print(f"rendered {len(frames)} frames at {W_IMG}x{H_IMG} in "
          f"{time.perf_counter() - t_r:.1f} s")
    cfg = make_config(rend.K)

    fused, level = phase_a(cfg, frames, dev)
    sink_b, fused["launches"], _ = phase_b(cfg, seq, frames, dev)
    phase_c(cfg, seq, frames, dev, sink_b)
    level["launches"] = phase_d(cfg, seq, frames, dev, sink_b)

    print(json.dumps({"kernels": [fused, level]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
