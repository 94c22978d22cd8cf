"""Inputs and timing for the LK kernels, and the group-size comparison.

Shared by chip_smoke.py, the tests and this module's own script:

- `edge_case_keypoints`: a keypoint set built to trip every status rule of
  the tracker (invalid slot, NaN prediction, prediction far beyond rows/4,
  flat patch, all four borders) among ordinary well-textured points;
- `main_path_keypoints`: the 384 keypoints chip_smoke.py tracks in phase A;
- `cuda_ms`: mean device time of a call from CUDA events, with the host
  running ahead of the device, and `host_us`, the host's time per call.

Run as a script on a GPU,

    python3 -m rd_vio_tpu_torch.tools.lk_bench [other_lk_track.cu ...]

it compares the threads-per-keypoint / threads-per-block choices of
csrc/lk_track.cu. The source holds one choice (`GROUP`, `BLOCK`); the script
writes a copy of the source per candidate with those two constants replaced,
builds all copies at once, checks each against the plain tracker and times
the fused launch and one level-0 launch of each in alternation on a
rendered 752x480 frame pair with 384 keypoints; the fused launch is also
timed with the iteration limit at 0, 1 and 5 (every keypoint then runs the
same count per level), which splits its time into the loads and templates
of 8 levels and the cost of an iteration. Any further source named on the
command line (another version of lk_track.cu with the same C interface) is
built as it is and timed in the same alternation. The last line of stdout
is the table as JSON.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

EDGE_KINDS = ("invalid", "nan_pred", "far_pred", "flat", "border")

# (GROUP, BLOCK) candidates; static shared memory (12.9 KB per keypoint of a
# block) caps BLOCK / GROUP at 3
CANDIDATES = ((32, 32), (32, 64), (32, 96), (64, 64), (64, 128), (128, 128),
              (128, 256), (256, 256))


def paint_flat_patch(img, rect, value=100.0):
    """Copy of the (H, W) array or tensor `img` with rect = (y0, y1, x0, x1)
    set to one value: a patch without gradient."""
    out = img.clone() if isinstance(img, torch.Tensor) else np.array(img)
    y0, y1, x0, x1 = rect
    out[y0:y1, x0:x1] = value
    return out


def edge_case_keypoints(good, n, H, W, flat_rect, seed, per_kind):
    """n keypoints for an (H, W) frame pair: `per_kind` of each kind in
    EDGE_KINDS, the rest ordinary (a point of `good` with the prediction up
    to a pixel off). The frame pair must move by less than 3 px and be flat
    inside flat_rect = (y0, y1, x0, x1), which must be at least 40 px wide.

    Every edge case has status False by a margin of pixels, whichever rule
    trips first: the border points lie 2-4 px from an edge (the rule wants
    10), the far predictions rows/4 + 300 px or 5000 px away, the flat
    points at least 13 px inside the patch (min_eig is exactly 0).

    Returns numpy (pts (n, 2) f32, pred (n, 2) f32, valid (n,) bool,
    kind (n,) int: index into EDGE_KINDS, -1 for ordinary)."""
    rng = np.random.default_rng(seed)
    good = np.asarray(good, np.float32)
    pts = good[np.arange(n) % len(good)].copy()
    pred = (pts + rng.uniform(-1.0, 1.0, pts.shape)).astype(np.float32)
    valid = np.ones(n, bool)
    kind = np.full(n, -1)
    slots = rng.permutation(n)[:per_kind * len(EDGE_KINDS)].reshape(
        len(EDGE_KINDS), per_kind)
    for k, name in enumerate(EDGE_KINDS):
        kind[slots[k]] = k
        for j, s in enumerate(slots[k]):
            if name == "invalid":
                valid[s] = False
            elif name == "nan_pred":
                pred[s, [[0], [1], [0, 1]][j % 3]] = np.nan
            elif name == "far_pred":
                far = 5000.0 if j % 2 else H / 4.0 + 300.0
                pred[s] = pts[s]
                pred[s, (j // 2) % 2] += far if (j // 4) % 2 else -far
            elif name == "flat":
                y0, y1, x0, x1 = flat_rect
                pts[s] = (rng.uniform(x0 + 13, x1 - 14), rng.uniform(y0 + 13, y1 - 14))
                pred[s] = pts[s] + rng.uniform(-1.0, 1.0, 2)
            elif name == "border":
                d = rng.uniform(2.0, 4.0)
                x, y = rng.uniform(30, W - 30), rng.uniform(30, H - 30)
                pts[s] = [(d, y), (W - 1 - d, y), (x, d), (x, H - 1 - d)][j % 4]
                pred[s] = pts[s]
    return pts, pred.astype(np.float32), valid, kind


def main_path_keypoints(pyr, n, width, height, dev, seed=648):
    """n valid keypoints as the tracking stage holds them: the GFTT corners
    of pyr[0] (5 px apart), the remaining slots filled with seeded random
    interior points. Returns (pix (n, 2) f32 on dev, corner (n,) bool)."""
    from rd_vio_tpu_torch.ops.image import gftt

    pix, val, _ = gftt.detect_gftt(
        pyr[0], torch.zeros((1, 2), device=dev),
        torch.zeros(1, dtype=torch.bool, device=dev),
        max_points=n, min_dist=5.0)
    rng = np.random.default_rng(seed)
    fill = np.stack([rng.uniform(20, width - 20, n),
                     rng.uniform(20, height - 20, n)], -1).astype(np.float32)
    pix = torch.where(val[:, None], pix, torch.from_numpy(fill).to(dev))
    return pix.contiguous(), val


def cuda_ms(fn, reps: int, run_ahead: bool = True) -> float:
    """Mean device ms of fn() over `reps` back-to-back calls (CUDA events).

    A call whose kernels take less time than the host needs to enqueue them
    would be timed at the host's pace. With `run_ahead` the device is first
    kept busy (a spin kernel) for as long as the host needs to enqueue all
    the calls, so that they then run back to back and the events measure
    device time alone. With run_ahead=False the result is the time per call
    as a caller in a loop sees it, host included."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if run_ahead:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        host_s = (time.perf_counter() - t0) * reps * 1.5 + 1e-3
        if host_s < 0.2:  # a slower call is not bound by its enqueue time
            khz = torch.cuda.get_device_properties(0).clock_rate
            torch.cuda._sleep(int(host_s * khz * 1e3))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def host_us(fn, reps: int) -> float:
    """Mean host microseconds fn() takes to return (enqueue only)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / reps * 1e6


def _variant_source(klt, group: int, block: int) -> Path:
    src = klt._SRC.read_text()
    src, n1 = re.subn(r"constexpr int GROUP = \d+;", f"constexpr int GROUP = {group};", src)
    src, n2 = re.subn(r"constexpr int BLOCK = \d+;", f"constexpr int BLOCK = {block};", src)
    if (n1, n2) != (1, 1):
        raise RuntimeError("lk_track.cu: GROUP / BLOCK constants not found")
    klt.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path = klt.BUILD_DIR / f"lk_track_g{group}_b{block}.cu"
    path.write_text(src)
    return path


def main():
    if not torch.cuda.is_available():
        print("lk_bench: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 1
    from rd_vio_tpu_torch.config import Config
    from rd_vio_tpu_torch.datasets import synthetic
    from rd_vio_tpu_torch.datasets.renderer import SequenceRenderer
    from rd_vio_tpu_torch.models.image_backend import TorchImageBackend
    from rd_vio_tpu_torch.ops.image import klt

    dev = torch.device("cuda", 0)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    W, H, N = 752, 480, 384
    seq = synthetic.generate(duration=8.0, n_landmarks=1200, max_keypoints=150,
                             excitation=0.05)
    rend = SequenceRenderer(seq, image_size=(W, H))
    be = TorchImageBackend(Config(), dev)
    pa, pb = (be.preprocess(np.asarray(rend.render(i), np.uint8)).pyramid
              for i in (0, 1))
    pix, _ = main_path_keypoints(pa, N, W, H, dev)
    val = torch.ones(N, dtype=torch.bool, device=dev)
    pad = (pix + klt.PADB).contiguous()

    variants = {f"GROUP {g:3d} BLOCK {b:3d}": _variant_source(klt, g, b)
                for g, b in CANDIDATES}
    variants.update({path: Path(path) for path in sys.argv[1:]})
    with ThreadPoolExecutor(len(variants)) as pool:
        libs = list(pool.map(
            lambda src: klt.bind_kernel(klt.build_kernel(src)), variants.values()))
    tr_p, st_p = klt.lk_track_fwd_rev_plain(pa, pb, pix, pix, val)

    fused = lambda: klt.lk_track_fwd_rev(pa, pb, pix, pix, val)  # noqa: E731
    level = lambda: klt.lk_level(pa[0], pb[0], pad, pad, val)  # noqa: E731
    capped = {f"fwd_rev_ms_iters{i}": (lambda i=i: klt.lk_track_fwd_rev(
        pa, pb, pix, pix, val, iters=i)) for i in (0, 1, 5)}
    rows = {gb: {"fwd_rev_ms": [], "level_ms": [], "fwd_rev_call_ms": [],
                 "fwd_rev_host_us": [], **{k: [] for k in capped}}
            for gb in variants}
    for rnd in range(4):  # round 0 warms up
        for gb, lib in zip(variants, libs):
            klt._lib = lib  # route the wrappers through this candidate
            if rnd == 0:
                tr, st = fused()
                both = st & st_p
                d = torch.linalg.vector_norm(tr - tr_p, dim=-1)[both]
                rows[gb]["status_agreement"] = float((st == st_p).float().mean())
                rows[gb]["median_px"] = float(d.median())
                level()
                continue
            rows[gb]["fwd_rev_ms"].append(cuda_ms(fused, 200))
            rows[gb]["level_ms"].append(cuda_ms(level, 200))
            for k, fn in capped.items():
                rows[gb][k].append(cuda_ms(fn, 100))
            rows[gb]["fwd_rev_call_ms"].append(cuda_ms(fused, 200, run_ahead=False))
            rows[gb]["fwd_rev_host_us"].append(host_us(fused, 200))
    klt._lib = None
    out = []
    for name, r in rows.items():
        r = dict({k: float(np.mean(v)) if isinstance(v, list) else v
                  for k, v in r.items()}, variant=name)
        out.append(r)
        print(f"{name}: fused fwd+rev {r['fwd_rev_ms']:.4f} ms "
              f"(iteration limit 0 / 1 / 5: {r['fwd_rev_ms_iters0']:.4f} / "
              f"{r['fwd_rev_ms_iters1']:.4f} / {r['fwd_rev_ms_iters5']:.4f}), "
              f"level 0 {r['level_ms']:.4f} ms; fused in a loop, host included, "
              f"{r['fwd_rev_call_ms']:.4f} ms per call, host alone "
              f"{r['fwd_rev_host_us']:.1f} us; status agreement "
              f"{r['status_agreement']:.4f}, median diff {r['median_px']:.2e} px")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
