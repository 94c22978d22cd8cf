"""Pyramidal Lucas-Kanade keypoint tracking, batched over keypoints.

Behavioral reference: cv::calcOpticalFlowPyrLK as used by
opencv_image.cpp:75-154 — 21x21 window, 30 iterations (epsilon 0.01
termination), initial-flow seeding, border and max-displacement (rows/4)
rejection, and the reverse-flow check (backtrack error > 0.5 px => reject).
LK runs over every image of the pyramid it is given (4 for
`build_pyramid(levels=3)`).

Two hand-written CUDA kernels (csrc/lk_track.cu, one shared library), each
with its wrapper, its plain PyTorch version and its launch counter:

- `lk_track_fwd_rev`: the whole forward + reverse track of a frame pair in
  ONE launch (initial guess, all levels coarse to fine, the forward status
  rules, the reverse track, its rules, the back-track error test). This is
  what the tracking stage calls. Plain version: `lk_track_fwd_rev_plain`,
  the composition of `lk_track_pyramid` twice over a level function.
  Counter: `fwd_rev_launches`.
- `lk_level`: one pyramid level (window loads, template, gradients, normal
  matrix, Gauss-Newton iterations). Plain version: `lk_level_plain`, the
  "windowed" form of the JAX package (ops/image/klt.py `prepare_level` +
  `_lk_level_windowed`): per keypoint a SW x SW search window, a bilinear
  template built as `Wy @ S @ Wx^T` with two-nonzero blend matrices, and
  Gauss-Newton steps on the 2x2 normal matrix. It runs `iters` iterations
  with a per-keypoint active mask (a converged keypoint no longer moves, so
  this equals the early exit) and on the card never synchronises with the
  host; on the CPU it stops once no keypoint is active (the same result).
  Counter: `launches`. `lk_level_iters` is the same launch and
  also returns the iterations each keypoint ran.

On a CPU tensor a wrapper runs its plain version; on a CUDA tensor it
launches its kernel or raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import torch

HALF = 10  # 21x21 window
WIN = 2 * HALF + 1  # 21
EXT = WIN + 2  # template + 1px ring for central-difference gradients
MARGIN = 8  # per-level search slack around the initial guess (px)
SW = EXT + 1 + 2 * MARGIN  # 40: search window side (+1 for bilinear)
PADB = HALF + 2 + MARGIN  # edge padding so in-image windows never clamp

_SRC = Path(__file__).resolve().parents[2] / "csrc" / "lk_track.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "_build"

MAX_LEVELS = 8  # pyramid levels the fused kernel's argument struct holds

# kernel launches made by `lk_level` / `lk_level_iters` and by
# `lk_track_fwd_rev` (one per call on CUDA tensors); incremented under
# `_count_lock` (a threaded Odometry tracks in a worker thread)
launches = 0
fwd_rev_launches = 0
_count_lock = threading.Lock()
# seconds the last `load_kernel` spent compiling (0.0 when the .so was there)
build_seconds = 0.0

_lib = None
_lib_lock = threading.Lock()


# ---------------------------------------------------------------------------
# plain PyTorch level (windowed form)
# ---------------------------------------------------------------------------

def _blend_matrix(offset: torch.Tensor, rows: int) -> torch.Tensor:
    """(N, rows, SW) bilinear row-selection matrices: row r has (1-f) at i+r
    and f at i+r+1, where offset = i + f (i integer part clamped in-window)."""
    i = torch.clamp(torch.floor(offset), 0.0, float(SW - rows - 1))
    f = torch.clamp(offset - i, 0.0, 1.0)
    ii = i.to(torch.int64)
    dev = offset.device
    col = torch.arange(SW, device=dev)[None, None, :]
    row = torch.arange(rows, device=dev)[None, :, None]
    d = col - row - ii[:, None, None]
    fb = f[:, None, None]
    return torch.where(d == 0, 1.0 - fb, 0.0) + torch.where(d == 1, fb, 0.0)


def _window_origin(c: torch.Tensor, limit: int) -> torch.Tensor:
    """clip(floor(c) - (HALF + 1) - MARGIN, 0, limit) as int64."""
    o = torch.floor(c) - float(HALF + 1 + MARGIN)
    return torch.clamp(torch.nan_to_num(o, nan=0.0), 0.0, float(limit)).to(torch.int64)


def _extract_windows(img_pad: torch.Tensor, cy: torch.Tensor, cx: torch.Tensor):
    """Batched (SW, SW) window extraction from the PADB-edge-padded image.
    cy/cx: float center coords in padded frame. Returns (S, oy, ox)."""
    Hp, Wp = img_pad.shape
    oy = _window_origin(cy, Hp - SW)
    ox = _window_origin(cx, Wp - SW)
    r = torch.arange(SW, device=img_pad.device)
    rows = oy[:, None] + r[None, :]
    cols = ox[:, None] + r[None, :]
    S = img_pad[rows[:, :, None], cols[:, None, :]]
    return S, oy, ox


def prepare_level(img_prev_pad, img_next_pad, pts, guess):
    """Per-level setup: search-window extraction, bilinear template +
    gradients, LK normal matrix. pts/guess: (N, 2) in padded-frame coords.

    Returns (S2, I, Ix, Iy, a, b, c, inv_det, min_eig, oy2, ox2)."""
    f32 = torch.float32
    px, py = pts[:, 0], pts[:, 1]
    gx0, gy0 = guess[:, 0], guess[:, 1]

    S1, oy1, ox1 = _extract_windows(img_prev_pad, py, px)
    S2, oy2, ox2 = _extract_windows(img_next_pad, gy0, gx0)

    # template: EXT x EXT bilinear patch (one-px ring for gradients)
    ty = py - (HALF + 1) - oy1.to(f32)
    tx = px - (HALF + 1) - ox1.to(f32)
    Wy_t = _blend_matrix(ty, EXT)
    Wx_t = _blend_matrix(tx, EXT)
    I_ext = Wy_t @ S1 @ Wx_t.transpose(1, 2)
    I = I_ext[:, 1:-1, 1:-1]
    Ix = 0.5 * (I_ext[:, 1:-1, 2:] - I_ext[:, 1:-1, :-2])
    Iy = 0.5 * (I_ext[:, 2:, 1:-1] - I_ext[:, :-2, 1:-1])

    a = (Ix * Ix).sum(dim=(1, 2))
    b = (Ix * Iy).sum(dim=(1, 2))
    c = (Iy * Iy).sum(dim=(1, 2))
    det = a * c - b * b
    tr = a + c
    min_eig = 0.5 * (tr - torch.sqrt(torch.clamp(tr * tr - 4 * det, min=0.0))) / (
        WIN * WIN
    )
    inv_det = torch.where(det.abs() > 1e-12, 1.0 / det, 0.0)
    return S2, I, Ix, Iy, a, b, c, inv_det, min_eig, oy2, ox2


def lk_level_plain(img_prev, img_next, pts, guess, valid,
                   iters: int = 30, eps: float = 0.01):
    """One pyramid level for all keypoints, plain PyTorch.

    img_prev/img_next: (H, W) f32 level images (unpadded); pts: (N, 2)
    template centers and guess: (N, 2) initial estimate of the tracked
    position, both [x, y] in PADB-padded coordinates; valid: (N,) bool.
    Returns (tracked (N, 2) in padded coordinates, min_eig (N,))."""
    return _lk_level_plain_iters(img_prev, img_next, pts, guess, valid,
                                 iters, eps)[:2]


def _lk_level_plain_iters(img_prev, img_next, pts, guess, valid, iters, eps):
    """`lk_level_plain` plus the iterations each keypoint ran (N,) int32."""
    f32 = torch.float32
    pad = lambda a: torch.nn.functional.pad(  # noqa: E731
        a.to(f32)[None, None], (PADB,) * 4, mode="replicate")[0, 0]
    px, py = pts[:, 0], pts[:, 1]
    S2, I, Ix, Iy, a, b, c, inv_det, min_eig, oy2, ox2 = prepare_level(
        pad(img_prev), pad(img_next), pts, guess
    )
    flow = guess - pts
    active = valid.clone()
    on_cpu = pts.device.type == "cpu"
    n_iter = torch.zeros(pts.shape[0], dtype=torch.int32, device=pts.device)
    for _ in range(iters):
        n_iter = n_iter + active
        qx = px + flow[:, 0]
        qy = py + flow[:, 1]
        uy = qy - HALF - oy2.to(f32)
        ux = qx - HALF - ox2.to(f32)
        Wy = _blend_matrix(uy, WIN)
        Wx = _blend_matrix(ux, WIN)
        J = Wy @ S2 @ Wx.transpose(1, 2)
        r = I - J
        g1 = (Ix * r).sum(dim=(1, 2))
        g2 = (Iy * r).sum(dim=(1, 2))
        dx = inv_det * (c * g1 - b * g2)
        dy = inv_det * (a * g2 - b * g1)
        step = torch.stack([dx, dy], dim=-1)
        flow = flow + torch.where(active[:, None], step, 0.0)
        active = active & ((step * step).sum(dim=-1) >= eps * eps)
        if on_cpu and not bool(active.any()):
            break  # the rest would change nothing (on the card: no host sync)
    return pts + flow, min_eig, n_iter


# ---------------------------------------------------------------------------
# the CUDA kernel: build, load, wrapper
# ---------------------------------------------------------------------------

def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the LK kernel cannot be built")
    return path


class _Pyramids(ctypes.Structure):
    """`struct Pyramids` of csrc/lk_track.cu: level pointers and sizes."""

    _fields_ = [
        ("prev", ctypes.c_void_p * MAX_LEVELS),
        ("next", ctypes.c_void_p * MAX_LEVELS),
        ("H", ctypes.c_int * MAX_LEVELS),
        ("W", ctypes.c_int * MAX_LEVELS),
        ("levels", ctypes.c_int),
    ]


def build_kernel(src: Path = _SRC) -> Path:
    """Compile `src` for sm_90a unless its shared library is there already.

    The library goes to rd_vio_tpu_torch/_build/ under a name that carries
    the source's hash, so an edited source is rebuilt; what ptxas says of
    each kernel (registers, shared memory, spills) is kept beside it."""
    global build_seconds
    tag = hashlib.sha256(src.read_bytes()).hexdigest()[:12]
    so = BUILD_DIR / f"liblk_track_{tag}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
               "-Xptxas", "-v", "-o", tmp, str(src)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, so)
        build_seconds = time.perf_counter() - t0
        so.with_suffix(".ptxas.txt").write_text(proc.stderr)
    return so


def bind_kernel(so: Path) -> ctypes.CDLL:
    """Load a library built by `build_kernel` and declare its two entry
    points (a pointer passed without `argtypes` would be cut to 32 bits)."""
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib = ctypes.CDLL(str(so))
    lib.rdvio_lk_level.argtypes = [
        ptr, ptr, i32, i32, ptr, ptr, ptr, i32, i32, f32, ptr, ptr, ptr, ptr]
    lib.rdvio_lk_level.restype = i32
    lib.rdvio_lk_fwd_rev.argtypes = [
        ctypes.POINTER(_Pyramids), ptr, ptr, ptr, i32, i32, f32, f32, f32,
        ptr, ptr, ptr]
    lib.rdvio_lk_fwd_rev.restype = i32
    return lib


def load_kernel() -> ctypes.CDLL:
    """Build (once per source hash) and load csrc/lk_track.cu."""
    global _lib
    with _lib_lock:
        if _lib is None:
            _lib = bind_kernel(build_kernel())
        return _lib


def _check(fn, name, t, dtype, shape, device):
    """Raise unless tensor `t` is what the kernel takes. `name` is a string,
    or (format, index) for a pyramid level; the message is only built for a
    tensor that fails (this runs a dozen times per tracked frame)."""
    if (t.dtype is dtype and t.shape == shape and t.device == device
            and t.is_contiguous()):
        return
    if not isinstance(name, str):
        name = name[0] % name[1]
    if t.device != device:
        raise ValueError(f"{fn}: {name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{fn}: {name} has dtype {t.dtype}, expected {dtype}")
    if t.shape != shape:
        raise ValueError(f"{fn}: {name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    raise ValueError(f"{fn}: {name} is not contiguous")


def lk_level(img_prev, img_next, pts, guess, valid,
             iters: int = 30, eps: float = 0.01):
    """One pyramid level through the CUDA kernel (same contract as
    `lk_level_plain`). CPU tensors take `lk_level_plain`; CUDA tensors
    launch the kernel or raise; any other device raises."""
    return _lk_level(img_prev, img_next, pts, guess, valid, iters, eps, False)[:2]


def lk_level_iters(img_prev, img_next, pts, guess, valid,
                   iters: int = 30, eps: float = 0.01):
    """`lk_level` that also returns the Gauss-Newton iterations each
    keypoint ran, (N,) int32 (0 for an invalid one): what a measurement
    needs to count the operations of a call."""
    return _lk_level(img_prev, img_next, pts, guess, valid, iters, eps, True)


def _lk_level(img_prev, img_next, pts, guess, valid, iters, eps, want_iters):
    global launches
    dev = img_prev.device
    if dev.type == "cpu":
        return _lk_level_plain_iters(img_prev, img_next, pts, guess, valid,
                                     iters, eps)
    if dev.type != "cuda":
        raise ValueError(f"lk_level: unsupported device {dev}")
    H, W = img_prev.shape
    n = pts.shape[0]
    _check("lk_level", "img_prev", img_prev, torch.float32, (H, W), dev)
    _check("lk_level", "img_next", img_next, torch.float32, (H, W), dev)
    _check("lk_level", "pts", pts, torch.float32, (n, 2), dev)
    _check("lk_level", "guess", guess, torch.float32, (n, 2), dev)
    _check("lk_level", "valid", valid, torch.bool, (n,), dev)
    tracked = torch.empty((n, 2), dtype=torch.float32, device=dev)
    min_eig = torch.empty((n,), dtype=torch.float32, device=dev)
    n_iter = (torch.empty((n,), dtype=torch.int32, device=dev)
              if want_iters else None)
    if n == 0:
        return tracked, min_eig, n_iter
    lib = load_kernel()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.rdvio_lk_level(
            img_prev.data_ptr(), img_next.data_ptr(), H, W,
            pts.data_ptr(), guess.data_ptr(), valid.data_ptr(), n,
            int(iters), eps * eps, tracked.data_ptr(), min_eig.data_ptr(),
            n_iter.data_ptr() if want_iters else None, stream,
        )
    if rc != 0:
        raise RuntimeError(f"lk_level: CUDA kernel launch failed (error {rc})")
    with _count_lock:
        launches += 1
    return tracked, min_eig, n_iter


# ---------------------------------------------------------------------------
# the whole track: pyramid + status rules + reverse check
# ---------------------------------------------------------------------------

MIN_EIG_THRESH = 1e-4  # conditioning gate on the level-0 template
EPS = 0.01  # Gauss-Newton step at which a keypoint stops iterating (px)


def lk_track_pyramid(pyr_prev, pyr_next, pts_prev, pts_pred, valid,
                     iters: int = 30, min_eig_thresh: float = MIN_EIG_THRESH,
                     eps: float = EPS, level=lk_level_plain):
    """Track pts_prev (N, 2 [x, y]) from pyr_prev to pyr_next, one call of
    `level` per pyramid level.

    pyr_*: list of (H, W) f32 images, fine-to-coarse (from build_pyramid).
    pts_pred: initial guess for the tracked position (IMU-predicted flow).
    level: `lk_level_plain` or `lk_level` (kernel on CUDA).

    Returns (pts_next (N, 2), status (N,) bool) with border /
    max-displacement / min-eigenvalue / non-finite rejection."""
    f32 = torch.float32
    levels = len(pyr_prev)
    H, W = pyr_prev[0].shape
    pts_prev = pts_prev.to(f32)
    pts = pts_prev
    scale_top = 2.0 ** (levels - 1)
    guess = pts / scale_top + (pts_pred.to(f32) - pts) / scale_top

    min_eig = None
    for L in reversed(range(levels)):
        s = 2.0 ** L
        pl_pts = pts / s
        tracked, min_eig = level(
            pyr_prev[L].contiguous(), pyr_next[L].contiguous(),
            (pl_pts + PADB).contiguous(), (guess + PADB).contiguous(),
            valid.contiguous(), iters, eps,
        )
        tracked = tracked - PADB
        guess = tracked * 2.0 if L > 0 else tracked

    pts_next = guess
    disp = torch.linalg.vector_norm(pts_next - pts_prev, dim=-1)
    inb = (
        (pts_next[:, 0] >= HALF) & (pts_next[:, 0] < W - HALF)
        & (pts_next[:, 1] >= HALF) & (pts_next[:, 1] < H - HALF)
    )
    status = (
        valid
        & inb
        & torch.isfinite(pts_next).all(dim=-1)
        & (disp < H / 4.0)  # reference opencv_image.cpp max displacement rows/4
        & (min_eig > min_eig_thresh)
    )
    return pts_next, status


def lk_track_fwd_rev_plain(pyr_prev, pyr_next, pts_prev, pts_pred, valid,
                           iters: int = 30, max_err: float = 0.5,
                           level=lk_level_plain):
    """Forward track + reverse-flow consistency check (reference
    opencv_image.cpp:130-150), level by level in PyTorch: track back from
    the forward result (guess = pts_prev, valid = forward status) and
    require the backtrack to land within max_err px. The plain version of
    the fused kernel; with `level=lk_level` it is the per-level kernel path
    (one launch per level and direction)."""
    tracked, status = lk_track_pyramid(
        pyr_prev, pyr_next, pts_prev, pts_pred, valid, iters=iters, level=level
    )
    back, st_b = lk_track_pyramid(
        pyr_next, pyr_prev, tracked, pts_prev, status, iters=iters, level=level
    )
    err = torch.linalg.vector_norm(back - pts_prev.to(torch.float32), dim=-1)
    return tracked, status & st_b & (err <= max_err)


def lk_track_fwd_rev(pyr_prev, pyr_next, pts_prev, pts_pred, valid,
                     iters: int = 30, max_err: float = 0.5):
    """Forward + reverse track through the fused CUDA kernel: one launch for
    all levels, both directions and the status rules (same contract as
    `lk_track_fwd_rev_plain`). CPU tensors take the plain version; CUDA
    tensors launch the kernel or raise; any other device raises.

    pyr_*: lists of at most MAX_LEVELS contiguous (H, W) f32 images, fine
    to coarse, of equal shapes in both pyramids; pts_prev / pts_pred (N, 2)
    f32 [x, y]; valid (N,) bool. Returns (tracked (N, 2) f32, status (N,)
    bool)."""
    global fwd_rev_launches
    fn = "lk_track_fwd_rev"
    if len(pyr_prev) != len(pyr_next) or not pyr_prev:
        raise ValueError(f"{fn}: pyramids of {len(pyr_prev)} and "
                         f"{len(pyr_next)} levels")
    dev = pyr_prev[0].device
    if dev.type == "cpu":
        return lk_track_fwd_rev_plain(pyr_prev, pyr_next, pts_prev, pts_pred,
                                      valid, iters, max_err)
    if dev.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {dev}")
    levels = len(pyr_prev)
    if levels > MAX_LEVELS:
        raise ValueError(f"{fn}: {levels} levels, at most {MAX_LEVELS}")
    pyr = _Pyramids(levels=levels)
    for L, (a, b) in enumerate(zip(pyr_prev, pyr_next)):
        if a.dim() != 2:
            raise ValueError(f"{fn}: pyr_prev[{L}] is not an (H, W) image")
        _check(fn, ("pyr_prev[%d]", L), a, torch.float32, a.shape, dev)
        _check(fn, ("pyr_next[%d]", L), b, torch.float32, a.shape, dev)
        pyr.prev[L], pyr.next[L] = a.data_ptr(), b.data_ptr()
        pyr.H[L], pyr.W[L] = a.shape
    n = pts_prev.shape[0]
    _check(fn, "pts_prev", pts_prev, torch.float32, (n, 2), dev)
    _check(fn, "pts_pred", pts_pred, torch.float32, (n, 2), dev)
    _check(fn, "valid", valid, torch.bool, (n,), dev)
    tracked = torch.empty((n, 2), dtype=torch.float32, device=dev)
    status = torch.empty((n,), dtype=torch.bool, device=dev)
    if n == 0:
        return tracked, status
    lib = load_kernel()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.rdvio_lk_fwd_rev(
            ctypes.byref(pyr), pts_prev.data_ptr(), pts_pred.data_ptr(),
            valid.data_ptr(), n, int(iters), EPS * EPS, MIN_EIG_THRESH,
            float(max_err), tracked.data_ptr(), status.data_ptr(), stream,
        )
    if rc != 0:
        raise RuntimeError(f"{fn}: CUDA kernel launch failed (error {rc})")
    with _count_lock:
        fwd_rev_launches += 1
    return tracked, status
