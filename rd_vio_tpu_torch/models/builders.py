"""Host -> device assembly: turn Map/Track bookkeeping into fixed-shape
problems (BA solves, marginalization, preintegration, triangulation) and
apply the results back.

Port of the JAX package's models/builders.py. The host half (NumPy: `Caps`,
`BASpec`, `_assemble`, the validation and triangulation assembly, the
result application) is a copy. Each `@jax.jit` program of that module is
here one plain function on the caller's device, under the JAX name without
`_jit` (`solve_noprior`, `fused_localize_subwindow_chain`, `fused_keyframe`,
`marginalize_tail`, ...), so a reader finds the twin. Every array of a
problem goes up through `utils/host.to_device` (pinned, non-blocking).

Host syncs, which the JAX programs do not have: `estimation/ba.solve_ba`
reads its stop flag once per LM iteration, and `torch.linalg.eigh` waits for
the device on CUDA (once per batched triangulation, twice per
marginalization). `PROGRAM_STATS` counts the calls of each program and the
LM iterations its solves ran.
"""

from __future__ import annotations

import collections
import dataclasses
import logging
import threading
import types
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.func import vmap
from torch.utils._pytree import tree_map

from rd_vio_tpu_torch.estimation import ba, factors as F, marginalization
from rd_vio_tpu_torch.estimation.state import FrameStates
from rd_vio_tpu_torch.models.map import Frame, Track
from rd_vio_tpu_torch.models.quat_np import q_to_R, qconj, qrot
from rd_vio_tpu_torch.ops import preintegration as pre
from rd_vio_tpu_torch.ops import preintegration_np as pre_np
from rd_vio_tpu_torch.ops import triangulate as tri
from rd_vio_tpu_torch.ops.lie import quat_conj, quat_mul, quat_normalize, quat_rotate
from rd_vio_tpu_torch.utils.host import fetch, to_device
from rd_vio_tpu_torch.utils.metrics import GLOBAL_TIMER as _T


# fully fused keyframe steps run (steady state: the window has filled)
KF_FUSED_COUNT = types.SimpleNamespace(n=0)

# per device program: {"calls": n, "solves": n, "iterations": LM iterations}
PROGRAM_STATS: Dict[str, collections.Counter] = collections.defaultdict(collections.Counter)


# guards PROGRAM_STATS and KF_FUSED_COUNT: a threaded Odometry runs the
# programs in its estimator worker while the caller reads the counts, and a
# batched run's sequences run theirs on a pool of threads. ba.STATS counts
# per thread, so the differences below belong to `fn`.
_stats_lock = threading.Lock()


def _count(name: str, fn, *args, **kw):
    """fn(*args, **kw), its call and the LM iterations of its solves
    counted under `name` in PROGRAM_STATS, inside the span `prog.<name>`."""
    s0, i0 = ba.STATS.solves, ba.STATS.iterations
    with _T.time(f"prog.{name}"):
        out = fn(*args, **kw)
    with _stats_lock:
        st = PROGRAM_STATS[name]
        st["calls"] += 1
        st["solves"] += ba.STATS.solves - s0
        st["iterations"] += ba.STATS.iterations - i0
    return out


@dataclasses.dataclass(frozen=True)
class Caps:
    """Static capacities (same fields and defaults as the JAX package)."""

    W: int = 20  # frame slots per solve
    L: int = 512  # landmark slots
    O: int = 3072  # reprojection factor slots
    P: int = 512  # fixed-anchor reprojection-prior slots
    Fi: int = 24  # imu factor slots
    Fp: int = 4  # fixed-i imu-prior slots
    R: int = 256  # rotation-prior factor slots
    IMU: int = 96  # imu samples per frame interval
    IMU_KF: int = 512  # imu samples per keyframe chain
    TRI_VIEWS: int = 24  # views per track in batched triangulation
    TRI_PAD: int = 64  # per-keyframe triangulation batch


class CalibTree(NamedTuple):
    """Device-side calibration constants (f64)."""

    ext: F.Extrinsics
    sqrt_inv_cov2: torch.Tensor
    cov_w: torch.Tensor
    cov_a: torch.Tensor
    cov_bg: torch.Tensor
    cov_ba: torch.Tensor


@dataclasses.dataclass
class CalibArrays:
    """Config-derived calibration constants: host NumPy (f64) mirrors, which
    the host code reads in per-track loops, and their device copies
    (`tree`), made on `device` at first use."""

    K: np.ndarray  # intrinsics
    sqrt_inv_cov2: np.ndarray  # K-scaled pixel whitening
    q_bc_h: np.ndarray
    p_bc_h: np.ndarray
    q_bi_h: np.ndarray
    p_bi_h: np.ndarray
    cov_w_h: np.ndarray
    cov_a_h: np.ndarray
    cov_bg_h: np.ndarray
    cov_ba_h: np.ndarray
    device: str = "cuda"
    _tree: Optional[CalibTree] = dataclasses.field(default=None, repr=False)

    @property
    def tree(self) -> CalibTree:
        if self._tree is None:
            up = lambda a: to_device(np.asarray(a, np.float64), self.device)  # noqa: E731
            self._tree = CalibTree(
                ext=F.Extrinsics(q_bc=up(self.q_bc_h), p_bc=up(self.p_bc_h),
                                 q_bi=up(self.q_bi_h), p_bi=up(self.p_bi_h)),
                sqrt_inv_cov2=up(self.sqrt_inv_cov2), cov_w=up(self.cov_w_h),
                cov_a=up(self.cov_a_h), cov_bg=up(self.cov_bg_h),
                cov_ba=up(self.cov_ba_h))
        return self._tree

    @staticmethod
    def from_config(cfg, device="cuda") -> "CalibArrays":
        Km = np.asarray(cfg.camera_intrinsic, np.float64)
        # K-scaled pixel whitening (reference handler.cpp:117-119)
        sic2 = np.diag(
            [
                Km[0, 0] / np.sqrt(cfg.keypoint_noise_cov[0, 0]),
                Km[1, 1] / np.sqrt(cfg.keypoint_noise_cov[1, 1]),
            ]
        )
        f64 = lambda a: np.array(a, np.float64)  # noqa: E731
        return CalibArrays(
            K=Km, sqrt_inv_cov2=sic2,
            q_bc_h=f64(cfg.camera_to_body_rotation),
            p_bc_h=f64(cfg.camera_to_body_translation),
            q_bi_h=f64(cfg.imu_to_body_rotation),
            p_bi_h=f64(cfg.imu_to_body_translation),
            cov_w_h=f64(cfg.gyroscope_noise_cov),
            cov_a_h=f64(cfg.accelerometer_noise_cov),
            cov_bg_h=f64(cfg.gyroscope_bias_noise_cov),
            cov_ba_h=f64(cfg.accelerometer_bias_noise_cov),
            device=str(device),
        )


def _dev_of(calib: CalibTree) -> torch.device:
    return calib.cov_w.device


def _up(tree, device):
    """Every NumPy leaf of a (nested dict / NamedTuple / tuple) tree as a
    tensor on `device` (utils/host.to_device: pinned, non-blocking)."""
    if isinstance(tree, np.ndarray):
        return to_device(tree, device)
    if isinstance(tree, dict):
        return {k: _up(v, device) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_up(v, device) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_up(v, device) for v in tree)
    return tree


def _f64(a):
    return a.to(torch.float64)


# ---------------------------------------------------------------------------
# preintegration
# ---------------------------------------------------------------------------


def _integrate_batch(dts, ws, accs, bg0, ba0, cov_w, cov_a, cov_bg, cov_ba):
    eye = torch.eye(15, dtype=dts.dtype, device=dts.device)
    d = vmap(lambda dt, w, a, bg, ba_: pre.integrate(
        dt, w, a, bg, ba_, cov_w, cov_a, cov_bg, cov_ba))(dts, ws, accs, bg0, ba0)
    return d, pre.sqrt_inv_cov(d.cov + 1e-14 * eye)


def pad_imu(frame_imu: Tuple[np.ndarray, np.ndarray, np.ndarray], cap: int):
    dt, w, a = frame_imu
    n = min(len(dt), cap)
    dts = np.zeros(cap)
    ws = np.zeros((cap, 3))
    accs = np.zeros((cap, 3))
    dts[:n] = dt[:n]
    ws[:n] = w[:n]
    accs[:n] = a[:n]
    return dts, ws, accs


def integrate_frames(
    imu_list: List[Tuple[np.ndarray, np.ndarray, np.ndarray]],
    bg0s: np.ndarray,
    ba0s: np.ndarray,
    calib: CalibArrays,
    cap: int,
):
    """Batched preintegration of len(imu_list) intervals, padded to `cap`,
    on the calibration's device. Returns (PreintDelta, sqrt_inv_cov)."""
    n = len(imu_list)
    dts = np.zeros((n, cap))
    ws = np.zeros((n, cap, 3))
    accs = np.zeros((n, cap, 3))
    for i, imu in enumerate(imu_list):
        dts[i], ws[i], accs[i] = pad_imu(imu, cap)
    ct = calib.tree
    dev = _dev_of(ct)
    return _count("integrate_batch", _integrate_batch,
                  *(to_device(np.asarray(a, np.float64), dev) for a in (dts, ws, accs, bg0s, ba0s)),
                  ct.cov_w, ct.cov_a, ct.cov_bg, ct.cov_ba)


def predict_frame(frame_prev: Frame, frame: Frame, calib: CalibArrays, cap: int):
    """Preintegrate frame's interval at prev biases and propagate the state
    (reference mirror_frame tail / judge_track_status head). Mean-only host
    math."""
    frame.q, frame.p, frame.v = pre_np.predict_frame_mean(
        frame_prev.q, frame_prev.p, frame_prev.v, frame_prev.bg, frame_prev.ba,
        frame.imu_dt, frame.imu_w, frame.imu_a,
    )
    frame.bg = frame_prev.bg.copy()
    frame.ba = frame_prev.ba.copy()


def propagate_chain(frames: List[Frame], start: Frame, calib: CalibArrays, cap: int):
    """Re-propagate `frames` (in order) from `start`'s state — pure host math
    (reference feature_tracker.cpp:36-69 re-anchoring loop)."""
    prev = start
    for f in frames:
        f.q, f.p, f.v = pre_np.predict_frame_mean(
            prev.q, prev.p, prev.v, prev.bg, prev.ba,
            f.imu_dt, f.imu_w, f.imu_a,
        )
        f.bg, f.ba = prev.bg.copy(), prev.ba.copy()
        prev = f


def cast_floats(tree, dtype):
    """Every floating-point tensor of a (nested NamedTuple) tree as `dtype`;
    index and mask tensors stay as they are."""
    return tree_map(lambda a: a.to(dtype) if isinstance(a, torch.Tensor)
                    and a.is_floating_point() else a, tree)


# ---------------------------------------------------------------------------
# BA problem assembly (host, NumPy)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ReprojArrays:
    """Pre-vectorized reprojection factors: the same content as the `reproj`
    tuple list, already gathered into flat arrays by the model layer."""

    tgt: np.ndarray  # (n,) int32 target slot
    ref: np.ndarray  # (n,) int32 anchor slot
    lm: np.ndarray  # (n,) int32 landmark slot
    zr: np.ndarray  # (n, 3) anchor bearing
    zt: np.ndarray  # (n, 3) target bearing


@dataclasses.dataclass
class BASpec:
    """Declarative solve description filled by the model layer."""

    frames: List[Frame]  # slot order; slot 0..len-1
    fix_pose: List[bool]
    fix_motion: List[bool]
    opt_tracks: List[Track]  # landmark slots (inverse depth optimized)
    # (tgt_frame, anchor_frame, track, fixed_depth)
    reproj: List[Tuple[Frame, Frame, Track, bool]]
    # (frame_i, frame_j, (dt,w,a), bg0, ba0, use_kf_cap)
    imu: List[Tuple[Frame, Frame, tuple, np.ndarray, np.ndarray, bool]]
    # (tgt_frame, anchor_frame, track)
    rot: List[Tuple[Frame, Frame, Track]]
    prior: Optional[F.PriorFactor] = None  # over slots 0.. of `frames`
    # fixed-anchor reprojection priors: (tgt_frame, anchor_frame, track)
    reproj_prior: List[Tuple[Frame, Frame, Track]] = dataclasses.field(default_factory=list)
    # fixed-i preintegration priors: (frame_i, frame_j, (dt,w,a))
    imu_prior: List[Tuple[Frame, Frame, tuple]] = dataclasses.field(default_factory=list)
    # SoA fast lanes: when set, _assemble consumes these INSTEAD of the
    # `reproj` list / per-track opt_tracks loop (opt_invd aligns with
    # opt_tracks; landmark slot i == opt_tracks[i] for i < caps.L)
    reproj_arrays: Optional[ReprojArrays] = None
    opt_invd: Optional[np.ndarray] = None


def _anchor_row_maps(st, frames: List[Frame], kf_fids) -> tuple:
    """Per-store-row anchor lookup built once per window: for every track
    row anchored at a window KEYFRAME, its anchor's window slot and anchor
    bearing."""
    kfset = {int(x) for x in np.asarray(kf_fids).ravel()}
    a_slot = np.full(st.cap, -1, np.int64)
    a_bear = np.zeros((st.cap, 3))
    for ws, f in enumerate(frames):
        if f.id not in kfset:
            continue
        rows = st.rows_of(f.track_ids)
        msk = (rows >= 0) & (st.first_fid[np.clip(rows, 0, None)] == f.id)
        rr = rows[msk]
        a_slot[rr] = ws
        a_bear[rr] = f.bearings[np.flatnonzero(msk)]
    return a_slot, a_bear


def _reproj_arrays(parts) -> ReprojArrays:
    tgt_p, ref_p, lm_p, zr_p, zt_p = parts
    if not tgt_p:
        z = np.zeros(0, np.int32)
        return ReprojArrays(tgt=z, ref=z, lm=z, zr=np.zeros((0, 3)), zt=np.zeros((0, 3)))
    return ReprojArrays(
        tgt=np.concatenate(tgt_p).astype(np.int32),
        ref=np.concatenate(ref_p).astype(np.int32),
        lm=np.concatenate(lm_p).astype(np.int32),
        zr=np.concatenate(zr_p), zt=np.concatenate(zt_p),
    )


def window_reproj_arrays(st, frames: List[Frame], kf_fids, bits, pend_row,
                         opt_rows, L: int) -> ReprojArrays:
    """Window VI-BA reprojection factors as flat arrays (reference
    refine_window :226-337 factor selection), frame-major with keypoint-index
    inner order."""
    a_slot, a_bear = _anchor_row_maps(st, frames, kf_fids)
    lm_of_row = np.full(st.cap, -1, np.int64)
    n_lm = min(len(opt_rows), L)
    lm_of_row[opt_rows[:n_lm]] = np.arange(n_lm)
    parts = ([], [], [], [], [])
    for ws, f in enumerate(frames):
        rows = st.rows_of(f.track_ids)
        r = np.clip(rows, 0, None)
        fsel = (rows >= 0) & (((st.flags[r] & bits) == bits) | pend_row[r])
        ff = st.first_fid[r]
        fsel &= (ff != f.id) & np.isin(ff, kf_fids)
        fsel &= (lm_of_row[r] >= 0) & (a_slot[r] >= 0)
        idxs = np.flatnonzero(fsel)
        if len(idxs) == 0:
            continue
        rr = r[idxs]
        for part, val in zip(parts, (np.full(len(idxs), ws, np.int64), a_slot[rr],
                                     lm_of_row[rr], a_bear[rr], f.bearings[idxs])):
            part.append(val)
    return _reproj_arrays(parts)


def marg_reproj_arrays(st, frames: List[Frame], kf_fids, track_rows,
                       L: int) -> ReprojArrays:
    """Marginalization-problem reprojection factors as flat arrays
    (reference ceres/marginalization_factor.h:237-283 selection): every
    window-frame observation of the given victim-anchored tracks except the
    anchor's own, frame-major."""
    a_slot, a_bear = _anchor_row_maps(st, frames, kf_fids)
    lm_of_row = np.full(st.cap, -1, np.int64)
    n_lm = min(len(track_rows), L)
    lm_of_row[track_rows[:n_lm]] = np.arange(n_lm)
    parts = ([], [], [], [], [])
    for ws, f in enumerate(frames):
        rows = st.rows_of(f.track_ids)
        r = np.clip(rows, 0, None)
        fsel = (rows >= 0) & (lm_of_row[r] >= 0) & (a_slot[r] >= 0)
        fsel &= st.first_fid[r] != f.id  # anchor's own observation excluded
        idxs = np.flatnonzero(fsel)
        if len(idxs) == 0:
            continue
        rr = r[idxs]
        for part, val in zip(parts, (np.full(len(idxs), ws, np.int64), a_slot[rr],
                                     lm_of_row[rr], a_bear[rr], f.bearings[idxs])):
            part.append(val)
    return _reproj_arrays(parts)


def _frame_states(frames: List[Frame], W: int, device) -> FrameStates:
    q = np.tile([1.0, 0, 0, 0], (W, 1))
    p = np.zeros((W, 3))
    v = np.zeros((W, 3))
    bg = np.zeros((W, 3))
    ba_ = np.zeros((W, 3))
    for i, f in enumerate(frames):
        q[i], p[i], v[i], bg[i], ba_[i] = f.q, f.p, f.v, f.bg, f.ba
    return FrameStates(*(to_device(a, device) for a in (q, p, v, bg, ba_)))


class ProblemArrays(NamedTuple):
    """Host-assembled (NumPy) fixed-shape problem data: everything a solve
    needs except the marginalization prior (already on the device)."""

    # window states (W, ...)
    q: np.ndarray
    p: np.ndarray
    v: np.ndarray
    bg: np.ndarray
    ba: np.ndarray
    opt_pose: np.ndarray
    opt_motion: np.ndarray
    # landmarks (L,)
    invd: np.ndarray
    opt_lm: np.ndarray
    # reprojection factors (O, ...)
    o_tgt: np.ndarray
    o_ref: np.ndarray
    o_lm: np.ndarray
    o_zr: np.ndarray
    o_zt: np.ndarray
    o_val: np.ndarray
    # imu factors (Fi, ...), preintegrated on the host
    fi_i: np.ndarray
    fi_j: np.ndarray
    fi_val: np.ndarray
    fi_bg0: np.ndarray
    fi_ba0: np.ndarray
    fi_delta: dict  # PreintDelta fields + "sqrt_inv_cov", leading (Fi, ...)
    # fixed-anchor reprojection priors (P, ...)
    pp_tgt: np.ndarray
    pp_qref: np.ndarray
    pp_pref: np.ndarray
    pp_invd: np.ndarray
    pp_zr: np.ndarray
    pp_zt: np.ndarray
    pp_val: np.ndarray
    # fixed-i imu priors (Fp, ...), preintegrated on the host
    ip_j: np.ndarray
    ip_qi: np.ndarray
    ip_pi: np.ndarray
    ip_vi: np.ndarray
    ip_bgi: np.ndarray
    ip_bai: np.ndarray
    ip_val: np.ndarray
    ip_delta: dict  # PreintDelta fields + "sqrt_inv_cov", leading (Fp, ...)
    # rotation priors (R, ...)
    r_tgt: np.ndarray
    r_qref: np.ndarray
    r_zr: np.ndarray
    r_zt: np.ndarray
    r_val: np.ndarray


def _budget_warning(what: str, cap: str, n: int):
    logging.getLogger(__name__).warning(
        "solve assembly: %s budget exhausted (%s=%d); remaining factors "
        "dropped (raise Caps.%s)", what, cap, n, cap)


def _assemble(spec: BASpec, caps: Caps, calib: CalibArrays):
    """Host-side (pure NumPy) assembly of a BASpec into fixed-shape arrays,
    IMU intervals preintegrated here (ops/preintegration_np, f64).

    Returns (ProblemArrays, lm_slot_by_track_id)."""
    W, L, O, Fi, R = caps.W, caps.L, caps.O, caps.Fi, caps.R
    if len(spec.frames) > W:
        # defensive: drop trailing frames; factors referencing them are
        # skipped below via the slot lookup
        spec = dataclasses.replace(
            spec, frames=spec.frames[:W], fix_pose=spec.fix_pose[:W],
            fix_motion=spec.fix_motion[:W],
        )
    slot = {f.id: i for i, f in enumerate(spec.frames)}

    q = np.tile([1.0, 0, 0, 0], (W, 1))
    p = np.zeros((W, 3))
    v = np.zeros((W, 3))
    bg = np.zeros((W, 3))
    ba_ = np.zeros((W, 3))
    for i, f in enumerate(spec.frames):
        q[i], p[i], v[i], bg[i], ba_[i] = f.q, f.p, f.v, f.bg, f.ba

    opt_pose = np.zeros(W, bool)
    opt_motion = np.zeros(W, bool)
    for i, f in enumerate(spec.frames):
        opt_pose[i] = not spec.fix_pose[i]
        opt_motion[i] = not spec.fix_motion[i]

    lm_slot: Dict[int, int] = {}
    invd = np.ones(L)
    opt_lm = np.zeros(L, bool)
    if spec.opt_invd is not None:
        nl = len(spec.opt_tracks)
        if nl > L:
            logging.getLogger(__name__).warning(
                "solve assembly: landmark budget exhausted (L=%d); "
                "%d overflow landmarks dropped (raise Caps.L)", L, nl - L,
            )
            nl = L
        invd[:nl] = np.maximum(spec.opt_invd[:nl], 1e-6)
        opt_lm[:nl] = True
        lm_slot = {t.id: s for s, t in enumerate(spec.opt_tracks[:nl])}
    else:
        for t in spec.opt_tracks:
            if t.id in lm_slot or len(lm_slot) >= L:
                continue
            s = len(lm_slot)
            lm_slot[t.id] = s
            invd[s] = max(t.inv_depth, 1e-6)
            opt_lm[s] = True

    # reprojection factors
    o_tgt = np.zeros(O, np.int32)
    o_ref = np.zeros(O, np.int32)
    o_lm = np.zeros(O, np.int32)
    o_zr = np.tile([0.0, 0, 1.0], (O, 1))
    o_zt = np.tile([0.0, 0, 1.0], (O, 1))
    o_val = np.zeros(O, bool)
    oi = 0
    if spec.reproj_arrays is not None:
        ra = spec.reproj_arrays
        oi = len(ra.tgt)
        if oi > O:
            _budget_warning("observation", "O", O)
            oi = O
        o_tgt[:oi] = ra.tgt[:oi]
        o_ref[:oi] = ra.ref[:oi]
        o_lm[:oi] = ra.lm[:oi]
        o_zr[:oi] = ra.zr[:oi]
        o_zt[:oi] = ra.zt[:oi]
        o_val[:oi] = True
    for tgt, anchor, track, fixed_depth in spec.reproj:
        if oi >= O:
            _budget_warning("observation", "O", O)
            break
        if tgt.id not in slot or anchor.id not in slot:
            continue
        ls = lm_slot.get(track.id)
        if ls is None:
            if not fixed_depth or len(lm_slot) >= L:
                if not fixed_depth:
                    continue
                _budget_warning("landmark", "L", L)
                break
            ls = len(lm_slot)
            lm_slot[track.id] = ls
            invd[ls] = max(track.inv_depth, 1e-6)
            opt_lm[ls] = False  # fixed-depth prior flavor
        kt = track.obs.get(tgt.id)
        ka = track.obs.get(anchor.id)
        if kt is None or ka is None:
            continue
        o_tgt[oi] = slot[tgt.id]
        o_ref[oi] = slot[anchor.id]
        o_lm[oi] = ls
        o_zr[oi] = anchor.bearings[ka]
        o_zt[oi] = tgt.bearings[kt]
        o_val[oi] = True
        oi += 1

    # imu factors: preintegrated on the host (f64), keyframe chains padded at
    # the keyframe-chain cap
    fi_i = np.zeros(Fi, np.int32)
    fi_j = np.zeros(Fi, np.int32)
    fi_val = np.zeros(Fi, bool)
    imu_entries = [e for e in spec.imu if e[0].id in slot and e[1].id in slot][:Fi]
    cap = caps.IMU_KF if any(e[5] for e in imu_entries) else caps.IMU
    fi_dts = np.zeros((Fi, cap))
    fi_ws = np.zeros((Fi, cap, 3))
    fi_accs = np.zeros((Fi, cap, 3))
    bg0 = np.zeros((Fi, 3))
    ba0 = np.zeros((Fi, 3))
    for k, e in enumerate(imu_entries):
        fi_i[k] = slot[e[0].id]
        fi_j[k] = slot[e[1].id]
        fi_val[k] = True
        bg0[k] = e[3]
        ba0[k] = e[4]
        fi_dts[k], fi_ws[k], fi_accs[k] = pad_imu(e[2], cap)
    fi_delta = pre_np.integrate_full_batch(
        fi_dts, fi_ws, fi_accs, bg0, ba0,
        calib.cov_w_h, calib.cov_a_h, calib.cov_bg_h, calib.cov_ba_h,
    )

    # fixed-anchor reprojection priors
    Pcap = caps.P
    pp_tgt = np.zeros(Pcap, np.int32)
    pp_qref = np.tile([1.0, 0, 0, 0], (Pcap, 1))
    pp_pref = np.zeros((Pcap, 3))
    pp_invd = np.ones(Pcap)
    pp_zr = np.tile([0.0, 0, 1.0], (Pcap, 1))
    pp_zt = np.tile([0.0, 0, 1.0], (Pcap, 1))
    pp_val = np.zeros(Pcap, bool)
    pi_ = 0
    for tgt, anchor, track in spec.reproj_prior:
        if pi_ >= Pcap:
            _budget_warning("reprojection-prior", "P", Pcap)
            break
        if tgt.id not in slot:
            continue
        kt = track.obs.get(tgt.id)
        ka = track.obs.get(anchor.id)
        if kt is None or ka is None or track.inv_depth <= 0:
            continue
        pp_tgt[pi_] = slot[tgt.id]
        pp_qref[pi_] = anchor.q
        pp_pref[pi_] = anchor.p
        pp_invd[pi_] = track.inv_depth
        pp_zr[pi_] = anchor.bearings[ka]
        pp_zt[pi_] = tgt.bearings[kt]
        pp_val[pi_] = True
        pi_ += 1

    # fixed-i imu priors (host-preintegrated)
    Fp = caps.Fp
    ip_j = np.zeros(Fp, np.int32)
    ip_qi = np.tile([1.0, 0, 0, 0], (Fp, 1))
    ip_pi = np.zeros((Fp, 3))
    ip_vi = np.zeros((Fp, 3))
    ip_bgi = np.zeros((Fp, 3))
    ip_bai = np.zeros((Fp, 3))
    ip_val = np.zeros(Fp, bool)
    ip_dts = np.zeros((Fp, caps.IMU))
    ip_ws = np.zeros((Fp, caps.IMU, 3))
    ip_accs = np.zeros((Fp, caps.IMU, 3))
    ip_entries = [e for e in spec.imu_prior if e[1].id in slot][:Fp]
    for k, (fi_frame, fj_frame, imu_data) in enumerate(ip_entries):
        ip_j[k] = slot[fj_frame.id]
        ip_qi[k] = fi_frame.q
        ip_pi[k] = fi_frame.p
        ip_vi[k] = fi_frame.v
        ip_bgi[k] = fi_frame.bg
        ip_bai[k] = fi_frame.ba
        ip_val[k] = True
        ip_dts[k], ip_ws[k], ip_accs[k] = pad_imu(imu_data, caps.IMU)
    ip_delta = pre_np.integrate_full_batch(
        ip_dts, ip_ws, ip_accs, ip_bgi, ip_bai,
        calib.cov_w_h, calib.cov_a_h, calib.cov_bg_h, calib.cov_ba_h,
    )

    # rotation priors
    r_tgt = np.zeros(R, np.int32)
    r_qref = np.tile([1.0, 0, 0, 0], (R, 1))
    r_zr = np.tile([0.0, 0, 1.0], (R, 1))
    r_zt = np.tile([0.0, 0, 1.0], (R, 1))
    r_val = np.zeros(R, bool)
    ri = 0
    for tgt, anchor, track in spec.rot:
        if ri >= R or tgt.id not in slot:
            continue
        kt = track.obs.get(tgt.id)
        ka = track.obs.get(anchor.id)
        if kt is None or ka is None:
            continue
        r_tgt[ri] = slot[tgt.id]
        r_qref[ri] = anchor.q
        r_zr[ri] = anchor.bearings[ka]
        r_zt[ri] = tgt.bearings[kt]
        r_val[ri] = True
        ri += 1

    pa = ProblemArrays(
        q=q, p=p, v=v, bg=bg, ba=ba_,
        opt_pose=opt_pose, opt_motion=opt_motion,
        invd=invd, opt_lm=opt_lm,
        o_tgt=o_tgt, o_ref=o_ref, o_lm=o_lm, o_zr=o_zr, o_zt=o_zt, o_val=o_val,
        fi_i=fi_i, fi_j=fi_j, fi_val=fi_val, fi_bg0=bg0, fi_ba0=ba0,
        fi_delta=fi_delta,
        pp_tgt=pp_tgt, pp_qref=pp_qref, pp_pref=pp_pref, pp_invd=pp_invd,
        pp_zr=pp_zr, pp_zt=pp_zt, pp_val=pp_val,
        ip_j=ip_j, ip_qi=ip_qi, ip_pi=ip_pi, ip_vi=ip_vi, ip_bgi=ip_bgi,
        ip_bai=ip_bai, ip_val=ip_val, ip_delta=ip_delta,
        r_tgt=r_tgt, r_qref=r_qref, r_zr=r_zr, r_zt=r_zt, r_val=r_val,
    )
    return pa, lm_slot


def _cast_pa(pa: ProblemArrays, dtype):
    """ProblemArrays' floats cast on the host (NumPy) to the solve dtype
    (None or f64: unchanged)."""
    if dtype is None or np.dtype(dtype) == np.float64:
        return pa
    npdt = np.dtype(dtype)

    def cast(a):
        if isinstance(a, dict):
            return {k: cast(v) for k, v in a.items()}
        return a.astype(npdt) if np.issubdtype(a.dtype, np.floating) else a

    return ProblemArrays(*(cast(a) for a in pa))


def _finalize_problem(pa: ProblemArrays, calib: CalibTree, prior, prior_valid: bool):
    """ProblemArrays -> (states, inv_depth, BAProblem) on the calibration's
    device: the uploads (pinned, non-blocking) and the NamedTuple packing.
    The solve dtype is pa's float dtype (cast on the host by the callers)."""
    dev = _dev_of(calib)
    d = _up(pa, dev)
    dtype = d.q.dtype
    eye = torch.eye(15, dtype=dtype, device=dev)

    def unpack_delta(dd, val):
        delta = pre.PreintDelta(**{k: dd[k] for k in pre.PreintDelta._fields})
        sic = torch.where(val[:, None, None], dd["sqrt_inv_cov"], eye[None])
        return delta, sic

    deltas, sics = unpack_delta(d.fi_delta, d.fi_val)
    ip_deltas, ip_sics = unpack_delta(d.ip_delta, d.ip_val)
    states = FrameStates(q=d.q, p=d.p, v=d.v, bg=d.bg, ba=d.ba)
    reproj = F.ReprojFactors(tgt=d.o_tgt, ref=d.o_ref, lm=d.o_lm, z_ref=d.o_zr,
                             z_tgt=d.o_zt, valid=d.o_val)
    imu = F.ImuFactors(i=d.fi_i, j=d.fi_j, delta=deltas, sqrt_inv_cov=sics,
                       bg0=d.fi_bg0, ba0=d.fi_ba0, valid=d.fi_val)
    reproj_prior = F.ReprojPriorFactors(
        tgt=d.pp_tgt, q_ref=d.pp_qref, p_ref=d.pp_pref, inv_depth=d.pp_invd,
        z_ref=d.pp_zr, z_tgt=d.pp_zt, valid=d.pp_val)
    imu_prior = F.ImuPriorFactors(
        j=d.ip_j, q_i=d.ip_qi, p_i=d.ip_pi, v_i=d.ip_vi, bg_i=d.ip_bgi,
        ba_i=d.ip_bai, delta=ip_deltas, sqrt_inv_cov=ip_sics, valid=d.ip_val)
    rot = F.RotFactors(tgt=d.r_tgt, q_ref=d.r_qref, z_ref=d.r_zr, z_tgt=d.r_zt,
                       valid=d.r_val)
    if prior is None:
        W = pa.q.shape[0]
        prior = F.initial_prior(W, states, gauge=0.0, dtype=dtype)
        prior_valid = False
    prior = cast_floats(prior, dtype)
    pb = ba.BAProblem(
        reproj=reproj, reproj_prior=reproj_prior, imu=imu, imu_prior=imu_prior,
        rot=rot, prior=prior,
        prior_valid=torch.full((), bool(prior_valid), device=dev),
        ext=cast_floats(calib.ext, dtype), sqrt_inv_cov2=calib.sqrt_inv_cov2.to(dtype),
        opt_pose=d.opt_pose, opt_motion=d.opt_motion, opt_lm=d.opt_lm,
    )
    return states, d.invd, pb


def build_problem(spec: BASpec, calib: CalibArrays, caps: Caps, dtype=None):
    """Returns (states, inv_depth, BAProblem, lm_slot_by_track_id) on the
    calibration's device; `dtype` is the solve's float dtype (None: f64)."""
    pa, lm_slot = _assemble(spec, caps, calib)
    pa = _cast_pa(pa, dtype)
    states, invd, pb = _finalize_problem(pa, calib.tree, spec.prior,
                                         spec.prior is not None)
    return states, invd, pb, lm_slot


# ---------------------------------------------------------------------------
# the per-frame solves
# ---------------------------------------------------------------------------


def solve_noprior(pa, calib: CalibTree, max_iterations):
    states, invd, pb = _finalize_problem(pa, calib, None, False)
    return ba.solve_ba(states, invd, pb, max_iterations=max_iterations)


def solve_prior(pa, calib: CalibTree, prior, max_iterations):
    states, invd, pb = _finalize_problem(pa, calib, prior, True)
    return ba.solve_ba(states, invd, pb, max_iterations=max_iterations)


def solve_spec(spec: BASpec, calib: CalibArrays, caps: Caps, dtype=None,
               max_iterations: int = 10):
    """Assemble + solve. Returns (device-resident BAResult, lm_slot)."""
    pa, lm_slot = _assemble(spec, caps, calib)
    pa = _cast_pa(pa, dtype)
    if spec.prior is None:
        res = _count("solve_noprior", solve_noprior, pa, calib.tree, max_iterations)
    else:
        res = _count("solve_prior", solve_prior, pa, calib.tree, spec.prior,
                     max_iterations)
    return res, lm_slot


def _rows_where(mask, new, old):
    """old with its leading-axis rows replaced by `new` where `mask`."""
    return torch.where(mask.reshape((-1,) + (1,) * (old.ndim - 1)), new, old)


def _override_prev_states(s, prev: FrameStates, prev_map):
    """Seed initial frame states from a device-resident previous solve:
    slot i takes prev[prev_map[i]] when prev_map[i] >= 0, else keeps the
    host-assembled value."""
    use = prev_map >= 0
    idx = torch.clamp(prev_map, min=0).long()
    dt = s.q.dtype
    return FrameStates(*(_rows_where(use, a_prev[idx].to(dt), a_host)
                         for a_prev, a_host in zip(prev, s)))


def _set_slot(s: FrameStates, j, src: FrameStates) -> FrameStates:
    """s with slot j set to src's slot 0; j is an int or a 0-d tensor (one
    per row under vmap), and a negative j leaves s as it is."""
    mask = torch.arange(s.q.shape[0], device=s.q.device) == j
    return FrameStates(*(_rows_where(mask, b[0].to(a.dtype)[None], a)
                         for a, b in zip(s, src)))


def _slot(i, device) -> torch.Tensor:
    """A slot index as a 0-d tensor on `device`: an int is filled there (a
    kernel, no copy from the host), a tensor (a row's, under vmap) passes."""
    if isinstance(i, torch.Tensor):
        return i
    return torch.full((), int(i), dtype=torch.int64, device=device)


def _per_row(rows: bool):
    """(lift, solve) of a program body: for one problem the stage functions
    themselves and `ba.solve_ba`; for a batch with a leading row axis
    (rows=True, the lockstep runtime) `vmap` of each stage and
    `ba.solve_ba_rows`. The LM loop cannot run under vmap (it reads its
    stop flag on the host), so a program is its stages around its solves."""
    if rows:
        return vmap, ba.solve_ba_rows
    return (lambda fn: fn), ba.solve_ba


def _chain_localize_head(pa_loc, prev, loc_ip_prev, calib):
    """Localize-problem head with device-resident chaining: override the
    preintegration-prior anchor (slot loc_ip_prev of `prev`) and predict the
    new frame's initial state from it on the device (mirrors
    ops/preintegration_np.predict_mean = reference preintegrator.cpp:102-112).
    loc_ip_prev is an int or a 0-d tensor (a row's, under vmap); a negative
    one leaves the host-assembled problem as it is (selected by torch.where,
    so one batch holds rows of both kinds).

    The prior anchor's bg_i/ba_i stay at the host-assembled values: they are
    also the delta's bias linearization point."""
    s_loc, invd_loc, pb_loc = _finalize_problem(pa_loc, calib, None, False)
    dt_ = s_loc.q.dtype
    ip = pb_loc.imu_prior
    lip = _slot(loc_ip_prev, ip.q_i.device)
    use = lip >= 0
    idx = torch.clamp(lip, min=0)
    row0 = (torch.arange(ip.q_i.shape[0], device=ip.q_i.device) == 0) & use

    def over(a_ip, a_prev):
        return _rows_where(row0, a_prev[idx].to(dt_)[None], a_ip)

    ip = ip._replace(q_i=over(ip.q_i, prev.q), p_i=over(ip.p_i, prev.p),
                     v_i=over(ip.v_i, prev.v))
    pb_loc = pb_loc._replace(imu_prior=ip)

    t_d = ip.delta.t[0]
    q_i, p_i, v_i = ip.q_i[0], ip.p_i[0], ip.v_i[0]
    g = pre.gravity_like(p_i)
    v_pred = v_i + g * t_d + quat_rotate(q_i, ip.delta.v[0])
    p_pred = p_i + 0.5 * g * t_d * t_d + v_i * t_d + quat_rotate(q_i, ip.delta.p[0])
    q_pred = quat_normalize(quat_mul(q_i, ip.delta.q[0]))
    pred = FrameStates(q=q_pred[None], p=p_pred[None], v=v_pred[None],
                       bg=ip.bg_i[:1], ba=ip.ba_i[:1])
    return _set_slot(s_loc, torch.where(use, 0, -1), pred), invd_loc, pb_loc


def _subwindow_head(pa_sub, prev, sub_prev, j_slot, loc_states, calib):
    """Subwindow-problem head: initial states from the device-resident
    previous solve (`sub_prev`, -1: the host's), slot j_slot from the
    localize solve."""
    s_sub, invd_sub, pb_sub = _finalize_problem(pa_sub, calib, None, False)
    s_sub = _override_prev_states(s_sub, prev, sub_prev)
    return _set_slot(s_sub, j_slot, loc_states), invd_sub, pb_sub


def fused_localize_subwindow_chain(pa_loc, pa_sub, j_slot, prev, loc_ip_prev,
                                   sub_prev, calib, max_iterations, rows=False):
    """Per-frame localize + subwindow solve with device-resident state
    chaining: `prev` is the previous subwindow solve's FrameStates on the
    device, `loc_ip_prev` the slot of it that anchors the localize problem's
    preintegration prior (-1: none), `sub_prev` (W,) seeds the subwindow's
    initial states.

    rows=True runs N such problems at once (the lockstep runtime's batched
    program, the JAX dispatcher's `_batched_sub_jit`): every argument but
    `calib` and `max_iterations` has a leading row axis, the problem arrays
    are tensors, and j_slot / loc_ip_prev are (N,) tensors."""
    lift, solve = _per_row(rows)
    s_loc, invd_loc, pb_loc = lift(
        lambda pl, pv, lip: _chain_localize_head(pl, pv, lip, calib))(
            pa_loc, prev, loc_ip_prev)
    res_loc = solve(s_loc, invd_loc, pb_loc, max_iterations=max_iterations)
    s_sub, invd_sub, pb_sub = lift(
        lambda ps, pv, sp, j, st: _subwindow_head(ps, pv, sp, j, st, calib))(
            pa_sub, prev, sub_prev, j_slot, res_loc.states)
    return solve(s_sub, invd_sub, pb_sub, max_iterations=max_iterations)


def fused_localize_subwindow(pa_loc, pa_sub, j_slot, calib, max_iterations):
    """Per-frame localize solve chained into the subwindow refinement
    (reference track() :101-125 then :349-444 for the subframe case)."""
    s_loc, invd_loc, pb_loc = _finalize_problem(pa_loc, calib, None, False)
    res_loc = ba.solve_ba(s_loc, invd_loc, pb_loc, max_iterations=max_iterations)
    s_sub, invd_sub, pb_sub = _finalize_problem(pa_sub, calib, None, False)
    s_sub = _set_slot(s_sub, j_slot, res_loc.states)
    return ba.solve_ba(s_sub, invd_sub, pb_sub, max_iterations=max_iterations)


def solve_localize_subwindow(
    spec_loc: BASpec, spec_sub: BASpec, j_slot: int, calib: CalibArrays,
    caps: Caps, dtype=None, max_iterations: int = 10,
    prev_states: Optional[FrameStates] = None, loc_ip_prev: int = -1,
    sub_prev: Optional[np.ndarray] = None,
):
    """Fused per-frame solve for the subframe path, with no blocking fetch.
    With prev_states (the previous subwindow solve's states on the device)
    the localization prior's i-anchor and the subwindow's initial states
    chain device to device. Returns (BAResult of the subwindow solve,
    lm_slot of the subwindow problem)."""
    with _T.time("bld.sub.assemble"):
        pa_loc, _ = _assemble(spec_loc, caps, calib)
        pa_sub, lm_slot = _assemble(spec_sub, caps, calib)
        pa_loc = _cast_pa(pa_loc, dtype)
        pa_sub = _cast_pa(pa_sub, dtype)
    if prev_states is not None:
        if sub_prev is None:
            sub_prev = np.full(caps.W, -1, np.int32)
        res = _count("fused_localize_subwindow_chain", fused_localize_subwindow_chain,
                     pa_loc, pa_sub, j_slot, prev_states, int(loc_ip_prev),
                     to_device(np.asarray(sub_prev, np.int32), _dev_of(calib.tree)),
                     calib.tree, max_iterations)
    else:
        res = _count("fused_localize_subwindow", fused_localize_subwindow,
                     pa_loc, pa_sub, j_slot, calib.tree, max_iterations)
    return res, lm_slot


def marginalize(pa, calib: CalibTree, prior):
    states, invd, pb = _finalize_problem(pa, calib, prior, True)
    return marginalization.marginalize_frame0(states, invd, pb)


def marginalize_spec(spec: BASpec, calib: CalibArrays, caps: Caps) -> F.PriorFactor:
    """Assemble + marginalize slot 0; the new prior stays on the device."""
    pa, _ = _assemble(spec, caps, calib)
    return _count("marginalize", marginalize, pa, calib.tree, spec.prior)


# ---------------------------------------------------------------------------
# fused keyframe tail: window solve + landmark validation + marginalization
# ---------------------------------------------------------------------------


def _k_of_row_map(st, frame: Frame) -> np.ndarray:
    """Store-row -> keypoint-index reverse map of one frame (-1 elsewhere)."""
    k_of_row = np.full(st.cap, -1, np.int64)
    rows = st.rows_of(frame.track_ids)
    v = rows >= 0
    k_of_row[rows[v]] = np.flatnonzero(v)
    return k_of_row


def _dict_to_row_map(st, d: Optional[Dict[int, int]], fill=-1) -> np.ndarray:
    """tid->value dict -> store-row-indexed vector (vectorized gather)."""
    out = np.full(st.cap, fill, np.int64)
    if d:
        tids = np.fromiter(d.keys(), np.int64, len(d))
        vals = np.fromiter(d.values(), np.int64, len(d))
        rows = st.rows_of(tids)
        ok = rows >= 0
        out[rows[ok]] = vals[ok]
    return out


def _assemble_validation(
    tracks: List[Track], frames_by_id: Dict[int, Frame],
    wslot: Dict[int, int], lm_slot_w: Dict[int, int], calib: CalibArrays,
    Lv: int, Ov: int, tri_idx_of_tid: Optional[Dict[int, int]] = None,
):
    """NumPy arrays for on-device landmark validation (reference
    refine_window post-solve validation, sliding_window_tracker.cpp:304-336):
    per track the anchor camera pose (a window slot when the anchor is a
    window keyframe, resolved against the solved states on the device, else
    host constants), and per keyframe observation the observing window slot
    and bearing. Vectorized over the SoA TrackStore, frame-major (the order
    differs from a track-major loop; validation sums per track and does not
    depend on it).

    tri_idx_of_tid maps track id -> row of the in-program triangulation
    batch: those tracks take their inverse depth from the triangulation and
    are gated on its success.

    The JAX package sends an empty track list to a track-major twin; here
    the empty case returns the same arrays directly."""
    n = min(len(tracks), Lv)
    a_slot = np.full(Lv, -1, np.int32)
    a_qc = np.tile([1.0, 0, 0, 0], (Lv, 1))
    a_pc = np.zeros((Lv, 3))
    z0 = np.tile([0.0, 0, 1.0], (Lv, 1))
    lmw = np.full(Lv, -1, np.int32)
    tri_idx = np.full(Lv, -1, np.int32)
    invd_h = np.ones(Lv)
    has = np.zeros(Lv, bool)
    o_ti = np.zeros(Ov, np.int32)
    o_slot = np.zeros(Ov, np.int32)
    o_z = np.tile([0.0, 0, 1.0], (Ov, 1))
    o_val = np.zeros(Ov, bool)
    trunc = np.zeros(Lv, bool)
    Km = calib.K
    out = {
        "a_slot": a_slot, "a_qc": a_qc, "a_pc": a_pc, "z0": z0,
        "lmw": lmw, "tri_idx": tri_idx, "invd_h": invd_h, "has": has,
        "o_ti": o_ti, "o_slot": o_slot, "o_z": o_z, "o_val": o_val,
        "trunc": trunc, "fxy": np.array([Km[0, 0], Km[1, 1]]),
    }
    if not tracks:
        return out
    if len(tracks) > Lv:
        logging.getLogger(__name__).warning(
            "validation capacity exceeded: %d tracks > Lv=%d; overflow "
            "tracks fail validation closed", len(tracks), Lv,
        )
    st = tracks[0].store
    rows = np.fromiter((t.row for t in tracks[:n]), np.int64, n)
    aids = st.first_fid[rows]
    fid_arr = np.fromiter(frames_by_id, np.int64, len(frames_by_id))
    has[:n] = np.isin(aids, fid_arr)

    # anchor slot (window keyframes resolve on-device against solved states)
    wk = np.fromiter(wslot.keys(), np.int64, len(wslot))
    wv = np.fromiter(wslot.values(), np.int64, len(wslot))
    srt = np.argsort(wk)
    wk, wv = wk[srt], wv[srt]
    if len(wk):
        pos = np.clip(np.searchsorted(wk, aids), 0, len(wk) - 1)
        in_w = (wk[pos] == aids) & has[:n]
        a_slot[:n] = np.where(in_w, wv[pos], -1)

    # anchor bearings + host camera poses for non-window anchors, gathered
    # once per distinct anchor frame
    q_bc, p_bc = calib.q_bc_h, calib.p_bc_h
    for aid in np.unique(aids[has[:n]]):
        f = frames_by_id[int(aid)]
        k_of_row = _k_of_row_map(st, f)
        sel = np.flatnonzero((aids == aid) & has[:n])
        ks = k_of_row[rows[sel]]
        ok = ks >= 0
        z0[sel[ok]] = f.bearings[ks[ok]]
        has[sel[~ok]] = False  # anchor link lost: fail closed
        if int(aid) not in wslot:
            qc, pc = f.get_pose(q_bc, p_bc)
            a_qc[sel] = qc
            a_pc[sel] = pc

    # per-track scalars only for tracks whose anchor survives (`has`)
    hv = has[:n]
    lmw_rows = _dict_to_row_map(st, lm_slot_w)
    lmw[:n] = np.where(hv, lmw_rows[rows], -1)
    if tri_idx_of_tid is not None:
        tri_rows = _dict_to_row_map(st, tri_idx_of_tid)
        tri_idx[:n] = np.where(hv, tri_rows[rows], -1)
    invd_h[:n] = np.where(hv, st.inv_depth[rows], 1.0)

    # observations, frame-major: per window frame, which validation tracks
    # does it observe
    vti_of_row = np.full(st.cap, -1, np.int64)
    vti_of_row[rows[hv]] = np.flatnonzero(hv)
    o_ti_parts, o_slot_parts, o_z_parts = [], [], []
    for fid, ws in wslot.items():
        f = frames_by_id.get(fid)
        if f is None:
            continue
        rows_f = st.rows_of(f.track_ids)
        r = np.clip(rows_f, 0, None)
        msk = (rows_f >= 0) & (vti_of_row[r] >= 0)
        ks = np.flatnonzero(msk)
        if len(ks) == 0:
            continue
        o_ti_parts.append(vti_of_row[rows_f[ks]])
        o_slot_parts.append(np.full(len(ks), ws, np.int64))
        o_z_parts.append(f.bearings[ks])
    if o_ti_parts:
        ti_all = np.concatenate(o_ti_parts)
        slot_all = np.concatenate(o_slot_parts)
        z_all = np.concatenate(o_z_parts)
        no = len(ti_all)
        if no > Ov:
            logging.getLogger(__name__).warning(
                "validation observation budget exhausted (Ov=%d); "
                "truncated tracks fail validation closed", Ov,
            )
            trunc[ti_all[Ov:]] = True
            no = Ov
        o_ti[:no] = ti_all[:no]
        o_slot[:no] = slot_all[:no]
        o_z[:no] = z_all[:no]
        o_val[:no] = True
    return out


def _validate_tracks_device(va, s64: FrameStates, invd64, ext: F.Extrinsics,
                            tri_invd=None, tri_ok=None):
    """Vectorized landmark validation at the solved states: depth in
    (1e-3, 50] at every keyframe observation and mean pixel reprojection
    error < 3 px (reference :304-336). `va` is _assemble_validation's dict
    on the device. tri_invd/tri_ok: tracks triangulated in-program take
    their depth from tri_invd and are gated on tri_ok."""
    a_slot = va["a_slot"]
    use_w = a_slot >= 0
    idx = torch.clamp(a_slot, min=0).long()
    qb = s64.q[idx]
    pb_ = s64.p[idx]
    qc = torch.where(use_w[:, None], quat_mul(qb, ext.q_bc.expand_as(qb)), va["a_qc"])
    pc = torch.where(use_w[:, None], pb_ + quat_rotate(qb, ext.p_bc.expand_as(pb_)),
                     va["a_pc"])
    lmw = va["lmw"]
    invd = torch.where(lmw >= 0, invd64[torch.clamp(lmw, min=0).long()], va["invd_h"])
    ti = va["tri_idx"]
    ti_c = torch.clamp(ti, min=0).long()
    if tri_invd is not None:
        invd = torch.where((ti >= 0) & (lmw < 0), tri_invd[ti_c], invd)
    x = quat_rotate(qc, va["z0"] / torch.clamp(invd, min=1e-12)[:, None]) + pc

    o_slot = va["o_slot"].long()
    o_ti = va["o_ti"].long()
    qob = s64.q[o_slot]
    pob = s64.p[o_slot]
    qoc = quat_mul(qob, ext.q_bc.expand_as(qob))
    poc = pob + quat_rotate(qob, ext.p_bc.expand_as(pob))
    y = quat_rotate(quat_conj(qoc), x[o_ti] - poc)
    depth_bad = ~((y[:, 2] > 1e-3) & (y[:, 2] <= 50.0))
    ys = y[:, :2] / torch.clamp(y[:, 2:], min=1e-12)
    o_z = va["o_z"]
    zs = o_z[:, :2] / o_z[:, 2:]
    rpe = torch.linalg.vector_norm((ys - zs) * va["fxy"][None], dim=-1)
    ov = va["o_val"]
    Lv = a_slot.shape[0]
    f64 = invd.dtype
    sum_rpe = ba.segment_sum(torch.where(ov, rpe, 0.0), o_ti, Lv)
    cnt = ba.segment_sum(ov.to(f64), o_ti, Lv)
    nbad = ba.segment_sum((ov & depth_bad).to(f64), o_ti, Lv)
    mean_rpe = sum_rpe / torch.clamp(cnt, min=1.0)
    out = (va["has"] & ~va["trunc"] & (invd > 0) & (nbad == 0) & (mean_rpe < 3.0))
    if tri_ok is not None:
        out = out & ((ti < 0) | tri_ok[ti_c])
    return out


def _states64(s: FrameStates) -> FrameStates:
    return FrameStates(*(_f64(a) for a in s))


def fused_window_tail(pa_w, prior, va, calib, max_iterations):
    """Window VI-BA solve -> landmark validation on the device (reference
    keyframe tail refine_window :226-337 -> validation :304-336); the solve
    may run at reduced precision, validation runs in f64 on the cast-up
    result. The slot-0 marginalization is `marginalize_tail`."""
    s, invd, pb = _finalize_problem(pa_w, calib, prior, True)
    res = ba.solve_ba(s, invd, pb, max_iterations=max_iterations)
    valid_out = _validate_tracks_device(va, _states64(res.states), _f64(res.inv_depth),
                                        calib.ext)
    return res, valid_out


def marginalize_tail(s_res, invd_res, valid_out, tri_invd, tri_ok,
                     pa_m, mlm_vti, mlm_from_w, mlm_tri, prior, calib):
    """Slot-0 marginalization on the solved window states (reference
    slide_window/marginalize :339-347), chained device to device after the
    window solve; the resulting prior stays on the device for the next
    keyframe solve."""
    s64 = _states64(s_res)
    invd64 = _f64(invd_res)
    s_m, invd_m, pb_m = _finalize_problem(pa_m, calib, prior, True)
    from_w = mlm_from_w >= 0
    invd_m = torch.where(from_w, invd64[torch.clamp(mlm_from_w, min=0).long()], invd_m)
    from_t = (mlm_tri >= 0) & ~from_w
    invd_m = torch.where(from_t, _f64(tri_invd[torch.clamp(mlm_tri, min=0).long()]), invd_m)
    lm_ok = (mlm_vti >= 0) & valid_out[torch.clamp(mlm_vti, min=0).long()] & (invd_m > 0)
    rp = pb_m.reproj
    pb_m = pb_m._replace(reproj=rp._replace(valid=rp.valid & lm_ok[rp.lm.long()]))
    return marginalization.marginalize_frame0(s64, invd_m, pb_m)


def triangulate_batch(bearings, q_cw, p_cw, mask):
    """Batched N-view DLT: one point per row (f64; one host sync on CUDA,
    its batched eigh)."""
    return vmap(tri.triangulate_homogeneous)(bearings, q_cw, p_cw, mask)


def _solved_view_poses(res_states, calib, qcw, pcw, us):
    """The views flagged `us` take the camera pose of the solved frame
    (slot 0 of res_states), in f64."""
    q0 = _f64(res_states.q[0])
    p0 = _f64(res_states.p[0])
    qc0 = quat_mul(q0, calib.ext.q_bc)
    pc0 = p0 + quat_rotate(q0, calib.ext.p_bc)
    qcw_j = quat_conj(qc0)
    pcw_j = -quat_rotate(qcw_j, pc0)
    sel = us[..., None] > 0
    return torch.where(sel, qcw_j, qcw), torch.where(sel, pcw_j, pcw)


def _keyframe_window_head(loc_states, b, qcw, pcw, m_tri, us, tri_aqc, tri_apc,
                         pa_w, j_w, wlm_tri, prior, calib):
    """Steps 2-3 of `fused_keyframe` before the window solve: triangulation
    with the solved frame's views, then the window problem with the new
    frame's state (slot j_w; negative: none) and fresh depths chained in."""
    # --- 2. triangulate pending tracks (f64), solved-frame views chained --
    qcw, pcw = _solved_view_poses(loc_states, calib, qcw, pcw, us)
    pts, tri_ok = triangulate_batch(b, qcw, pcw, m_tri)
    # inverse depth along the anchor bearing (reference track.cpp:90-101)
    y_a = quat_rotate(quat_conj(tri_aqc), pts - tri_apc)
    tri_invd = 1.0 / torch.clamp(torch.linalg.vector_norm(y_a, dim=-1), min=1e-9)
    tri_ok = tri_ok & torch.isfinite(tri_invd)

    # --- 3. window problem with chained state + fresh depths -------------
    s_w, invd_w, pb_w = _finalize_problem(pa_w, calib, prior, True)
    s_w = _set_slot(s_w, j_w, loc_states)
    has_tri = wlm_tri >= 0
    wt = torch.clamp(wlm_tri, min=0).long()
    invd_w = torch.where(has_tri, tri_invd[wt].to(invd_w.dtype), invd_w)
    lm_gate = (~has_tri) | tri_ok[wt]
    rp_w = pb_w.reproj
    pb_w = pb_w._replace(
        opt_lm=pb_w.opt_lm & lm_gate,
        reproj=rp_w._replace(valid=rp_w.valid & lm_gate[rp_w.lm.long()]),
    )
    return s_w, invd_w, pb_w, tri_ok, tri_invd


def fused_keyframe(
    pa_loc, b, qcw, pcw, m_tri, us, tri_aqc, tri_apc,
    pa_w, j_w, wlm_tri, prior, va, calib, max_iterations, rows=False,
    prev=None, loc_ip_prev=None,
):
    """The sliding-keyframe step (reference track() keyframe branch
    :80-99): localization solve -> triangulation of pending tracks ->
    window VI-BA (new-frame state and fresh inverse depths chained in,
    factors of failed triangulations gated off) -> landmark validation. The
    slot-0 marginalization is the separate `marginalize_tail`.

    j_w is an int or a tensor; negative: the solved frame is not in the
    window. rows=True runs N steps at once (the lockstep runtime's batched
    program, the JAX dispatcher's `_batched_kf_jit`): every argument but
    `calib` and `max_iterations` has a leading row axis and is a tensor.

    With `prev` (the previous subwindow solve's FrameStates on the device)
    and `loc_ip_prev` (the slot of it that anchors the localize problem's
    preintegration prior, -1: none), the anchor chains device to device
    (`_chain_localize_head`, as the subframe chain does), so the step needs
    no exact host mirror when it is dispatched (the async keyframe step, the
    JAX package's `_fused_keyframe_chain_jit`)."""
    lift, solve = _per_row(rows)
    # --- 1. localize the new frame -------------------------------------
    if prev is None:
        s_loc, invd_loc, pb_loc = lift(
            lambda pl: _finalize_problem(pl, calib, None, False))(pa_loc)
    else:
        s_loc, invd_loc, pb_loc = lift(
            lambda pl, pv, lip: _chain_localize_head(pl, pv, lip, calib))(
                pa_loc, prev, loc_ip_prev)
    res_loc = solve(s_loc, invd_loc, pb_loc, max_iterations=max_iterations)

    # --- 2-3. triangulation, window solve --------------------------------
    s_w, invd_w, pb_w, tri_ok, tri_invd = lift(
        lambda *a: _keyframe_window_head(*a, calib))(
            res_loc.states, b, qcw, pcw, m_tri, us, tri_aqc, tri_apc, pa_w, j_w,
            wlm_tri, prior)
    res = solve(s_w, invd_w, pb_w, max_iterations=max_iterations)

    # --- 4. validation (tri-aware) ---------------------------------------
    valid_out = lift(lambda st, iv, v, ti, tk: _validate_tracks_device(
        v, _states64(st), _f64(iv), calib.ext, tri_invd=ti, tri_ok=tk))(
            res.states, res.inv_depth, va, tri_invd, tri_ok)
    return res, res_loc, valid_out, tri_ok, tri_invd


def assemble_keyframe_fused(
    spec_loc: BASpec, pending: List[Track], spec_w: BASpec,
    tracks_v: List[Track], spec_m: BASpec,
    frames_by_id: Dict[int, Frame], calib: CalibArrays, caps: Caps,
    caps_loc: Optional[Caps] = None, dtype=None, loc_dtype=None,
):
    """Host-side (NumPy) assembly of the fully fused keyframe step: every
    array `fused_keyframe` + `marginalize_tail` consume, as a flat dict.
    Returns (arrays_dict, lm_w)."""
    Lv = 2 * caps.L
    Ov = caps.O
    solved_fid = spec_loc.frames[0].id
    wslot = {f.id: i for i, f in enumerate(spec_w.frames)}
    with _T.time("bld.kf.assemble"):
        pa_loc, _ = _assemble(spec_loc, caps_loc or caps, calib)
        pa_loc = _cast_pa(pa_loc, loc_dtype or dtype)
        b, qcw, pcw, m_tri, us = assemble_triangulation(
            pending, frames_by_id, calib, caps, solved_frame_id=solved_fid
        )
        # per-pending anchor CAMERA pose at triangulation time (host poses
        # before the window solve)
        n_cap = b.shape[0]
        tri_aqc = np.tile([1.0, 0, 0, 0], (n_cap, 1))
        tri_apc = np.zeros((n_cap, 3))
        q_bc, p_bc = calib.q_bc_h, calib.p_bc_h
        for i, t in enumerate(pending[:n_cap]):
            af = frames_by_id.get(t.first_frame_id())
            if af is not None:
                tri_aqc[i], tri_apc[i] = af.get_pose(q_bc, p_bc)
        tri_idx_of_tid = {t.id: i for i, t in enumerate(pending[:n_cap])}

        pa_w, lm_w = _assemble(spec_w, caps, calib)
        pa_w = _cast_pa(pa_w, dtype)
        wlm_tri = np.full(caps.L, -1, np.int32)
        for tid, s in lm_w.items():
            wlm_tri[s] = tri_idx_of_tid.get(tid, -1)
        j_w = wslot.get(solved_fid, -1)

        va = _assemble_validation(
            tracks_v, frames_by_id, wslot, lm_w, calib, Lv, Ov,
            tri_idx_of_tid=tri_idx_of_tid,
        )
        pa_m, lm_m = _assemble(spec_m, caps, calib)
        vti_of_tid = {t.id: i for i, t in enumerate(tracks_v[:Lv])}
        mlm_vti = np.full(caps.L, -1, np.int32)
        mlm_from_w = np.full(caps.L, -1, np.int32)
        mlm_tri = np.full(caps.L, -1, np.int32)
        for tid, s in lm_m.items():
            mlm_vti[s] = vti_of_tid.get(tid, -1)
            mlm_from_w[s] = lm_w.get(tid, -1)
            mlm_tri[s] = tri_idx_of_tid.get(tid, -1)
    arrays = dict(
        pa_loc=pa_loc, b=b, qcw=qcw, pcw=pcw, m_tri=m_tri, us=us,
        tri_aqc=tri_aqc, tri_apc=tri_apc, pa_w=pa_w,
        j_w=np.int32(j_w), wlm_tri=wlm_tri, va=va, pa_m=pa_m,
        mlm_vti=mlm_vti, mlm_from_w=mlm_from_w, mlm_tri=mlm_tri,
    )
    return arrays, lm_w


def run_keyframe_fused(a: dict, prior, calib: CalibTree, max_iterations: int,
                       prev=None, loc_ip_prev: int = -1, name: str = "fused_keyframe"):
    """The device half of `solve_keyframe_fused` on the arrays of
    `assemble_keyframe_fused` (uploaded here): `fused_keyframe` (its
    localize anchor chained from `prev` when given), counted under `name`,
    then `marginalize_tail`. Returns (res, res_loc, valid_out, tri_ok,
    tri_invd, new_prior)."""
    dev = _dev_of(calib)
    up = {k: _up(a[k], dev) for k in ("b", "qcw", "pcw", "m_tri", "us", "tri_aqc",
                                        "tri_apc", "wlm_tri", "va", "mlm_vti",
                                        "mlm_from_w", "mlm_tri")}
    chain = {} if prev is None else dict(prev=prev, loc_ip_prev=int(loc_ip_prev))
    res, res_loc, valid_out, tri_ok, tri_invd = _count(
        name, fused_keyframe,
        a["pa_loc"], up["b"], up["qcw"], up["pcw"], up["m_tri"], up["us"],
        up["tri_aqc"], up["tri_apc"], a["pa_w"], int(a["j_w"]), up["wlm_tri"],
        prior, up["va"], calib, max_iterations, **chain,
    )
    new_prior = _count(
        "marginalize_tail", marginalize_tail,
        res.states, res.inv_depth, valid_out, tri_invd, tri_ok, a["pa_m"],
        up["mlm_vti"], up["mlm_from_w"], up["mlm_tri"], prior, calib,
    )
    return res, res_loc, valid_out, tri_ok, tri_invd, new_prior


# while CAPTURE_KEYFRAME is set, the first solve_keyframe_fused call keeps
# its inputs (arrays, prior, calib tree, max_iterations, prev_states,
# loc_ip_prev) and its outputs (run_keyframe_fused's) here, for a caller
# that replays that keyframe step on another device; with CAPTURE_KEYFRAME
# == "chained", the first call that chains from prev_states (the async step)
CAPTURE_KEYFRAME = False
CAPTURED_KEYFRAME = None


def solve_keyframe_fused(
    spec_loc: BASpec, pending: List[Track], spec_w: BASpec,
    tracks_v: List[Track], spec_m: BASpec,
    frames_by_id: Dict[int, Frame], calib: CalibArrays, caps: Caps,
    caps_loc: Optional[Caps] = None, dtype=None, loc_dtype=None,
    max_iterations: int = 10,
    prev_states: Optional[FrameStates] = None, loc_ip_prev: int = -1,
):
    """Fully fused sliding-keyframe step: localize + triangulate + window
    solve + validation, then the marginalization, with one fetch by the
    caller. With `prev_states` the localize prior's anchor chains device to
    device from them (the previous subwindow solve, slot `loc_ip_prev`),
    counted in PROGRAM_STATS as "fused_keyframe_async".

    spec_w must already include `pending` tracks (their factors are gated
    on the device by triangulation success). Returns
    (res, res_loc, lm_w, valid_out, tri_ok, tri_invd, new_prior) on the
    device."""
    global CAPTURED_KEYFRAME
    with _stats_lock:
        KF_FUSED_COUNT.n += 1
    a, lm_w = assemble_keyframe_fused(
        spec_loc, pending, spec_w, tracks_v, spec_m, frames_by_id, calib,
        caps, caps_loc=caps_loc, dtype=dtype, loc_dtype=loc_dtype,
    )
    name = "fused_keyframe" if prev_states is None else "fused_keyframe_async"
    out = run_keyframe_fused(a, spec_w.prior, calib.tree, max_iterations, prev=prev_states,
                             loc_ip_prev=loc_ip_prev, name=name)
    if (CAPTURE_KEYFRAME and CAPTURED_KEYFRAME is None
            and (CAPTURE_KEYFRAME != "chained" or prev_states is not None)):
        CAPTURED_KEYFRAME = (
            (a, spec_w.prior, calib.tree, max_iterations, prev_states, loc_ip_prev), out)
    res, res_loc, valid_out, tri_ok, tri_invd, new_prior = out
    return res, res_loc, lm_w, valid_out, tri_ok, tri_invd, new_prior


def keyframe_transfer_tree(res: ba.BAResult, res_loc: ba.BAResult, valid_out, tri_ok,
                           tri_invd):
    """The 14 device tensors the keyframe step's host apply reads, in the
    order the synchronous fetch reads them: the window states and inverse
    depths, the localize states, the validation verdicts and the
    triangulation outcome."""
    s, sl = res.states, res_loc.states
    return (s.q, s.p, s.v, s.bg, s.ba, res.inv_depth,
            sl.q, sl.p, sl.v, sl.bg, sl.ba, valid_out, tri_ok, tri_invd)


def solve_keyframe_fused_async(*args, prev_states: FrameStates, loc_ip_prev: int, **kw):
    """The async fused keyframe step (the JAX package's name): one dispatch
    of `solve_keyframe_fused` chained from `prev_states`, with no blocking
    fetch. Returns (res, lm_w, transfer, new_prior): res.states stay on the
    device for the next frame's chain, `transfer` is the tuple for
    `utils/host.fetch_async` (`keyframe_transfer_tree`, what the
    synchronous step fetches), and the new prior never leaves the device."""
    res, res_loc, lm_w, valid_out, tri_ok, tri_invd, new_prior = solve_keyframe_fused(
        *args, prev_states=prev_states, loc_ip_prev=loc_ip_prev, **kw)
    return res, lm_w, keyframe_transfer_tree(res, res_loc, valid_out, tri_ok, tri_invd), new_prior


def solve_window_validate_marginalize(
    spec_w: BASpec, tracks_v: List[Track], spec_m: BASpec,
    frames_by_id: Dict[int, Frame], calib: CalibArrays, caps: Caps,
    dtype=None, max_iterations: int = 10,
):
    """Fused keyframe tail: the window solve, landmark validation, then the
    slot-0 marginalization; the new prior stays on the device.

    Returns (res, lm_slot_w, valid_out_dev, new_prior); `valid_out_dev[i]`
    corresponds to tracks_v[i] (truncated at 2*caps.L)."""
    Lv = 2 * caps.L
    Ov = caps.O
    wslot = {f.id: i for i, f in enumerate(spec_w.frames)}
    with _T.time("bld.wvm.assemble"):
        pa_w, lm_w = _assemble(spec_w, caps, calib)
        va = _assemble_validation(tracks_v, frames_by_id, wslot, lm_w, calib, Lv, Ov)
        pa_m, lm_m = _assemble(spec_m, caps, calib)
    vti_of_tid = {t.id: i for i, t in enumerate(tracks_v[:Lv])}
    mlm_vti = np.full(caps.L, -1, np.int32)
    mlm_from_w = np.full(caps.L, -1, np.int32)
    for tid, s in lm_m.items():
        mlm_vti[s] = vti_of_tid.get(tid, -1)
        mlm_from_w[s] = lm_w.get(tid, -1)
    ct = calib.tree
    dev = _dev_of(ct)
    res, valid_out = _count("fused_window_tail", fused_window_tail,
                            _cast_pa(pa_w, dtype), spec_w.prior, _up(va, dev), ct,
                            max_iterations)
    # no-triangulation case: sentinel tri arrays, mlm_tri all -1
    new_prior = _count(
        "marginalize_tail", marginalize_tail,
        res.states, res.inv_depth, valid_out,
        torch.ones(1, dtype=torch.float64, device=dev),
        torch.ones(1, dtype=torch.bool, device=dev),
        pa_m, to_device(mlm_vti, dev), to_device(mlm_from_w, dev),
        to_device(np.full(caps.L, -1, np.int32), dev), spec_w.prior, ct,
    )
    return res, lm_w, valid_out, new_prior


def result_transfer_tree(res: ba.BAResult):
    """The (device) tuple apply_result_np consumes — fetch it (sync or
    async) and hand the NumPy tuple over."""
    return (res.states.q, res.states.p, res.states.v, res.states.bg,
            res.states.ba, res.inv_depth)


def apply_result(res: ba.BAResult, spec: BASpec, lm_slot: Dict[int, int]):
    # one batched device->host transfer for the whole result
    apply_result_np(fetch(result_transfer_tree(res)), spec, lm_slot)


def apply_result_np(host_tree, spec: BASpec, lm_slot: Dict[int, int]):
    q, p, v, bg, ba_, invd = host_tree
    for i, f in enumerate(spec.frames):
        if not spec.fix_pose[i]:
            f.q, f.p = q[i], p[i]
        if not spec.fix_motion[i]:
            f.v, f.bg, f.ba = v[i], bg[i], ba_[i]
    by_id = {t.id: t for t in spec.opt_tracks}
    for tid, s in lm_slot.items():
        t = by_id.get(tid)
        if t is not None:
            t.inv_depth = float(invd[s])


# ---------------------------------------------------------------------------
# batched triangulation
# ---------------------------------------------------------------------------


def assemble_triangulation(
    tracks: List[Track], frames_by_id: Dict[int, Frame], calib: CalibArrays,
    caps: Caps, solved_frame_id: Optional[int] = None,
):
    """NumPy view arrays for batched N-view DLT, padded to (n_cap, TRI_VIEWS).

    Views of `solved_frame_id` get use_solved=1 and placeholder poses: the
    fused localize+triangulate programs substitute the freshly solved frame
    pose on the device. The batch pads to TRI_PAD, to L beyond it, and to
    the exact count beyond L."""
    V = caps.TRI_VIEWS
    n = len(tracks)
    if n <= caps.TRI_PAD:
        n_cap = caps.TRI_PAD
    elif n <= caps.L:
        n_cap = caps.L
    else:
        n_cap = n
    b = np.tile([0.0, 0, 1.0], (n_cap, V, 1))
    qcw = np.tile([1.0, 0, 0, 0], (n_cap, V, 1))
    pcw = np.zeros((n_cap, V, 3))
    m = np.zeros((n_cap, V))
    us = np.zeros((n_cap, V))
    q_bc = calib.q_bc_h
    p_bc = calib.p_bc_h
    # world->camera pose per frame, computed once per frame
    cam_cache = {}

    def _cam(f):
        c = cam_cache.get(f.id)
        if c is None:
            qc, pc = f.get_pose(q_bc, p_bc)
            qcw_f = qconj(qc)
            c = cam_cache[f.id] = (qcw_f, -qrot(qcw_f, pc))
        return c

    for ti, t in enumerate(tracks):
        vi = 0
        for fid, k in t.obs.items():
            f = frames_by_id.get(fid)
            if f is None or vi >= V:
                continue
            if solved_frame_id is not None and fid == solved_frame_id:
                us[ti, vi] = 1.0
            else:
                qcw[ti, vi], pcw[ti, vi] = _cam(f)
            b[ti, vi] = f.bearings[k]
            m[ti, vi] = 1.0
            vi += 1
    return b, qcw, pcw, m, us


def triangulate_tracks(
    tracks: List[Track], frames_by_id: Dict[int, Frame], calib: CalibArrays, caps: Caps
):
    """Batched N-view DLT over all given tracks (reference track.cpp:46-76).

    Returns (points (N,3), ok (N,)) in the world frame, on the host."""
    n = len(tracks)
    if n == 0:
        return np.zeros((0, 3)), np.zeros(0, bool)
    b, qcw, pcw, m, _ = assemble_triangulation(tracks, frames_by_id, calib, caps)
    dev = _dev_of(calib.tree)
    pts, ok = fetch(_count("triangulate_batch", triangulate_batch,
                           *(to_device(a, dev) for a in (b, qcw, pcw, m))))
    return pts[:n], ok[:n]


def fused_localize_triangulate(pa_loc, b, qcw, pcw, m, us, calib, max_iterations):
    """Localize solve chained into batched triangulation: the solved frame's
    camera pose replaces the flagged view rows on the device (reference
    track() :101-125 then track_landmark :204-224 for the keyframe path).
    Triangulation stays f64."""
    s_loc, invd_loc, pb_loc = _finalize_problem(pa_loc, calib, None, False)
    res = ba.solve_ba(s_loc, invd_loc, pb_loc, max_iterations=max_iterations)
    qcw, pcw = _solved_view_poses(res.states, calib, qcw, pcw, us)
    pts, ok = triangulate_batch(b, qcw, pcw, m)
    return res, pts, ok


def solve_localize_triangulate(
    spec_loc: BASpec, tracks: List[Track], frames_by_id: Dict[int, Frame],
    calib: CalibArrays, caps_fast: Caps, caps: Caps, dtype=None,
    max_iterations: int = 10,
):
    """Fused keyframe-path head: localization solve + triangulation of the
    new keyframe's pending tracks, one fetch.

    Applies the localized state to spec_loc.frames[0] and returns
    (points (N,3), ok (N,)) for `tracks`."""
    n = len(tracks)
    solved_fid = spec_loc.frames[0].id
    pa, _ = _assemble(spec_loc, caps_fast, calib)
    pa = _cast_pa(pa, dtype)
    b, qcw, pcw, m, us = assemble_triangulation(
        tracks, frames_by_id, calib, caps, solved_frame_id=solved_fid
    )
    ct = calib.tree
    dev = _dev_of(ct)
    res, pts, ok = _count("fused_localize_triangulate", fused_localize_triangulate,
                          pa, *(to_device(a, dev) for a in (b, qcw, pcw, m, us)),
                          ct, max_iterations)
    s = res.states
    q, p, v, bg, ba_, pts_h, ok_h = fetch((s.q, s.p, s.v, s.bg, s.ba, pts, ok))
    fj = spec_loc.frames[0]
    fj.q, fj.p, fj.v, fj.bg, fj.ba = q[0], p[0], v[0], bg[0], ba_[0]
    return pts_h[:n], ok_h[:n]


# ---------------------------------------------------------------------------
# landmark point <-> inverse depth (reference track.cpp:90-101)
# ---------------------------------------------------------------------------


def get_landmark_point(track: Track, frames_by_id, calib: CalibArrays):
    fid = track.first_frame_id()
    f = frames_by_id[fid]
    qc, pc = f.get_pose(calib.q_bc_h, calib.p_bc_h)
    z = f.bearings[track.obs[fid]]
    return qrot(qc, z / track.inv_depth) + pc


def get_landmark_points_batch(tracks: List[Track], frames_by_id, calib: CalibArrays):
    """World points of many tracks at once: anchor camera poses computed once
    per distinct anchor frame, the anchor keypoint gathered through the
    anchor frame's row->keypoint map, one einsum over all tracks."""
    out = np.zeros((len(tracks), 3))
    if not tracks:
        return out
    st = tracks[0].store
    rows = np.array([t.row for t in tracks], np.int64)
    aids = st.first_fid[rows]
    invd = st.inv_depth[rows]
    uaids, inv = np.unique(aids, return_inverse=True)
    Rs = np.empty((len(uaids), 3, 3))
    ps = np.empty((len(uaids), 3))
    bearing_of_row = np.zeros((st.cap, 3))
    for ui, aid in enumerate(uaids):
        f = frames_by_id[int(aid)]
        qc, pc = f.get_pose(calib.q_bc_h, calib.p_bc_h)
        Rs[ui] = q_to_R(qc)
        ps[ui] = pc
        fr = st.rows_of(f.track_ids)
        # only rows ANCHORED at this frame keep this frame's bearing
        msk = (fr >= 0) & (st.first_fid[np.clip(fr, 0, None)] == f.id)
        bearing_of_row[fr[msk]] = f.bearings[msk]
    z = bearing_of_row[rows] / np.maximum(invd, 1e-12)[:, None]
    out[:] = np.einsum("nij,nj->ni", Rs[inv], z) + ps[inv]
    return out


def set_landmark_point(track: Track, x_world, frames_by_id, calib: CalibArrays):
    fid = track.first_frame_id()
    f = frames_by_id[fid]
    qc, pc = f.get_pose(calib.q_bc_h, calib.p_bc_h)
    d = np.linalg.norm(qrot(qconj(qc), np.asarray(x_world) - pc))
    track.inv_depth = 1.0 / max(d, 1e-9)
