"""Carry the JAX package's state into the port's.

The system has no learned weights; what the two packages must share to
start from the same point is the configuration, the device-loop keypoint
state, the image pyramids and the estimator's window state and problem.
Each function takes the JAX side's values as NumPy arrays (`np.asarray` of
a JAX array, or the JAX `Config` itself, whose fields are NumPy) and returns
the port's counterpart on `device`. Every array keeps its dtype (index
arrays stay int32; the estimator widens them where they index).
"""

from __future__ import annotations

import copy
import dataclasses

import numpy as np
import torch

from rd_vio_tpu_torch.config import Config
from rd_vio_tpu_torch.estimation import ba, factors as F
from rd_vio_tpu_torch.estimation.state import FrameStates
from rd_vio_tpu_torch.ops.frontend_loop import FTLoopState
from rd_vio_tpu_torch.ops.preintegration import PreintDelta

# the port's NamedTuple of each nested field of the estimator's problem
_NESTED = {
    ba.BAProblem: {"reproj": F.ReprojFactors, "reproj_prior": F.ReprojPriorFactors,
                   "imu": F.ImuFactors, "imu_prior": F.ImuPriorFactors,
                   "rot": F.RotFactors, "prior": F.PriorFactor, "ext": F.Extrinsics},
    F.ImuFactors: {"delta": PreintDelta},
    F.ImuPriorFactors: {"delta": PreintDelta},
}


def config_from(cfg) -> Config:
    """Field-by-field copy of a config object with the fields of `Config`."""
    return Config(**{f.name: copy.deepcopy(getattr(cfg, f.name))
                     for f in dataclasses.fields(Config)})


def bin_confidences_from(conf, device) -> torch.Tensor:
    """PARSAC bin confidences, (400,) f64 (the JAX package's x64 carry)."""
    return torch.from_numpy(np.array(conf, np.float64)).to(device)


def parsac_result_np(res) -> dict:
    """A ParsacResult of either package as NumPy arrays, by field name (for
    comparisons)."""
    def host(v):
        return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
    return {k: host(v) for k, v in res._asdict().items()}


def loop_state_from(pix, valid, life, device) -> FTLoopState:
    """FTLoopState from (C, 2) pixels, (C,) validity and (C,) track life."""
    return FTLoopState(
        pix=torch.from_numpy(np.array(pix, np.float32)).to(device),
        valid=torch.from_numpy(np.array(valid, bool)).to(device),
        life=torch.from_numpy(np.array(life, np.int32)).to(device),
    )


def pyramid_from(pyr, device) -> list:
    """A pyramid (sequence of (H, W) arrays, fine to coarse) as f32 tensors."""
    return [torch.from_numpy(np.array(a, np.float32)).to(device) for a in pyr]


def _carry(cls, src, device):
    """`cls` (a NamedTuple of the port) from `src`, an object with the same
    field names whose leaves are arrays, field by field."""
    nested = _NESTED.get(cls, {})
    return cls(**{
        f: _carry(nested[f], getattr(src, f), device) if f in nested
        else torch.from_numpy(np.array(getattr(src, f))).to(device)
        for f in cls._fields})


def frame_states_from(states, device) -> FrameStates:
    """FrameStates from the JAX package's FrameStates (q, p, v, bg, ba)."""
    return _carry(FrameStates, states, device)


def preint_delta_from(delta, device) -> PreintDelta:
    """PreintDelta from the JAX package's PreintDelta (any leading dims)."""
    return _carry(PreintDelta, delta, device)


def ba_problem_from(pb, device) -> ba.BAProblem:
    """BAProblem from the JAX package's BAProblem: every factor group, the
    prior, the extrinsics and the masks."""
    return _carry(ba.BAProblem, pb, device)


def prior_from(prior, device) -> F.PriorFactor:
    """PriorFactor from the JAX package's PriorFactor (or None)."""
    return None if prior is None else _carry(F.PriorFactor, prior, device)


def calib_tree_from(tree, device):
    """builders.CalibTree from the JAX package's CalibTree."""
    from rd_vio_tpu_torch.models import builders

    up = lambda a: torch.from_numpy(np.array(a, np.float64)).to(device)  # noqa: E731
    return builders.CalibTree(
        ext=_carry(F.Extrinsics, tree.ext, device),
        **{f: up(getattr(tree, f)) for f in builders.CalibTree._fields if f != "ext"})


def calib_from(calib, device):
    """builders.CalibArrays from the JAX package's CalibArrays (its host
    mirrors; the device constants are made on `device`)."""
    from rd_vio_tpu_torch.models import builders

    f64 = lambda a: np.array(a, np.float64)  # noqa: E731
    return builders.CalibArrays(
        K=f64(calib.K), sqrt_inv_cov2=f64(calib.sqrt_inv_cov2),
        **{f: f64(getattr(calib, f)) for f in (
            "q_bc_h", "p_bc_h", "q_bi_h", "p_bi_h",
            "cov_w_h", "cov_a_h", "cov_bg_h", "cov_ba_h")},
        device=str(device))


def problem_arrays_from(pa):
    """builders.ProblemArrays (NumPy, host) from the JAX package's."""
    from rd_vio_tpu_torch.models import builders

    cp = lambda a: {k: np.array(v) for k, v in a.items()} if isinstance(a, dict) \
        else np.array(a)  # noqa: E731
    return builders.ProblemArrays(**{f: cp(getattr(pa, f))
                                     for f in builders.ProblemArrays._fields})


def _frame_from(f):
    from rd_vio_tpu_torch.models.map import Frame

    g = object.__new__(Frame)
    g.id, g.t = int(f.id), float(f.t)
    for a in ("q", "p", "v", "bg", "ba", "bearings", "imu_dt", "imu_w", "imu_a"):
        setattr(g, a, np.array(getattr(f, a), np.float64))
    g.track_ids = np.array(f.track_ids, np.int64)
    g.flags = set(f.flags)
    g.subframes = [_frame_from(s) for s in f.subframes]
    g.keyframe_imu = (None if f.keyframe_imu is None
                      else tuple(np.array(x, np.float64) for x in f.keyframe_imu))
    g.image = getattr(f, "image", None)
    return g


def map_from(m):
    """models.map.Map from the JAX package's Map, or from any object with
    its attributes (frames with their subframes; tracks; the SoA store):
    a deep copy that keeps frame ids, track ids and the store's rows, so
    that host assembly over the copy gives the same arrays."""
    from rd_vio_tpu_torch.models.map import Map, Track

    out = Map()
    src, st = m.store, out.store
    st.cap = int(src.cap)
    st.flags = np.array(src.flags, np.uint32)
    st.inv_depth = np.array(src.inv_depth, np.float64)
    st.life = np.array(src.life, np.int64)
    st.first_fid = np.array(src.first_fid, np.int64)
    st._free = [int(r) for r in src._free]
    st._row_of_tid = np.array(src._row_of_tid, np.int64)
    out.frames = [_frame_from(f) for f in m.frames]
    for tid, t in m.tracks.items():
        tr = object.__new__(Track)
        tr.id, tr.row, tr.store = int(t.id), int(t.row), st
        tr.obs = {int(k): int(v) for k, v in t.obs.items()}
        tr.reprojection_error = float(t.reprojection_error)
        out.tracks[int(tid)] = tr
    return out


def ba_spec_from(spec, m, device):
    """builders.BASpec over the port's map `m` from a BASpec whose frames
    and tracks are given by id: the JAX package's BASpec with every Frame
    replaced by its id and every Track by its id (see
    tests/test_torch_builders.spec_ids), its prior as NumPy arrays."""
    from rd_vio_tpu_torch.models import builders

    fr = {f.id: f for f in m.all_frames()}
    tr = m.tracks
    ra = spec["reproj_arrays"]
    return builders.BASpec(
        frames=[fr[i] for i in spec["frames"]],
        fix_pose=list(spec["fix_pose"]), fix_motion=list(spec["fix_motion"]),
        opt_tracks=[tr[i] for i in spec["opt_tracks"]],
        reproj=[(fr[a], fr[b], tr[t], fx) for a, b, t, fx in spec["reproj"]],
        imu=[(fr[a], fr[b], imu, bg, ba_, kf) for a, b, imu, bg, ba_, kf in spec["imu"]],
        rot=[(fr[a], fr[b], tr[t]) for a, b, t in spec["rot"]],
        prior=prior_from(spec["prior"], device),
        reproj_prior=[(fr[a], fr[b], tr[t]) for a, b, t in spec["reproj_prior"]],
        imu_prior=[(fr[a], fr[b], imu) for a, b, imu in spec["imu_prior"]],
        reproj_arrays=None if ra is None else builders.ReprojArrays(**ra),
        opt_invd=spec["opt_invd"],
    )


def batched_chain_from(chain, device) -> FrameStates:
    """The lockstep dispatcher's batched subwindow chain, (N, Wf, ...)
    FrameStates, from the JAX dispatcher's `_chain`."""
    return frame_states_from(chain, device)


def batched_priors_from(priors, device) -> F.PriorFactor:
    """The lockstep dispatcher's batched prior tree, (N, ...) PriorFactor
    leaves, from the JAX dispatcher's `_priors` (or None)."""
    return prior_from(priors, device)


def stacked_from(tree):
    """A stacked (N-leading) host tree of the JAX dispatcher's programs, as
    the port's: ProblemArrays become the port's, dicts stay dicts of NumPy
    arrays (the keyframe step's arrays, the validation arrays)."""
    if isinstance(tree, dict):
        return {k: stacked_from(v) for k, v in tree.items()}
    if hasattr(tree, "_fields") and type(tree).__name__ == "ProblemArrays":
        return problem_arrays_from(tree)
    return np.array(tree)
