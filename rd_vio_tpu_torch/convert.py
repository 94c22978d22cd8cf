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
