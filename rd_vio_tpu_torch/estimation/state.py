"""Fixed-capacity struct-of-arrays window state and the error-state retraction.

Port of the JAX package's estimation/state.py: a window of W frame states as
[W]-leading tensors, error-state layout (q, p, v, bg, ba) of 15 dims, and the
right-multiply expmap retraction.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from rd_vio_tpu_torch.ops.lie import expmap, logmap, quat_conj, quat_mul, quat_normalize

ES_Q, ES_P, ES_V, ES_BG, ES_BA, ES_SIZE = 0, 3, 6, 9, 12, 15


class FrameStates(NamedTuple):
    """Window frame states, [W] leading axis. Pose (q, p) maps body->world."""

    q: torch.Tensor  # (W, 4) wxyz
    p: torch.Tensor  # (W, 3)
    v: torch.Tensor  # (W, 3)
    bg: torch.Tensor  # (W, 3)
    ba: torch.Tensor  # (W, 3)


def zero_states(W: int, dtype=torch.float64, device="cuda") -> FrameStates:
    q = torch.zeros((W, 4), dtype=dtype, device=device)
    q[:, 0] = 1.0
    p, v, bg, ba = torch.zeros((4, W, 3), dtype=dtype, device=device)
    return FrameStates(q=q, p=p, v=v, bg=bg, ba=ba)


def retract(states: FrameStates, delta: torch.Tensor) -> FrameStates:
    """states ⊞ delta with delta (W, 15) in (q, p, v, bg, ba) order; the
    quaternion uses the right-multiply expmap manifold."""
    dq = expmap(delta[:, ES_Q : ES_Q + 3])
    return FrameStates(
        q=quat_normalize(quat_mul(states.q, dq)),
        p=states.p + delta[:, ES_P : ES_P + 3],
        v=states.v + delta[:, ES_V : ES_V + 3],
        bg=states.bg + delta[:, ES_BG : ES_BG + 3],
        ba=states.ba + delta[:, ES_BA : ES_BA + 3],
    )


def local_delta(states: FrameStates, lin: FrameStates) -> torch.Tensor:
    """Per-frame 15-dim deviation of `states` from linearization `lin`:
    logmap(q_lin^-1 q) for rotation, plain differences elsewhere. (W, 15)."""
    rq = logmap(quat_mul(quat_conj(lin.q), states.q))
    return torch.cat(
        [rq, states.p - lin.p, states.v - lin.v, states.bg - lin.bg, states.ba - lin.ba],
        dim=-1,
    )
