"""Device-resident per-frame frontend loop: the keypoint state machine lives
on the device, the host consumes results one or more frames stale.

The counterpart of the JAX package's ops/frontend_loop.py.

    state_N, fetch_N = ft_loop_step(state_{N-1}, pyr_{N-1}, pyr_N, ...)

The `state` output feeds the next call without a host copy, so the device
queue carries the frame-to-frame dependency; the host fetches `fetch_N`
asynchronously (utils/host.fetch_async), does its track bookkeeping later,
and feeds back only a small `host_drop` mask (tracks the host retired).

Everything the reference does per frame (frame.cpp:74-172 plus the
opencv_image.cpp:75-154 LK and :38-73 detection) happens here, in order:

  1. IMU-predicted initial flow (frame.cpp:82-93) from the host-supplied
     camera-frame delta rotation,
  2. pyramidal LK forward + reverse-flow check (ops/image/klt, one launch
     of the fused CUDA kernel on a GPU),
  3. essential-RANSAC mask + rotation-RANSAC misalignment percentile
     (ops/frontend_step.ft_masks),
  4. track-length-priority Poisson-disk re-filter (frame.cpp:134-161),
  5. on detection frames: Harris GFTT spaced against the survivors, new
     corners merged into free slots.

Slot semantics: `cont[i]` means slot i survived from the previous frame
(same physical track); `born[i]` means slot i was filled by a fresh
detection this frame.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch

from rd_vio_tpu_torch.ops.frontend_step import ft_masks
from rd_vio_tpu_torch.ops.image import klt as klt_mod
from rd_vio_tpu_torch.ops.image.gftt import detect_gftt
from rd_vio_tpu_torch.ops.poisson_disk import poisson_disk_filter


class FTLoopState(NamedTuple):
    """Device-resident keypoint state (capacity C slots)."""

    pix: torch.Tensor  # (C, 2) f32 pixel position in the latest frame
    valid: torch.Tensor  # (C,) bool slot alive
    life: torch.Tensor  # (C,) int32 consecutive-tracked length (track.m_life)


def init_state(cap: int, device) -> FTLoopState:
    return FTLoopState(
        pix=torch.zeros((cap, 2), dtype=torch.float32, device=device),
        valid=torch.zeros((cap,), dtype=torch.bool, device=device),
        life=torch.zeros((cap,), dtype=torch.int32, device=device),
    )


def _bearing(pix, K):
    x = (pix[:, 0] - K[0, 2]) / K[0, 0]
    y = (pix[:, 1] - K[1, 2]) / K[1, 1]
    b = torch.stack([x, y, torch.ones_like(x)], dim=-1)
    return b / torch.linalg.vector_norm(b, dim=-1, keepdim=True)


def _project(b, K):
    z = torch.clamp(b[:, 2], min=1e-6)
    return torch.stack(
        [b[:, 0] / z * K[0, 0] + K[0, 2], b[:, 1] / z * K[1, 1] + K[1, 2]],
        dim=-1,
    )


def ft_loop_step(
    state: FTLoopState,
    pyr_prev, pyr_next,  # pyramids (lists of (H, W) f32 tensors)
    R_pred,  # (3, 3) camera-frame delta rotation (IMU initial flow)
    noise,  # (gumbel_essential, gumbel_rotation), each (K, C)
    host_drop,  # (C,) bool — tracks the host retired (stale ok)
    K,  # (3, 3) intrinsics
    rot_thresh: float,  # radians — rotation-RANSAC inlier bound
    detect: bool,  # detection frame?
    max_points: int,
    min_dist: float,
    lk=klt_mod.lk_track_fwd_rev,
    timer=None,
):
    """One frame step of the device-resident frontend. Returns
    (new_state, fetch) where `fetch` is the host bookkeeping payload:

      pix (C, 2)    keypoint pixel in the NEW frame (valid slots)
      valid (C,)    slot alive after this frame
      cont (C,)     slot survived tracking from the previous frame
      born (C,)     slot newly filled by a detection this frame
      life (C,)     updated consecutive-tracked length
      misalign ()   rotation-RANSAC 70th-percentile misalignment (degrees)

    `lk` is the forward + reverse tracker (`klt.lk_track_fwd_rev`, the fused
    CUDA kernel on a GPU, or `klt.lk_track_fwd_rev_plain`); `timer` is an
    optional utils.metrics.DeviceStageTimer that times the stages ft.lk,
    ft.masks, ft.poisson and ft.gftt.
    """
    f32 = torch.float32
    stage = timer.time if timer is not None else (lambda _: contextlib.nullcontext())
    C = state.pix.shape[0]
    dev = state.pix.device
    K = K.to(f32)
    H, W = pyr_next[0].shape

    valid = state.valid & ~host_drop

    # 1. IMU-predicted initial flow
    b1 = _bearing(state.pix, K)
    pred_pix = _project(b1 @ R_pred.to(f32).T, K)
    pred_pix = torch.where(valid[:, None], pred_pix, state.pix)

    # 2. pyramidal LK fwd + reverse check
    with stage("ft.lk"):
        tracked, st = lk(pyr_prev, pyr_next, state.pix, pred_pix, valid)

    # 3. RANSAC masks + pure-rotation misalignment
    with stage("ft.masks"):
        b2 = _bearing(tracked, K)
        out = ft_masks(b1, b2, st, noise, rot_thresh)
        status = st & out["mask"]

    # 4. track-length-priority Poisson re-filter (priority = life desc,
    #    slot index asc as the deterministic tiebreak)
    with stage("ft.poisson"):
        key_sort = -state.life * C + torch.arange(C, dtype=torch.int32, device=dev)
        order = torch.argsort(key_sort)
        acc_o = poisson_disk_filter(
            tracked[order], status[order],
            min_distance=float(min_dist), width=float(W), height=float(H),
        )
        acc = torch.zeros(C, dtype=torch.bool, device=dev).index_copy_(0, order, acc_o)
        cont = status & acc

    new_pix = torch.where(cont[:, None], tracked, 0.0)
    new_life = torch.where(cont, state.life + 1, 0).to(torch.int32)
    born = torch.zeros(C, dtype=torch.bool, device=dev)

    # 5. detection frames: GFTT spaced against survivors, merged into free
    #    slots (first-free-slot order)
    if detect:
        with stage("ft.gftt"):
            preset = torch.where(cont[:, None], tracked, -1e6)
            det_pix, det_val, _ = detect_gftt(
                pyr_next[0], preset, cont,
                max_points=int(max_points), min_dist=float(min_dist),
            )
            M = det_pix.shape[0]
            free = ~cont
            slots = torch.arange(C, device=dev)
            # index of the k-th free slot: ascending sort of (slot index | C)
            free_slots = torch.sort(torch.where(free, slots, C)).values
            n_free = free.sum()
            k = torch.arange(M, device=dev)
            place = det_val & (k < n_free)
            # row C takes every detection that is not placed and is dropped
            target = torch.where(place, free_slots[torch.clamp(k, max=C - 1)], C)
            new_pix = torch.cat([new_pix, new_pix.new_zeros(1, 2)]).index_copy_(
                0, target, det_pix.to(f32))[:C]
            born = torch.zeros(C + 1, dtype=torch.bool, device=dev).index_copy_(
                0, target, place)[:C]
            new_life = torch.where(born, 1, new_life).to(torch.int32)

    new_valid = cont | born
    new_state = FTLoopState(
        pix=torch.where(new_valid[:, None], new_pix, 0.0),
        valid=new_valid, life=new_life,
    )
    fetch = {
        "pix": new_state.pix,
        "valid": new_valid,
        "cont": cont,
        "born": born,
        "life": new_life,
        "misalign": out["misalign"],
    }
    return new_state, fetch
