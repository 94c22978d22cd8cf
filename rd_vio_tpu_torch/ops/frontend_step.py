"""Per-frame RANSAC masks of the frontend (reference frame.cpp:108-131).

`ft_masks` is the counterpart of the JAX package's ops/frontend_step.ft_masks
(the body the device loop shares) and `ft_step` of its standalone program:
an essential-RANSAC match mask plus a rotation RANSAC whose inliers give the
70th-percentile misalignment of the pure-rotation detector. The JAX version
splits one PRNG key into an (essential, rotation) pair; here that pair of
(K, N) Gumbel noise tensors is the `noise` argument. All math is f32.

`torch.linalg.eigh` on a CUDA tensor synchronises with the host (it checks
its error codes), so this function waits for the device three times.
"""

from __future__ import annotations

import torch

from rd_vio_tpu_torch.ops import ransac


def ft_masks(b1, b2, valid, noise, rot_thresh):
    """b1, b2: (N, 3) bearings in the previous / next frame; valid: (N,)
    bool; noise: (gumbel_essential, gumbel_rotation), each (K, N);
    rot_thresh: rotation-RANSAC inlier bound (radians).

    Returns {"mask": (N,) bool, "misalign": () f32 degrees}."""
    f32 = torch.float32
    b1 = b1.to(f32)
    b2 = b2.to(f32)
    g_e, g_r = noise

    # --- 1. essential RANSAC mask (threshold 1.0 — reference frame.cpp:108) --
    pn1 = b1[:, :2] / b1[:, 2:]
    pn2 = b2[:, :2] / b2[:, 2:]
    res_e = ransac.ransac_essential(g_e, pn1, pn2, valid, threshold=1.0)
    status = valid & res_e.inlier_mask

    # --- 2. rotation RANSAC + misalignment percentile ------------------
    res_r = ransac.ransac_rotation(g_r, b1, b2, valid, threshold=rot_thresh)
    Rb1 = torch.einsum("ij,nj->ni", res_r.model.to(f32), b1)
    ang = torch.rad2deg(torch.arccos(torch.clamp((Rb1 * b2).sum(dim=-1), -1.0, 1.0)))
    rmask = res_r.inlier_mask & valid
    n_in = rmask.sum()
    ang_sorted = torch.sort(torch.where(rmask, ang, float("inf"))).values
    idx70 = torch.clamp(n_in * 7 // 10, 0, ang.shape[0] - 1).reshape(1)
    misalign = torch.where(n_in > 0, ang_sorted.gather(0, idx70)[0], 0.0)

    return {
        "mask": status,
        "misalign": misalign,
    }


def ft_step(b1, b2, valid, noise, rot_thresh):
    """The standalone per-frame mask program (the host-mask tracker's
    `feature_tracker_host_masks=False` branch): `ft_masks` on the padded
    (KP_CAP,) matches. The track-length-priority Poisson re-filter
    (reference frame.cpp:134-161) runs on the host after the fetch."""
    return ft_masks(b1, b2, valid, noise, rot_thresh)
