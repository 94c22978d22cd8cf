"""Poisson-disk min-distance filtering for keypoint spacing.

Behavioral reference: poisson_disk_filter.h:22-56 (sparse grid hash,
preset_point / permit_point / insert_points) — used to space GFTT detections
(opencv_image.cpp:38-73) and to re-filter tracked keypoints by track-length
priority (frame.cpp:134-161).

A greedy scan over priority-ordered candidates with a dense occupancy grid,
the same semantics as the JAX package's `lax.scan` (ops/poisson_disk.py):
cell size r/sqrt(2) holds at most one accepted point, so a 5x5 neighbourhood
check covers every point within distance r; a preset point is always
inserted and overwrites its cell.

The scan is sequential by nature. Here it is a Python loop of a few small
tensor ops per candidate that never synchronises with the host (no
`.item()`, no branch on a tensor value), so on a GPU the whole scan is
queued at once — but each candidate still costs about a dozen kernel
launches.
"""

from __future__ import annotations

import math

import torch


def poisson_disk_filter(points: torch.Tensor, valid: torch.Tensor,
                        min_distance: float, width: float, height: float,
                        preset_count: int = 0) -> torch.Tensor:
    """Greedy min-distance acceptance over priority-ordered points.

    points: (N, 2) pixel coords, highest priority first; the first
    `preset_count` rows are preset points (always inserted). valid: (N,)
    bool. Returns the accept mask (N,) bool (presets report their own
    validity)."""
    r = float(min_distance)
    cell = r / math.sqrt(2.0)
    gx = int(math.ceil(width / cell)) + 4
    gy = int(math.ceil(height / cell)) + 4
    dev = points.device
    n = points.shape[0]
    r2 = r * r

    # cell of every candidate, computed once (true f32 division, as XLA)
    cell_t = torch.full((), cell, dtype=points.dtype, device=dev)
    cj = torch.clamp((points[:, 0] / cell_t).to(torch.int32) + 2, 2, gx - 3)
    ci = torch.clamp((points[:, 1] / cell_t).to(torch.int32) + 2, 2, gy - 3)
    flat = ci.to(torch.int64) * gx + cj.to(torch.int64)  # (N,)
    d = torch.arange(-2, 3, device=dev)
    offs = (d[:, None] * gx + d[None, :]).reshape(-1)  # (25,)
    nbr = flat[:, None] + offs[None, :]  # (N, 25)

    # grid rows: [x, y, occupied]
    grid = torch.zeros(gy * gx, 3, dtype=points.dtype, device=dev)
    rows = torch.cat([points, torch.ones_like(points[:, :1])], dim=1)
    is_preset = torch.arange(n, device=dev) < preset_count
    accepted = torch.zeros(n, dtype=torch.bool, device=dev)
    for i in range(n):
        g = grid.index_select(0, nbr[i])  # (25, 3)
        dd = g[:, :2] - points[i]
        d2 = dd[:, 0] * dd[:, 0] + dd[:, 1] * dd[:, 1]
        conflict = ((g[:, 2] > 0) & (d2 < r2)).any()
        accept = valid[i] & (is_preset[i] | ~conflict)
        accepted[i] = accept
        c = flat[i: i + 1]
        grid.index_copy_(
            0, c, torch.where(accept, rows[i: i + 1], grid.index_select(0, c)))
    return accepted


def poisson_disk_filter_np(points, valid, min_distance: float, width: float,
                           height: float, preset_count: int = 0):
    """Host twin of `poisson_disk_filter`, the same greedy grid-hash
    semantics: the re-filter of the feature tracker's host-mask path runs
    on the host after the mask RANSAC. Uses the native C++ filter when it
    is available; this loop is its plain version and gives the same mask."""
    import numpy as np

    from rd_vio_tpu_torch import native

    if native.available():
        return native.poisson_filter(points, valid, min_distance, width, height,
                                     preset_count=preset_count)

    r = float(min_distance)
    cell = r / math.sqrt(2.0)
    gx = int(math.ceil(width / cell)) + 4
    gy = int(math.ceil(height / cell)) + 4
    occ = {}
    acc = np.zeros(len(points), bool)
    r2 = r * r
    for idx in range(len(points)):
        if not valid[idx]:
            continue
        p = points[idx]
        cj = min(max(int(p[0] / cell) + 2, 2), gx - 3)
        ci = min(max(int(p[1] / cell) + 2, 2), gy - 3)
        if idx < preset_count:
            conflict = False
        else:
            conflict = any(
                (q[0] - p[0]) ** 2 + (q[1] - p[1]) ** 2 < r2
                for di in range(-2, 3)
                for dj in range(-2, 3)
                if (q := occ.get((ci + di, cj + dj))) is not None
            )
        if not conflict:
            acc[idx] = True
            occ[(ci, cj)] = (float(p[0]), float(p[1]))
    return acc
