"""Batched fixed-iteration RANSAC engines.

Behavioral reference: ransac.h:26-82 (generic RANSAC) and the concrete
wrappers in stereo.cpp:11-184 (error functions and chi-square thresholds
t1=3.84, t2=5.99).

As in the JAX package (ops/ransac.py): K hypotheses are drawn at once by
Gumbel-top-k sampling without replacement, all minimal problems are solved
batched, all N points x K models are scored in one pass, and the model with
the most inliers wins. Here the Gumbel noise (K, N) is an ARGUMENT: the
caller draws it (`GumbelSource`, from a `torch.Generator`), and a test can
pass the very noise `jax.random.gumbel` drew from the JAX package's key to
get identical hypotheses.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from rd_vio_tpu_torch.ops import epipolar, homography, pnp, wahba

CHI2_1DOF = 3.84  # reference stereo.cpp:59 (t1)
CHI2_2DOF = 5.99  # reference stereo.cpp:85,113 (t2)


class RansacResult(NamedTuple):
    model: torch.Tensor  # best model parameters
    inlier_mask: torch.Tensor  # (N,) bool
    inlier_count: torch.Tensor  # scalar int


class GumbelSource:
    """Standard Gumbel noise from a seeded `torch.Generator` on `device`
    (the counterpart of the JAX package's PRNG key chain). Each call draws
    a pair (essential, rotation) of (K, N) f32 tensors."""

    def __init__(self, seed: int, device):
        self.device = torch.device(device)
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(int(seed))

    def __call__(self, num_hypotheses: int, n: int):
        g = self.draw((2, num_hypotheses, n))
        return g[0], g[1]

    def draw(self, shape):
        """One tensor of standard Gumbel noise of `shape` (f32)."""
        u = torch.rand(shape, generator=self.gen, device=self.device,
                       dtype=torch.float32)
        tiny = torch.finfo(torch.float32).tiny
        return -torch.log(-torch.log(torch.clamp(u, min=tiny)))


def sample_indices(gumbel, valid, sample_size: int, logits=None):
    """Minimal sample index sets without replacement, one per row of the
    (K, N) Gumbel noise: the top `sample_size` of noise + per-point logits
    (uniform by default; PARSAC passes its bin-weighted ones). Invalid points
    get -inf logits and are never drawn; ties go to the lower index, as
    `lax.top_k` does. The sum is taken in f32, as in the JAX package.

    Returns (K, M) int64 indices."""
    if logits is None:
        base = torch.where(valid, 0.0, float("-inf"))
    else:
        base = torch.where(valid, logits, float("-inf"))
    scores = gumbel.to(torch.float32) + base[None, :].to(torch.float32)
    idx = torch.sort(scores, dim=-1, descending=True, stable=True).indices
    return idx[:, :sample_size]


def _best_by_count(models, errors, threshold, valid):
    """Pick the model with most masked inliers (first on ties). errors: (K, N)."""
    inl = (errors <= threshold) & valid[None, :]
    counts = inl.sum(dim=-1)
    best = torch.argmax(counts).reshape(1)
    return RansacResult(
        model=models.index_select(0, best)[0],
        inlier_mask=inl.index_select(0, best)[0],
        inlier_count=counts.index_select(0, best)[0],
    )


def ransac_essential(gumbel, p1, p2, valid, threshold: float):
    """find_essential_matrix (reference stereo.cpp:38-66): symmetric epipolar
    error with inlier bound 2*t1*threshold^2; threshold in normalized units.
    gumbel: (K, N) noise, one row per hypothesis."""
    idx = sample_indices(gumbel, valid, 8)
    E = epipolar.solve_essential_8pt(p1[idx], p2[idx])  # (K, 3, 3)
    err = epipolar.essential_geometric_error(E, p1[None], p2[None]) + \
        epipolar.essential_geometric_error(E.transpose(-1, -2), p2[None], p1[None])
    return _best_by_count(E, err, 2.0 * CHI2_1DOF * threshold ** 2, valid)


def ransac_rotation(gumbel, b1, b2, valid, threshold: float):
    """find_rotation_matrix (reference stereo.cpp:68-92): angular error
    acos((R b1).b2) with bound t2*threshold^2 (threshold in radians)."""
    idx = sample_indices(gumbel, valid, 2)
    R = wahba.solve_rotation(b1[idx], b2[idx])  # (K, 3, 3)
    err = wahba.rotation_angular_error(R, b1[None], b2[None])
    return _best_by_count(R, err, CHI2_2DOF * threshold ** 2, valid)


def ransac_homography(gumbel, p1, p2, valid, threshold: float):
    """find_homography_matrix (reference stereo.cpp:94-117): symmetric transfer
    error with bound 2*t2*threshold^2. gumbel: (K, N) noise."""
    idx = sample_indices(gumbel, valid, 4)
    H = homography.solve_homography_dlt(p1[idx], p2[idx])  # (K, 3, 3)
    # H^-1 up to scale by the adjugate; the scale cancels in the error
    Hinv = _adjugate_3x3(H)
    err = homography.homography_geometric_error(H, p1[None], p2[None]) + \
        homography.homography_geometric_error(Hinv, p2[None], p1[None])
    return _best_by_count(H, err, 2.0 * CHI2_2DOF * threshold ** 2, valid)


def ransac_pnp(gumbel, x_world, p_norm, valid, threshold: float):
    """find_pnp_matrix (reference pnp.h:96-131): reprojection error on the
    normalized plane with bound 2*t2*threshold^2. gumbel: (K, N) noise.
    Returns model (R|t) as (3, 4)."""
    idx = sample_indices(gumbel, valid, 6)
    R, t = pnp.solve_pnp_dlt(x_world[idx], p_norm[idx])  # (K,3,3), (K,3)
    err = pnp.pnp_reprojection_error(R, t, x_world[None], p_norm[None])
    err = torch.where(torch.isfinite(err), err, 1e18)
    models = torch.cat([R, t[..., None]], dim=-1)
    return _best_by_count(models, err, 2.0 * CHI2_2DOF * threshold ** 2, valid)


def _adjugate_3x3(M):
    """Adjugate of a 3x3 (batched): inv(M) up to det scale."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    return torch.stack(
        [
            torch.stack([e * i - f * h, c * h - b * i, b * f - c * e], dim=-1),
            torch.stack([f * g - d * i, a * i - c * g, c * d - a * f], dim=-1),
            torch.stack([d * h - e * g, b * g - a * h, a * e - b * d], dim=-1),
        ],
        dim=-2,
    )
