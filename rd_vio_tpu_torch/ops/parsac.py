"""Batched PARSAC and IMU-PARSAC: bucketed, prior-gated robust estimation.

Behavioral reference: parsac.h:73-236 (bucketed RANSAC with per-bin
confidence priors carried across frames, coverage x confidence score) and
imu_parsac.h (IMU prior gate at :170-198, overlap gating at :109-119,
track-length weighting t = 1 - dynamic_prob^(0.10*binLen) at :233-237).

Port of the JAX package's ops/parsac.py, the device programs of the
tracker's `parsac_host_masks=False` branches. The 20x20 bin bookkeeping is a
set of masked segment sums over a fixed 400-bin axis (`index_add_`); the
bin-weighted sampler is one Gumbel categorical whose per-point logit
log(conf[bin]/size[bin]) reproduces "draw a bin by confidence, then a point
inside it uniformly"; K hypotheses are evaluated at once. The Gumbel noise
is an ARGUMENT, (K, N) f32 per PARSAC, as in ops/ransac.py. Binning, scores
and confidences run in the points' dtype (f64 on the tracker's path).

Every branch of the reference (the overlap gate, the final fallback, the
IMU gate) is a `torch.where`, so a call makes no host round trip of its own;
but the minimal solvers use `torch.linalg.eigh` / `svd`, which on a CUDA
tensor each synchronise the host: the 8-point fit twice per PARSAC
(`epipolar.solve_essential_8pt`), the DLT twice (`pnp.solve_pnp_dlt`).
`index_add_` on CUDA sums atomically in no fixed order, so f64 bin sums of
non-integer values may differ from the CPU's at the last bit.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from rd_vio_tpu_torch.ops import epipolar, pnp
from rd_vio_tpu_torch.ops.ransac import CHI2_1DOF, CHI2_2DOF, sample_indices

N_BINS_X = 20  # reference parsac.h:238 SetBins(20, 20)
N_BINS_Y = 20
N_BINS = N_BINS_X * N_BINS_Y
MIN_PRIOR_BIN_CONFIDENCE = 0.5  # reference parsac.h:70 m_parsacMinPriorBinConfidence
PNP_SAMPLE = 6
ESSENTIAL_SAMPLE = 8


class ParsacResult(NamedTuple):
    model: torch.Tensor
    inlier_mask: torch.Tensor  # (N,) bool
    inlier_count: torch.Tensor
    best_score: torch.Tensor
    bin_confidences: torch.Tensor  # (400,) updated posterior, carry to next frame
    prior_ok: torch.Tensor  # bool; False => IMU gate failed, model is identity


def default_bin_confidences(device, dtype=torch.float64):
    """Initial prior: 0.5 everywhere (reference pnp.h:158,199 static init)."""
    return torch.full((N_BINS,), 0.5, dtype=dtype, device=device)


def compute_bins(pts, norm_scale: float):
    """Bucket normalized points into the 20x20 grid (reference
    parsac.h:256-284): truncation toward zero, then the clip, as the JAX
    package casts. Returns (bin_idx (N,), bin_loc (400, 2) bin centres)."""
    w = 2.0 * norm_scale / N_BINS_X
    h = 2.0 * norm_scale / N_BINS_Y
    ix = torch.clamp(((pts[..., 0] + norm_scale) / w).to(torch.int32), 0, N_BINS_X - 1)
    iy = torch.clamp(((pts[..., 1] + norm_scale) / h).to(torch.int32), 0, N_BINS_Y - 1)
    bin_idx = (ix + N_BINS_X * iy).long()
    ar = lambda n: torch.arange(n, dtype=pts.dtype, device=pts.device)  # noqa: E731
    gx = (ar(N_BINS_X) + 0.5) * w - norm_scale
    gy = (ar(N_BINS_Y) + 0.5) * h - norm_scale
    locs = torch.stack(torch.meshgrid(gx, gy, indexing="xy"), dim=-1).reshape(-1, 2)
    return bin_idx, locs


def _bin_sum(values, bin_idx, valid):
    """Segment sum over the 400 bins along the last axis; values (..., N)."""
    v = torch.where(valid, values, torch.zeros((), dtype=values.dtype, device=values.device))
    out = torch.zeros(v.shape[:-1] + (N_BINS,), dtype=v.dtype, device=v.device)
    return out.index_add_(out.dim() - 1, bin_idx, v)


def _parsac_scores(inl, valid, bin_idx, bin_size, bin_loc, t_weight):
    """Coverage x confidence score per hypothesis (reference parsac.h:196-236).

    inl: (K, N) inlier masks. Returns (scores (K,), bin_conf (K, 400))."""
    dtype = bin_loc.dtype
    inl_per_bin = _bin_sum(inl.to(dtype), bin_idx, valid)  # (K, 400)
    size_safe = torch.clamp(bin_size, min=1.0)
    conf = t_weight[None, :] * inl_per_bin / size_safe[None, :]
    conf = torch.where(bin_size[None, :] > 0, conf, 0.0)  # only valid bins
    S = conf.sum(dim=-1)  # (K,)
    Q = (conf * conf).sum(dim=-1)
    S_safe = torch.clamp(S, min=1e-12)
    mean = (conf @ bin_loc) / S_safe[:, None]  # (K, 2)
    d = bin_loc[None, :, :] - mean[:, None, :]  # (K, 400, 2)
    Cxx = (conf * d[..., 0] * d[..., 0]).sum(dim=-1)
    Cxy = (conf * d[..., 0] * d[..., 1]).sum(dim=-1)
    Cyy = (conf * d[..., 1] * d[..., 1]).sum(dim=-1)
    norm = S / torch.clamp(S * S - Q, min=1e-12)
    img_ratio = norm * torch.sqrt(torch.clamp(Cxx * Cyy - Cxy * Cxy, min=0.0))
    return img_ratio * S, conf


def _sampling_logits(bin_idx, bin_size, bin_conf_prior):
    """Per-point logits reproducing bin-weighted sampling (reference
    parsac.h:103-126): the prior clamped to >= 0.5 on valid bins, then
    P(point) = conf[bin] / size[bin]. Uniform with <= 20 valid bins
    (reference parsac.h:121-125)."""
    valid_bin = bin_size > 0
    conf = torch.clamp(bin_conf_prior, min=MIN_PRIOR_BIN_CONFIDENCE)
    conf = torch.where(valid_bin, conf, 0.0)
    n_valid_bins = valid_bin.sum()
    point_logit = torch.log(torch.clamp(conf[bin_idx], min=1e-12)) - torch.log(
        torch.clamp(bin_size[bin_idx], min=1.0))
    return torch.where(n_valid_bins > 20, point_logit, torch.zeros_like(point_logit))


def _pick(x, i):
    """x[i] for a one-element index tensor i, without a host sync."""
    return x.index_select(0, i)[0]


def _run_parsac(gumbel, solver, evaluator, sample_size, pts_bucket, valid,
                threshold, bin_conf_prior, norm_scale, lens=None,
                dynamic_prob=0.0, prior_mask=None, identity_model=None):
    """Shared PARSAC / IMU-PARSAC core. gumbel: (K, N) noise; solver:
    idx (K, M) -> models (K, ...); evaluator: models -> errors (K, N)."""
    dtype = pts_bucket.dtype
    bin_idx, bin_loc = compute_bins(pts_bucket, norm_scale)
    bin_size = _bin_sum(torch.ones(valid.shape, dtype=dtype, device=valid.device),
                        bin_idx, valid)

    # track-length weighting (reference imu_parsac.h:233-237, 330-334)
    if lens is not None:
        bin_len = _bin_sum(lens.to(dtype), bin_idx, valid) / torch.clamp(bin_size, min=1.0)
        # the base made on the device (a fill, not a host copy)
        t_weight = 1.0 - torch.pow(
            torch.full((), dynamic_prob, dtype=dtype, device=valid.device), 0.10 * bin_len)
        t_weight = torch.where(bin_size > 0, t_weight, 0.0)
    else:
        t_weight = torch.ones((N_BINS,), dtype=dtype, device=valid.device)

    logits = _sampling_logits(bin_idx, bin_size, bin_conf_prior)
    idx = sample_indices(gumbel, valid, sample_size, logits=logits)
    models = solver(idx)
    errors = evaluator(models)  # (K, N)
    inl = (errors <= threshold) & valid[None, :]
    counts = inl.sum(dim=-1)
    scores, _ = _parsac_scores(inl, valid, bin_idx, bin_size, bin_loc, t_weight)

    if prior_mask is not None:
        # a candidate must overlap the IMU-prior inliers in >= sample_size
        # points (reference imu_parsac.h:109-119); ties break on overlap
        overlap = (inl & prior_mask[None, :]).sum(dim=-1)
        scores = torch.where(overlap >= sample_size, scores, float("-inf"))
        rank_count = overlap
    else:
        rank_count = counts

    # the first maximum wins, as jnp.argmax (all -inf: index 0)
    best = torch.argmax(scores + 1e-9 * rank_count.to(scores.dtype)).reshape(1)
    best_model = _pick(models, best)
    best_mask = _pick(inl, best)
    best_count = _pick(rank_count, best)
    best_score = _pick(scores, best)

    # posterior bin confidences of the winning model (reference parsac.h:164-168)
    _, conf_all = _parsac_scores(best_mask[None, :], valid, bin_idx, bin_size,
                                 bin_loc, t_weight)
    new_bin_conf = conf_all[0]

    prior_ok = torch.ones((), dtype=torch.bool, device=valid.device)
    if prior_mask is not None:
        # final fallback (reference imu_parsac.h:146-149): too few overlap
        # inliers => identity model + all-inliers, prior confidences kept
        failed = best_count < sample_size
        best_model = torch.where(failed, identity_model, best_model)
        best_mask = torch.where(failed, valid, best_mask)
        new_bin_conf = torch.where(failed, bin_conf_prior, new_bin_conf)
        prior_ok = ~failed

    return ParsacResult(model=best_model, inlier_mask=best_mask,
                        inlier_count=best_count, best_score=best_score,
                        bin_confidences=new_bin_conf, prior_ok=prior_ok)


def _essential_errors(p1, p2):
    def evaluator(E):
        return epipolar.essential_geometric_error(E, p1[None], p2[None]) + \
            epipolar.essential_geometric_error(E.transpose(-1, -2), p2[None], p1[None])
    return evaluator


def _pnp_solver(x_world, p_norm):
    def solver(idx):
        R, t = pnp.solve_pnp_dlt(x_world[idx], p_norm[idx])
        return torch.cat([R, t[..., None]], dim=-1)
    return solver


def _pnp_errors(x_world, p_norm):
    def evaluator(models):
        err = pnp.pnp_reprojection_error(models[..., :3], models[..., 3],
                                         x_world[None], p_norm[None])
        return torch.where(torch.isfinite(err), err, 1e18)
    return evaluator


def parsac_essential(gumbel, p1, p2, valid, bin_conf_prior, threshold: float,
                     norm_scale: float = 1.0):
    """find_essential_matrix_parsac (reference stereo.cpp:124-160): buckets
    p2, symmetric epipolar error, inlier bound 2*t1*threshold^2.
    gumbel: (K, N) noise, one row per hypothesis."""
    def solver(idx):
        return epipolar.solve_essential_8pt(p1[idx], p2[idx])

    return _run_parsac(gumbel, solver, _essential_errors(p1, p2), ESSENTIAL_SAMPLE,
                       p2, valid, 2.0 * CHI2_1DOF * threshold ** 2, bin_conf_prior,
                       norm_scale)


def parsac_pnp(gumbel, x_world, p_norm, valid, bin_conf_prior, threshold: float,
               norm_scale: float = 1.0):
    """find_pnp_matrix_parsac (reference pnp.h:133-162). Model (3, 4) [R|t]
    world-to-camera; buckets the 2D observations."""
    return _run_parsac(gumbel, _pnp_solver(x_world, p_norm), _pnp_errors(x_world, p_norm),
                       PNP_SAMPLE, p_norm, valid, 2.0 * CHI2_2DOF * threshold ** 2,
                       bin_conf_prior, norm_scale)


def imu_parsac_pnp(gumbel, x_world, p_norm, valid, lens, prior_R, prior_t,
                   bin_conf_prior, threshold: float, dynamic_prob: float,
                   norm_scale: float = 1.0):
    """find_pnp_matrix_parsac_imu (reference pnp.h:164-203 + imu_parsac.h):
    the RD-VIO static/dynamic classifier.

    The IMU-predicted pose (prior_R, prior_t) gates everything: its inliers
    at 2x the threshold form the prior distribution; if fewer than 15% / 20
    points agree with it, the result is the identity model with every valid
    point an inlier and the prior confidences kept (imu_parsac.h:170-198).
    Candidates count only through their overlap with the prior inliers.
    The returned inlier_mask is the static/dynamic labeling."""
    thr = 2.0 * CHI2_2DOF * threshold ** 2
    prior_err = pnp.pnp_reprojection_error(prior_R, prior_t, x_world, p_norm)
    prior_err = torch.where(torch.isfinite(prior_err), prior_err, 1e18)
    prior_mask = (prior_err <= 2.0 * thr) & valid
    prior_count = prior_mask.sum()
    n_valid = torch.clamp(valid.sum(), min=1)
    prior_gate_ok = ((prior_count.to(torch.float64) / n_valid >= 0.15)
                     & (prior_count >= 20))

    dt, dev = x_world.dtype, x_world.device
    identity_model = torch.cat([torch.eye(3, dtype=dt, device=dev),
                                torch.zeros((3, 1), dtype=dt, device=dev)], dim=-1)
    res = _run_parsac(gumbel, _pnp_solver(x_world, p_norm), _pnp_errors(x_world, p_norm),
                      PNP_SAMPLE, p_norm, valid, thr, bin_conf_prior, norm_scale,
                      lens=lens, dynamic_prob=dynamic_prob, prior_mask=prior_mask,
                      identity_model=identity_model)

    # IMU gate failure overrides everything (reference imu_parsac.h:66-69)
    return ParsacResult(
        model=torch.where(prior_gate_ok, res.model, identity_model),
        inlier_mask=torch.where(prior_gate_ok, res.inlier_mask, valid),
        inlier_count=torch.where(prior_gate_ok, res.inlier_count, valid.sum()),
        best_score=res.best_score,
        bin_confidences=torch.where(prior_gate_ok, res.bin_confidences, bin_conf_prior),
        prior_ok=prior_gate_ok & res.prior_ok,
    )


def parsac_essential_chain(gumbel, p1, p2, valid, enable, bin_conf_prior, threshold,
                           norm_scale: float = 1.0):
    """K sequential 2D-2D PARSAC checks, each consuming the bin confidences
    the previous one produced (reference sliding_window_tracker.cpp:720-769;
    a `lax.scan` in the JAX package, a loop over the K rows here, with the
    carry on the device and no host read inside).

    gumbel: (K, H, N) noise, one (H, N) block per check; p1, p2: (K, N, 2);
    valid: (K, N) bool; enable: (K,) bool — a disabled check passes its
    carry through unchanged (the host `continue`). Returns (masks (K, N)
    bool, final bin confidences (400,))."""
    conf = bin_conf_prior
    masks = []
    for k in range(p1.shape[0]):
        res = parsac_essential(gumbel[k], p1[k], p2[k], valid[k], conf, threshold,
                               norm_scale=norm_scale)
        conf = torch.where(enable[k], res.bin_confidences, conf)
        masks.append(res.inlier_mask & valid[k])
    return torch.stack(masks), conf
