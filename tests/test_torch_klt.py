"""Port parity of the pyramidal LK tracker.

The port's plain level (`klt.lk_level_plain`, which the kernel wrapper
`klt.lk_level` runs for CPU tensors) against the JAX package's XLA level
(`klt._lk_level_windowed`) and its Pallas kernel in interpret mode
(`klt_pallas.lk_level_pallas(interpret=True)`), then the whole forward +
reverse tracker. Tolerances: status agreement >= 0.995 and median flow
difference <= 1e-4 px on agreed tracks (f32 matmul and sum order).

`klt.lk_track_fwd_rev_plain`, the plain version of the fused kernel, is also
held against the JAX `klt.lk_track_fwd_rev` on a keypoint set built to trip
every status rule (tools/lk_bench.edge_case_keypoints): status exactly
equal, tracked positions within 1e-3 px where both track. The wrapper
`klt.lk_track_fwd_rev` on CPU tensors is that plain version bit for bit.

The CUDA kernels themselves need a card: tests/test_torch_cuda.py (marked
`cuda`, skipped without one) and chip_smoke.py phase A compare it with the
plain level there.
"""

import functools

import numpy as np
import jax.numpy as jnp
import pytest

from rd_vio_tpu.ops.image import gftt as gftt_j
from rd_vio_tpu.ops.image import klt as klt_j
from rd_vio_tpu.ops.image import klt_pallas as klp_j
from rd_vio_tpu.ops.image import pyramid as pyr_j
from tests.test_torch_image import IN_CHILD, child, rendered_frames  # noqa: F401

if IN_CHILD:  # the port loads only where the checks run (test_torch_image)
    import torch

    from rd_vio_tpu_torch.ops.image import klt as klt_t
    from rd_vio_tpu_torch.ops.image import pyramid as pyr_t
    from rd_vio_tpu_torch.tools import lk_bench

N = 64


@functools.cache
def _pair():
    """Two consecutive rendered 320x240 frames and N GFTT keypoints of the
    first, with a perturbed initial guess."""
    _, _, frames = rendered_frames(3)
    a, b = frames[0].astype(np.float32), frames[2].astype(np.float32)
    pix, val, _ = gftt_j.detect_gftt(
        jnp.asarray(a), jnp.zeros((1, 2), jnp.float32), jnp.zeros(1, bool),
        max_points=N, min_dist=10.0)
    pts = np.asarray(pix)
    valid = np.asarray(val).copy()
    valid[-4:] = False  # some invalid slots
    rng = np.random.default_rng(1)
    guess = (pts + rng.normal(0, 1.5, pts.shape)).astype(np.float32)
    return a, b, pts.astype(np.float32), guess, valid


def _agree(st_a, st_b, tr_a, tr_b):
    st_a, st_b = np.asarray(st_a), np.asarray(st_b)
    both = st_a & st_b
    d = np.linalg.norm(np.asarray(tr_a)[both] - np.asarray(tr_b)[both], axis=-1)
    return (st_a == st_b).mean(), (np.median(d) if len(d) else 0.0), both.sum()


def _level_inputs(L):
    a, b, pts, guess, valid = _pair()
    pj_a = pyr_j.build_pyramid(jnp.asarray(a), 3)[L]
    pj_b = pyr_j.build_pyramid(jnp.asarray(b), 3)[L]
    s = 2.0 ** L
    p = pts / s + klt_j.PADB
    g = guess / s + klt_j.PADB
    return np.array(pj_a), np.array(pj_b), p.astype(np.float32), \
        g.astype(np.float32), valid


def _check_level_xla(L):
    a, b, p, g, valid = _level_inputs(L)
    pad = lambda x: jnp.pad(jnp.asarray(x), klt_j.PADB, mode="edge")  # noqa: E731
    tr_j, me_j = klt_j._lk_level_windowed(
        pad(a), pad(b), jnp.asarray(p), jnp.asarray(g), jnp.asarray(valid),
        30, 0.01)
    tr_t, me_t = klt_t.lk_level(
        torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(p),
        torch.from_numpy(g), torch.from_numpy(valid), 30, 0.01)
    ok_j = valid & (np.asarray(me_j) > 1e-4)
    ok_t = valid & (me_t.numpy() > 1e-4)
    agree, med, n = _agree(ok_j, ok_t, tr_j, tr_t.numpy())
    assert agree >= 0.995 and n > 30
    assert med <= 1e-4, med
    np.testing.assert_allclose(me_t.numpy(), np.asarray(me_j), rtol=1e-3, atol=1e-6)


def _check_level_pallas_interpret():
    a, b, p, g, valid = _level_inputs(1)
    pad = lambda x: jnp.pad(jnp.asarray(x), klt_j.PADB, mode="edge")  # noqa: E731
    out = np.asarray(klp_j.lk_level_pallas(
        pad(a), pad(b), jnp.asarray(p), jnp.asarray(g), jnp.asarray(valid),
        iters=30, eps=0.01, interpret=True))
    tr_t, me_t = klt_t.lk_level(
        torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(p),
        torch.from_numpy(g), torch.from_numpy(valid), 30, 0.01)
    ok_t = valid & (me_t.numpy() > 1e-4)
    agree, med, n = _agree(out[:, 3] > 0, ok_t, out[:, :2], tr_t.numpy())
    assert agree >= 0.995 and n > 30
    assert med <= 1e-4, med


def _check_fwd_rev():
    a, b, pts, guess, valid = _pair()
    pj_a = pyr_j.build_pyramid(jnp.asarray(a), 3)
    pj_b = pyr_j.build_pyramid(jnp.asarray(b), 3)
    tr_j, st_j = klt_j.lk_track_fwd_rev(
        pj_a, pj_b, jnp.asarray(pts), jnp.asarray(guess), jnp.asarray(valid))
    pt_a = pyr_t.build_pyramid(torch.from_numpy(a), 3)
    pt_b = pyr_t.build_pyramid(torch.from_numpy(b), 3)
    tr_t, st_t = klt_t.lk_track_fwd_rev(
        pt_a, pt_b, torch.from_numpy(pts), torch.from_numpy(guess),
        torch.from_numpy(valid))
    agree, med, n = _agree(st_j, st_t.numpy(), tr_j, tr_t.numpy())
    assert agree >= 0.995 and n > 30
    assert med <= 1e-4, med


def _check_wrapper_cpu():
    # on CPU tensors lk_level is lk_level_plain and launches nothing; on a
    # device it does not support it raises instead of falling back
    a, b, p, g, valid = _level_inputs(3)
    args = [torch.from_numpy(x) for x in (a, b, p, g, valid)]
    before = klt_t.launches
    tr1, me1 = klt_t.lk_level(*args)
    tr2, me2 = klt_t.lk_level_plain(*args)
    assert torch.equal(tr1, tr2) and torch.equal(me1, me2)
    assert klt_t.launches == before
    with pytest.raises(ValueError):
        klt_t.lk_level(*[x.to("meta") for x in args])


FLAT = (90, 150, 130, 190)  # y0, y1, x0, x1 of the painted flat patch


@functools.cache
def _edge_case_inputs():
    """The rendered 320x240 pair with a flat patch painted into both frames,
    both pyramids from the JAX package (so the two trackers see the same
    pixels), and N keypoints: 6 of each edge-case kind among GFTT corners."""
    a, b = _pair()[:2]
    a = lk_bench.paint_flat_patch(a, FLAT)
    b = lk_bench.paint_flat_patch(b, FLAT)
    pix, val, _ = gftt_j.detect_gftt(
        jnp.asarray(a), jnp.zeros((1, 2), jnp.float32), jnp.zeros(1, bool),
        max_points=N, min_dist=10.0)
    good = np.asarray(pix)[np.asarray(val)]
    pts, pred, valid, kind = lk_bench.edge_case_keypoints(
        good, N, 240, 320, FLAT, seed=2, per_kind=6)
    pj_a = pyr_j.build_pyramid(jnp.asarray(a), 3)
    pj_b = pyr_j.build_pyramid(jnp.asarray(b), 3)
    return pj_a, pj_b, pts, pred, valid, kind


def _torch_pyramid(pyr):
    return [torch.from_numpy(np.array(x)) for x in pyr]


def _check_fwd_rev_edge_cases():
    pj_a, pj_b, pts, pred, valid, kind = _edge_case_inputs()
    assert len(pj_a) == 4 and len(pts) == 64
    tr_j, st_j = klt_j.lk_track_fwd_rev(
        pj_a, pj_b, jnp.asarray(pts), jnp.asarray(pred), jnp.asarray(valid))
    tr_t, st_t = klt_t.lk_track_fwd_rev_plain(
        _torch_pyramid(pj_a), _torch_pyramid(pj_b), torch.from_numpy(pts),
        torch.from_numpy(pred), torch.from_numpy(valid))
    st_j, st_t = np.asarray(st_j), st_t.numpy()
    # tolerance 1: the status is EXACTLY equal on every slot
    np.testing.assert_array_equal(st_t, st_j)
    # every edge case is rejected, and most ordinary points are tracked
    assert not st_t[kind >= 0].any()
    assert st_t[kind < 0].sum() > 20
    # tolerance 2: tracked positions within 1e-3 px where both track (f32
    # matmul and sum order differ between the two libraries)
    d = np.linalg.norm(np.asarray(tr_j)[st_t] - tr_t.numpy()[st_t], axis=-1)
    assert d.max() <= 1e-3, d.max()


def _check_fwd_rev_wrapper_cpu():
    # on CPU tensors the fused wrapper is its plain version bit for bit and
    # launches nothing; a pyramid the kernel's struct cannot hold, unequal
    # pyramids and an unsupported device raise
    pj_a, pj_b, pts, pred, valid, _ = _edge_case_inputs()
    args = (_torch_pyramid(pj_a), _torch_pyramid(pj_b), torch.from_numpy(pts),
            torch.from_numpy(pred), torch.from_numpy(valid))
    before = klt_t.launches, klt_t.fwd_rev_launches
    tr1, st1 = klt_t.lk_track_fwd_rev(*args)
    tr2, st2 = klt_t.lk_track_fwd_rev_plain(*args)
    assert torch.equal(st1, st2)
    assert torch.equal(tr1.nan_to_num(nan=-7.0), tr2.nan_to_num(nan=-7.0))
    assert tr1.dtype == torch.float32 and st1.dtype == torch.bool
    assert (klt_t.launches, klt_t.fwd_rev_launches) == before
    with pytest.raises(ValueError):
        klt_t.lk_track_fwd_rev(args[0], args[1][:3], *args[2:])
    with pytest.raises(ValueError):
        klt_t.lk_track_fwd_rev(*[[x.to("meta") for x in p] for p in args[:2]],
                               *[x.to("meta") for x in args[2:]])
    # the iteration count of the level wrapper: 0 for invalid slots, at
    # least 1 and at most `iters` for valid ones
    a, b, p, g, v = _level_inputs(0)
    _, _, n_it = klt_t.lk_level_iters(*[torch.from_numpy(x) for x in (a, b, p, g, v)])
    assert n_it.dtype == torch.int32
    assert (n_it[~torch.from_numpy(v)] == 0).all()
    assert (n_it[torch.from_numpy(v)] >= 1).all() and n_it.max() <= 30


def test_fwd_rev_plain_matches_jax_on_edge_cases(child):
    child(_check_fwd_rev_edge_cases)


def test_fwd_rev_wrapper_on_cpu_is_plain(child):
    child(_check_fwd_rev_wrapper_cpu)


def test_lk_matches_jax(child):
    for L in (0, 2):
        child(_check_level_xla, L)
    child(_check_level_pallas_interpret)
    child(_check_fwd_rev)
    child(_check_wrapper_cpu)
