"""Port parity of the device PARSAC and what it rests on: `pnp` (the DLT,
its Gauss-Newton polish), `ransac.ransac_pnp`, `parsac` (`parsac_essential`,
`parsac_pnp`, `imu_parsac_pnp` in its three outcomes, the chained 2D-2D
check), the host 5-point solver `essential5` and the standalone mask
program `frontend_step.ft_step`.

Inputs are seeded NumPy scenes (`synthetic_problems.pnp_scene` and two-view
scenes with mismatches and invalid slots); every random draw is the JAX
package's own: the port is handed the `jax.random.gumbel` noise of the key
the JAX call consumes (split per row for the chain, as its scan splits).
Everything runs in f64 as the tracker runs it (x64 is on in the JAX
package), but the Gumbel noise (f32) and `ft_step` (f32).
"""

import numpy as np
import jax
import jax.numpy as jnp

from rd_vio_tpu.ops import epipolar as epi_j
from rd_vio_tpu.ops import essential5 as e5_j
from rd_vio_tpu.ops import frontend_step as fs_j
from rd_vio_tpu.ops import parsac as parsac_j
from rd_vio_tpu.ops import pnp as pnp_j
from rd_vio_tpu.ops import ransac as ransac_j
from rd_vio_tpu.ops.frontend_step_np import _rng_from_key
from tests.test_torch_image import IN_CHILD, child  # noqa: F401

if IN_CHILD:  # the port loads only where the checks run (test_torch_image)
    import torch

    from rd_vio_tpu_torch import convert
    from rd_vio_tpu_torch.datasets.synthetic_problems import pnp_scene
    from rd_vio_tpu_torch.ops import epipolar as epi_t
    from rd_vio_tpu_torch.ops import essential5 as e5_t
    from rd_vio_tpu_torch.ops import frontend_step as fs_t
    from rd_vio_tpu_torch.ops import parsac as parsac_t
    from rd_vio_tpu_torch.ops import pnp as pnp_t
    from rd_vio_tpu_torch.ops import ransac as ransac_t

K_HYP = 32  # Config.parsac_judge_hypotheses
THR = 1.0 / 460.0  # parsac_threshold over the focal length, as the tracker passes it
# winning models, the DLT's and the polish's R and t (f64): within 1e-9 of
# their scale (max(1, largest entry); t is ~5 m here)
MODEL_TOL = 1e-9
# the DLT of a minimal six-point sample: its 12x12 normal matrix has one
# null vector and a second eigenvalue that the sample's geometry may put
# near it; over 32 samples the two libraries' eigh gave R and t 1e-14 to
# 4.1e-8 apart (scaled as above). Twelve-point samples are held at MODEL_TOL
MINIMAL_TOL = 1e-7
CONF_RTOL = 1e-12  # bin confidences, relative to their largest


def _t(a):
    return torch.from_numpy(np.array(a))


def _gumbel(key, shape):
    return np.array(jax.random.gumbel(key, shape, jnp.float32))


def _two_view(seed, n=128, outliers=0.2):
    """Normalized points of n points seen from two poses, mismatches and
    invalid (zero) slots (f64)."""
    rng = np.random.default_rng(seed)
    X = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n), rng.uniform(3, 8, n)], -1)
    from scipy.spatial.transform import Rotation

    X2 = X @ Rotation.from_rotvec([0.02, 0.06, -0.01]).as_matrix().T + [0.3, 0.05, 0.02]
    p1 = X[:, :2] / X[:, 2:]
    p2 = X2[:, :2] / X2[:, 2:] + rng.normal(0, 5e-4, (n, 2))
    bad = rng.uniform(size=n) < outliers
    p2[bad] += rng.normal(0, 0.05, (int(bad.sum()), 2))
    valid = rng.uniform(size=n) > 0.1
    p1[~valid], p2[~valid] = 0.0, 0.0
    return p1, p2, valid


def _close(a, b, tol=MODEL_TOL):
    a, b = np.asarray(a), np.asarray(b)
    np.testing.assert_allclose(a, b, rtol=0, atol=tol * max(1.0, np.abs(b).max()))


def _same_up_to_sign(a, b, tol):
    flip = np.sign(np.sum(a * b))
    return np.abs(a - flip * b).max() <= tol * max(1.0, np.abs(b).max())


def _assert_parsac_equal(rj, rt, model_up_to_sign=False):
    """Masks, inlier counts and prior_ok equal; the model within MODEL_TOL;
    the bin confidences within CONF_RTOL of their largest."""
    j = convert.parsac_result_np(rj)
    t = convert.parsac_result_np(rt)
    np.testing.assert_array_equal(t["inlier_mask"], j["inlier_mask"])
    assert int(t["inlier_count"]) == int(j["inlier_count"])
    assert bool(t["prior_ok"]) == bool(j["prior_ok"])
    if model_up_to_sign:
        assert _same_up_to_sign(t["model"], j["model"], MODEL_TOL)
    else:
        _close(t["model"], j["model"])
    scale = max(np.abs(j["bin_confidences"]).max(), 1e-300)
    np.testing.assert_allclose(t["bin_confidences"], j["bin_confidences"], rtol=0,
                               atol=CONF_RTOL * scale)
    return t


def _check_pnp():
    """DLT on 16 twelve-point samples (R and t within MODEL_TOL) and 16
    six-point ones (MINIMAL_TOL); the 5-step polish from perturbed starts
    (MODEL_TOL); ransac_pnp on the JAX key's noise: masks and counts equal."""
    sc = pnp_scene(1, outliers=0.0, invalid=0.0)
    rng = np.random.default_rng(2)
    X, p = sc["x_world"], sc["p_norm"]
    for m, tol in ((12, MODEL_TOL), (6, MINIMAL_TOL)):
        idx = np.stack([rng.choice(len(sc["valid"]), m, replace=False) for _ in range(16)])
        Rj, tj = pnp_j.solve_pnp_dlt(jnp.asarray(X[idx]), jnp.asarray(p[idx]))
        Rt, tt = pnp_t.solve_pnp_dlt(_t(X[idx]), _t(p[idx]))
        _close(Rt.numpy(), Rj, tol)
        _close(tt.numpy(), tj, tol)
        # real poses, not noise (a noisy minimal sample may be far off)
        assert np.median(np.abs(Rt.numpy() - sc["R_cw"]).max(axis=(1, 2))) < 0.05

    from scipy.spatial.transform import Rotation

    R0 = sc["R_cw"] @ Rotation.from_rotvec(rng.normal(0, 0.02, (16, 3))).as_matrix()
    t0 = sc["t_cw"] + rng.normal(0, 0.05, (16, 3))
    Rj2, tj2 = pnp_j.refine_pnp(jnp.asarray(R0), jnp.asarray(t0), jnp.asarray(X),
                                jnp.asarray(p))
    Rt2, tt2 = pnp_t.refine_pnp(_t(R0), _t(t0), _t(X), _t(p))
    _close(Rt2.numpy(), Rj2)
    _close(tt2.numpy(), tj2)
    ej = pnp_j.pnp_reprojection_error(Rj2, tj2, jnp.asarray(X), jnp.asarray(p))
    et = pnp_t.pnp_reprojection_error(Rt2, tt2, _t(X), _t(p))
    np.testing.assert_allclose(et.numpy(), np.asarray(ej), rtol=1e-9, atol=1e-18)

    sc = pnp_scene(3)
    key = jax.random.PRNGKey(3)
    rj = ransac_j.ransac_pnp(key, jnp.asarray(sc["x_world"]), jnp.asarray(sc["p_norm"]),
                             jnp.asarray(sc["valid"]), THR, K_HYP)
    rt = ransac_t.ransac_pnp(_t(_gumbel(key, (K_HYP, len(sc["valid"])))), _t(sc["x_world"]),
                             _t(sc["p_norm"]), _t(sc["valid"]), THR)
    np.testing.assert_array_equal(rt.inlier_mask.numpy(), np.asarray(rj.inlier_mask))
    assert int(rt.inlier_count) == int(rj.inlier_count) > 0.5 * sc["valid"].sum()


def _check_parsac(seed):
    """parsac_essential (E up to sign) and parsac_pnp from a random prior:
    see _assert_parsac_equal."""
    rng = np.random.default_rng(seed)
    prior = rng.uniform(0.0, 1.0, parsac_j.N_BINS)
    key = jax.random.PRNGKey(seed)
    p1, p2, valid = _two_view(seed)
    rj = parsac_j.parsac_essential(key, jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(valid),
                                   jnp.asarray(prior), 3e-3, num_hypotheses=K_HYP)
    rt = parsac_t.parsac_essential(_t(_gumbel(key, (K_HYP, len(valid)))), _t(p1), _t(p2),
                                   _t(valid), convert.bin_confidences_from(prior, "cpu"), 3e-3)
    t = _assert_parsac_equal(rj, rt, model_up_to_sign=True)
    assert int(t["inlier_count"]) > 0.2 * valid.sum()  # a model, not an empty mask

    sc = pnp_scene(seed)
    n = len(sc["valid"])
    rj = parsac_j.parsac_pnp(key, jnp.asarray(sc["x_world"]), jnp.asarray(sc["p_norm"]),
                             jnp.asarray(sc["valid"]), jnp.asarray(prior), THR,
                             num_hypotheses=K_HYP)
    rt = parsac_t.parsac_pnp(_t(_gumbel(key, (K_HYP, n))), _t(sc["x_world"]),
                             _t(sc["p_norm"]), _t(sc["valid"]),
                             convert.bin_confidences_from(prior, "cpu"), THR)
    t = _assert_parsac_equal(rj, rt)
    assert int(t["inlier_count"]) > 0.5 * sc["valid"].sum()


# (case, scene seed, scene arguments, the IMU prior's offset from the true
# static pose): the gate passes; the prior is 0.5 m off, so < 15% agree; a
# static minority (the prior's inliers, >= 20 and >= 15%) that no hypothesis
# drawn from 8 overlaps in >= 6 points (the final fallback)
IMU_CASES = (
    ("gate passed", 4, dict(), 0.0, 32),
    ("gate failed", 5, dict(), 0.5, 32),
    ("overlap fallback", 6, dict(dynamic=0.72, outliers=0.0, n=192), 0.0, 8),
)


def _check_imu_parsac(case, seed, scene_kw, offset, k_hyp):
    sc = pnp_scene(seed, **scene_kw)
    n = len(sc["valid"])
    rng = np.random.default_rng(seed)
    prior = rng.uniform(0.0, 1.0, parsac_j.N_BINS)
    t_prior = sc["t_cw"] + np.array([offset, 0.0, 0.0])
    key = jax.random.PRNGKey(100 + seed)
    args = (sc["x_world"], sc["p_norm"], sc["valid"], sc["lens"], sc["R_cw"], t_prior, prior)
    rj = parsac_j.imu_parsac_pnp(key, *map(jnp.asarray, args), threshold=THR,
                                 dynamic_prob=0.15, num_hypotheses=k_hyp)
    rt = parsac_t.imu_parsac_pnp(_t(_gumbel(key, (k_hyp, n))), *map(_t, args[:-1]),
                                 convert.bin_confidences_from(prior, "cpu"),
                                 threshold=THR, dynamic_prob=0.15)
    t = _assert_parsac_equal(rj, rt)
    valid = sc["valid"]
    prior_in = (np.asarray(pnp_j.pnp_reprojection_error(
        jnp.asarray(sc["R_cw"]), jnp.asarray(t_prior), jnp.asarray(sc["x_world"]),
        jnp.asarray(sc["p_norm"]))) <= 4 * 5.99 * THR ** 2) & valid
    gate = prior_in.sum() >= 20 and prior_in.sum() >= 0.15 * valid.sum()
    identity = np.concatenate([np.eye(3), np.zeros((3, 1))], -1)
    # each case reaches the branch it is named for
    if case == "gate passed":
        assert gate and t["prior_ok"] and t["inlier_count"] > 0.5 * valid.sum(), case
    else:
        assert gate == (case == "overlap fallback") and not t["prior_ok"], case
        np.testing.assert_array_equal(t["model"], identity)
        np.testing.assert_array_equal(t["inlier_mask"], valid)
        np.testing.assert_array_equal(t["bin_confidences"], prior)


def _check_chain():
    """Three chained 2D-2D checks, the second disabled: the masks equal,
    the carried confidences within CONF_RTOL."""
    rows = [_two_view(20 + k, n=96) for k in range(3)]
    p1, p2, valid = (np.stack([r[i] for r in rows]) for i in range(3))
    enable = np.array([True, False, True])
    prior = np.full(parsac_j.N_BINS, 0.5)
    key = jax.random.PRNGKey(21)
    mj, cj = parsac_j.parsac_essential_chain(
        key, jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(valid), jnp.asarray(enable),
        jnp.asarray(prior), 3e-3, num_hypotheses=K_HYP)
    g = np.stack([_gumbel(k, (K_HYP, 96)) for k in jax.random.split(key, 3)])
    mt, ct = parsac_t.parsac_essential_chain(
        _t(g), _t(p1), _t(p2), _t(valid), _t(enable),
        convert.bin_confidences_from(prior, "cpu"), 3e-3)
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    cj = np.asarray(cj)
    np.testing.assert_allclose(ct.numpy(), cj, rtol=0, atol=CONF_RTOL * np.abs(cj).max())
    assert mt.numpy()[0].sum() > 0.5 * valid[0].sum()
    # the disabled row passed the carry through: row 2 alone from row 0's
    # confidences gives the same result
    r0 = parsac_t.parsac_essential(_t(g[0]), _t(p1[0]), _t(p2[0]), _t(valid[0]),
                                   convert.bin_confidences_from(prior, "cpu"), 3e-3)
    r2 = parsac_t.parsac_essential(_t(g[2]), _t(p1[2]), _t(p2[2]), _t(valid[2]),
                                   r0.bin_confidences, 3e-3)
    assert torch.equal(r2.bin_confidences, ct)


def _check_essential5():
    """The 5-point solver (a NumPy copy): the same candidate set within
    1e-9 on five exact correspondences; the 5-point RANSAC with the same
    generator: the same E within 1e-9 and the same mask."""
    p1, p2, valid = _two_view(30, outliers=0.0)
    sel = np.flatnonzero(valid)[:5]
    cj = e5_j.solve_essential_5pt(p1[sel], p2[sel])
    ct = e5_t.solve_essential_5pt(p1[sel], p2[sel])
    assert len(cj) == len(ct) >= 1
    for E in cj:
        assert min(min(np.abs(E - F).max(), np.abs(E + F).max()) for F in ct) <= 1e-9
    p1, p2, valid = _two_view(31)
    key = jax.random.PRNGKey(31)
    Ej, mj = e5_j.ransac_essential_5pt(_rng_from_key(key), p1, p2, valid, 3e-3, 16)
    Et, mt = e5_t.ransac_essential_5pt(_rng_from_key(key), p1, p2, valid, 3e-3, 16)
    np.testing.assert_allclose(Et, Ej, rtol=0, atol=1e-9)
    np.testing.assert_array_equal(mt, mj)
    assert mt.sum() > 0.5 * valid.sum()
    # and the essential helpers the tracker's epipolar check uses
    from scipy.spatial.transform import Rotation

    R = Rotation.from_rotvec([0.02, 0.06, -0.01]).as_matrix()
    Ej = np.asarray(epi_j.essential_from_pose(jnp.asarray(R), jnp.asarray([0.3, 0.05, 0.02])))
    Et = epi_t.essential_from_pose(_t(R), _t([0.3, 0.05, 0.02])).numpy()
    np.testing.assert_allclose(Et, Ej, rtol=0, atol=1e-15)
    sj = epi_j.essential_geometric_error_sym(jnp.asarray(Ej), jnp.asarray(p1), jnp.asarray(p2))
    st = epi_t.essential_geometric_error_sym(_t(Ej), _t(p1), _t(p2))
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=1e-12, atol=1e-30)


def _check_ft_step():
    """The standalone f32 mask program on the JAX key's noise: the masks
    equal, the misalignment within 1e-3 degrees."""
    rng = np.random.default_rng(40)
    n = 384
    X = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n), rng.uniform(3, 8, n)], -1)
    X2 = X + np.array([0.2, 0.0, 0.05])
    b1 = (X / np.linalg.norm(X, axis=-1, keepdims=True)).astype(np.float32)
    b2 = X2 / np.linalg.norm(X2, axis=-1, keepdims=True)
    bad = rng.uniform(size=n) < 0.2
    b2[bad] += rng.normal(0, 0.3, (int(bad.sum()), 3))
    b2 = (b2 / np.linalg.norm(b2, axis=-1, keepdims=True)).astype(np.float32)
    valid = rng.uniform(size=n) > 0.2
    key = jax.random.PRNGKey(40)
    thr = np.float32(np.radians(10.0))
    oj = fs_j.ft_step(jnp.asarray(b1), jnp.asarray(b2), jnp.asarray(valid), key, thr,
                      num_hypotheses=128)
    k1, k2 = jax.random.split(key)
    ot = fs_t.ft_step(_t(b1), _t(b2), _t(valid),
                      (_t(_gumbel(k1, (128, n))), _t(_gumbel(k2, (128, n)))), float(thr))
    np.testing.assert_array_equal(ot["mask"].numpy(), np.asarray(oj["mask"]))
    assert abs(float(oj["misalign"]) - float(ot["misalign"])) <= 1e-3
    assert ot["mask"].numpy().sum() > 0.5 * valid.sum()


def test_parsac_matches_jax(child):
    child(_check_pnp)
    for seed in (7, 8):
        child(_check_parsac, seed)
    for case in IMU_CASES:
        child(_check_imu_parsac, *case)
    child(_check_chain)
    child(_check_essential5)
    child(_check_ft_step)
