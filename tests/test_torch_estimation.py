"""Port parity of the estimator core: Lie ops, window state, preintegration,
triangulation, the factor residuals, the linearization and normal system of
the window VI-BA, its LM solve in f64 and f32, the Cholesky-failure step and
frame-0 marginalization.

The same problem goes to both packages: the JAX package builds it, and
`rd_vio_tpu_torch.convert` carries it into the port (NumPy arrays, dtypes
kept). The port runs on the CPU. Sizes are those of the JAX package's entry
point (`__graft_entry__._build_problem`: W=6, L=64, O=256); of the large JAX
programs the checks compile one for the whole linearization, one `solve_ba`
per dtype and one `marginalize_frame0`. The JAX package's problem and its
outputs of those programs (`_jax_window_problem`, `_jax_estimator_outputs`)
come from the child, or from their stored outputs (tests/torch_ref,
`jax_ref`, keyed by the inputs they were given). The tolerance of each
comparison stands beside it; "relative" means relative to the largest
magnitude of the reference array.
"""

import functools
import types

import numpy as np

from rd_vio_tpu.datasets import synthetic as synth_j
from tests.test_torch_image import IN_CHILD, child, jax_ref  # noqa: F401

if IN_CHILD:  # the port loads only where the checks run (test_torch_image)
    import jax
    import jax.numpy as jnp
    import torch

    from rd_vio_tpu.datasets import synthetic_problems as sp_j
    from rd_vio_tpu.estimation import ba as ba_j
    from rd_vio_tpu.estimation import factors as F_j
    from rd_vio_tpu.estimation import marginalization as mg_j
    from rd_vio_tpu.estimation import state as st_j
    from rd_vio_tpu.models.builders import _cast_floats
    from rd_vio_tpu.ops import lie as lie_j
    from rd_vio_tpu.ops import preintegration as pre_j
    from rd_vio_tpu.ops import triangulate as tri_j
    from rd_vio_tpu_torch import convert
    from rd_vio_tpu_torch.datasets import synthetic as synth_t
    from rd_vio_tpu_torch.datasets import synthetic_problems as sp_t
    from rd_vio_tpu_torch.estimation import ba as ba_t
    from rd_vio_tpu_torch.estimation import factors as F_t
    from rd_vio_tpu_torch.estimation import marginalization as mg_t
    from rd_vio_tpu_torch.estimation import state as st_t
    from rd_vio_tpu_torch.models.builders import cast_floats
    from rd_vio_tpu_torch.ops import lie as lie_t
    from rd_vio_tpu_torch.ops import preintegration as pre_t
    from rd_vio_tpu_torch.ops import triangulate as tri_t

W = 6
ES = 15


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def close(port, ref, rel, what=""):
    """|port - ref| <= rel * max|ref| elementwise (and equal shapes)."""
    port = port.detach().numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    ref = np.asarray(ref)
    assert port.shape == ref.shape, (what, port.shape, ref.shape)
    scale = max(float(np.abs(ref).max()), 1e-300) if ref.size else 1.0
    err = float(np.abs(port - ref).max()) if ref.size else 0.0
    assert err <= rel * scale, f"{what}: max |diff| {err:.3e} > {rel:.0e} x {scale:.3e}"


def _unit(rng, n, k):
    x = rng.standard_normal((n, k))
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _check_lie_and_state():
    # f64, every op on seeded inputs (with small and zero angles): 1e-12
    rng = np.random.default_rng(1)
    q, q2 = _unit(rng, 32, 4), _unit(rng, 32, 4)
    v = rng.standard_normal((32, 3))
    w = rng.standard_normal((32, 3)) * 0.7
    w[:4] *= 1e-7  # the Taylor branches
    w[4] = 0.0
    cases = [
        ("hat", (v,)), ("quat_mul", (q, q2)), ("quat_conj", (q,)),
        ("quat_normalize", (q * 3.0,)), ("quat_rotate", (q, v)),
        ("quat_rotate", (q[0], v)), ("quat_rotate", (q[:, None], v[:4])),  # broadcasts
        ("quat_to_matrix", (q,)), ("matrix_to_quat", (np.asarray(lie_j.quat_to_matrix(q)),)),
        ("expmap", (w,)), ("logmap", (q,)), ("logmap", (np.asarray(lie_j.expmap(w)),)),
        ("right_jacobian", (w,)), ("left_jacobian", (w,)),
        ("s2_tangential_basis", (_unit(rng, 32, 3),)),
        ("s2_tangential_basis", (np.eye(3),)),  # ties in |component|
        ("slerp", (q, q2, 0.3)), ("slerp", (q, q, 0.3)),  # the lerp branch
    ]
    for name, args in cases:
        a = getattr(lie_j, name)(*(jnp.asarray(x) if isinstance(x, np.ndarray) else x
                                   for x in args))
        b = getattr(lie_t, name)(*(_t(x) if isinstance(x, np.ndarray) else x for x in args))
        close(b, a, 1e-12, name)

    # retract / local_delta / zero_states (1e-12)
    sj = st_j.FrameStates(q=jnp.asarray(q[:W]), p=jnp.asarray(v[:W]),
                          v=jnp.asarray(v[W:2 * W]), bg=jnp.asarray(v[2 * W:3 * W]),
                          ba=jnp.asarray(v[3 * W:4 * W]))
    stt = convert.frame_states_from(_np(sj), "cpu")
    d = rng.standard_normal((W, ES)) * 0.1
    rj, rt = st_j.retract(sj, jnp.asarray(d)), st_t.retract(stt, _t(d))
    for a, b in zip(rj, rt):
        close(b, a, 1e-12, "retract")
    close(st_t.local_delta(rt, stt), st_j.local_delta(rj, sj), 1e-12, "local_delta")
    for a, b in zip(st_j.zero_states(W), st_t.zero_states(W, device="cpu")):
        close(b, a, 0.0, "zero_states")


def _imu_interval(rng, n_real, cap):
    dts = np.zeros(cap)
    dts[:n_real] = 0.005 + 0.0005 * rng.standard_normal(n_real)
    ws = rng.standard_normal((cap, 3)) * 0.5
    accs = rng.standard_normal((cap, 3)) + np.array([0.0, 0.0, 9.81])
    return dts, ws, accs


def _check_preintegration():
    # a 64-sample interval, 23 of them padding (dt = 0), at a nonzero bias
    rng = np.random.default_rng(2)
    dts, ws, accs = _imu_interval(rng, 41, 64)
    bg, ba = rng.standard_normal(3) * 0.01, rng.standard_normal(3) * 0.05
    covs = [np.eye(3) * c for c in [2.9e-8, 4e-6, 3.8e-10, 9e-6]]
    args = (dts, ws, accs, bg, ba, *covs)
    dj = jax.jit(pre_j.integrate)(*map(jnp.asarray, args))
    dt = pre_t.integrate(*map(_t, args))
    ds = pre_t.integrate_sequential(*map(_t, args))
    # against JAX: 1e-10 relative; against the port's own sequential
    # reference (another summation order): 1e-10 relative
    for name, a, b, c in zip(dj._fields, dj, dt, ds):
        close(b, a, 1e-10, f"integrate.{name}")
        close(b, c.numpy(), 1e-10, f"integrate vs sequential .{name}")
    # the padding composes as exact identities: same result without it
    dn = pre_t.integrate(*map(_t, (dts[:41], ws[:41], accs[:41], bg, ba, *covs)))
    for name, a, b in zip(dn._fields, dn, dt):
        close(b, a, 1e-13, f"padding.{name}")
    # a batch of intervals under torch.func.vmap is the per-interval result
    batch = [_imu_interval(rng, n, 64) for n in (10, 64)]
    stack = [_t(np.stack(x)) for x in zip(*batch)]
    dv = torch.func.vmap(pre_t.integrate, in_dims=(0, 0, 0) + (None,) * 6)(
        *stack, *map(_t, (bg, ba, *covs)))
    for k, one in enumerate(batch):
        d1 = pre_t.integrate(*map(_t, (*one, bg, ba, *covs)))
        for name, a, b in zip(d1._fields, d1, dv):
            close(b[k], a, 1e-13, f"vmap integrate.{name}")

    cov = np.asarray(dj.cov) + 1e-14 * np.eye(15)
    close(pre_t.sqrt_inv_cov(_t(cov)), pre_j.sqrt_inv_cov(jnp.asarray(cov)), 1e-9,
          "sqrt_inv_cov")
    q, p, v = _unit(rng, 1, 4)[0], rng.standard_normal(3), rng.standard_normal(3)
    state = (q, p, v, bg, ba)
    for a, b in zip(pre_j.predict(dj, *map(jnp.asarray, state)),
                    pre_t.predict(dt, *map(_t, state))):
        close(b, a, 1e-12, "predict")
    prop = (q, p, v, 0.005, ws[0], accs[0], bg, ba)
    for a, b in zip(pre_j.propagate_state(*map(jnp.asarray, prop)),
                    pre_t.propagate_state(*(_t(x) if isinstance(x, np.ndarray) else x
                                            for x in prop))):
        close(b, a, 1e-12, "propagate_state")


def _check_triangulate():
    # points, not eigenvectors (the sign of an eigenvector is arbitrary): 1e-8
    rng = np.random.default_rng(4)
    pts = rng.uniform(-2, 2, (40, 3)) + np.array([0.0, 0.0, 6.0])
    pts[0, 2] = -6.0  # behind both cameras: ok is False in both packages
    q1, q2 = np.array([1.0, 0, 0, 0]), _unit(rng, 1, 4)[0] * [1, 0.05, 0.05, 0.05]
    q2 = q2 / np.linalg.norm(q2)
    p1, p2 = np.zeros(3), np.array([0.4, -0.1, 0.05])
    R1, R2 = np.asarray(lie_j.quat_to_matrix(q1)), np.asarray(lie_j.quat_to_matrix(q2))
    c1, c2 = pts @ R1.T + p1, pts @ R2.T + p2
    b1 = c1 / np.linalg.norm(c1, axis=-1, keepdims=True)
    b2 = c2 / np.linalg.norm(c2, axis=-1, keepdims=True)
    args = (b1, b2, q1, p1, q2, p2)
    xj, okj = tri_j.triangulate_two_view(*map(jnp.asarray, args))
    xt, okt = tri_t.triangulate_two_view(*map(_t, args))
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
    assert not bool(okt[0]) and bool(okt[1:].all())
    close(xt[1:], np.asarray(xj)[1:], 1e-8, "triangulate_two_view")
    close(xt[1:], pts[1:], 1e-8, "triangulate_two_view against the truth")

    # N views of one point, two of them masked out
    n = 6
    qs = _unit(rng, n, 4) * [1, 0.05, 0.05, 0.05]
    qs /= np.linalg.norm(qs, axis=-1, keepdims=True)
    ps = rng.standard_normal((n, 3)) * 0.3
    Rs = np.asarray(lie_j.quat_to_matrix(qs))
    cams = np.einsum("nij,j->ni", Rs, pts[1]) + ps
    bear = cams / np.linalg.norm(cams, axis=-1, keepdims=True)
    bear[4] = _unit(rng, 1, 3)[0]  # outliers, masked
    mask = np.array([1, 1, 1, 1, 0, 0], bool)
    for m in (mask, None):
        xj, okj = tri_j.triangulate_homogeneous(*map(jnp.asarray, (bear, qs, ps)),
                                                None if m is None else jnp.asarray(m))
        xt, okt = tri_t.triangulate_homogeneous(*map(_t, (bear, qs, ps)),
                                                None if m is None else _t(m))
        assert bool(okt) == bool(okj)
        close(xt, xj, 1e-8, "triangulate_homogeneous")
    xt, okt = tri_t.triangulate_homogeneous(*map(_t, (bear, qs, ps, mask)))
    assert bool(okt)
    close(xt, pts[1], 1e-8, "triangulate_homogeneous against the truth")


def _check_residuals(problem):
    # each residual on seeded inputs, batched by vmap in both packages: 1e-12
    rng = np.random.default_rng(5)
    n = 16
    ext = (_unit(rng, 1, 4)[0], rng.standard_normal(3) * 0.05,
           _unit(rng, 1, 4)[0], rng.standard_normal(3) * 0.05)
    ext_j = F_j.Extrinsics(*map(jnp.asarray, ext))
    ext_t = F_t.Extrinsics(*map(_t, ext))
    sic2 = np.diag([650.0, 640.0])
    z = np.concatenate([rng.standard_normal((n, 2)) * 0.2, np.ones((n, 1))], axis=-1)
    z_ref = z / np.linalg.norm(z, axis=-1, keepdims=True)
    z_tgt = _unit(rng, n, 3) * 0.1 + z_ref
    z_tgt /= np.linalg.norm(z_tgt, axis=-1, keepdims=True)
    q_t, q_r = _unit(rng, n, 4), _unit(rng, n, 4)
    p_t, p_r = rng.standard_normal((n, 3)), rng.standard_normal((n, 3))
    idp = rng.uniform(0.1, 1.0, n)

    def both(fn_j, fn_t, args, in_axes, what):
        a = jax.vmap(fn_j, in_axes=in_axes)(*(jnp.asarray(x) if isinstance(x, np.ndarray)
                                             else x for x in args))
        b = torch.func.vmap(fn_t, in_dims=in_axes)(*(_t(x) if isinstance(x, np.ndarray)
                                                     else x for x in args))
        close(b, a, 1e-12, what)

    both(lambda *a: F_j.reprojection_residual(*a, ext_j, jnp.asarray(sic2)),
         lambda *a: F_t.reprojection_residual(*a, ext_t, _t(sic2)),
         (q_t, p_t, q_r, p_r, idp, z_ref, z_tgt), 0, "reprojection_residual")
    both(lambda *a: F_j.rotation_prior_residual(*a, ext_j, jnp.asarray(sic2)),
         lambda *a: F_t.rotation_prior_residual(*a, ext_t, _t(sic2)),
         (q_t, q_r, z_ref, z_tgt), 0, "rotation_prior_residual")

    imu = problem[2].imu  # an integrated interval of the window
    dj = jax.tree_util.tree_map(lambda a: a[0], imu.delta)
    sic15 = imu.sqrt_inv_cov[0]
    dt = convert.preint_delta_from(dj, "cpu")
    si = [_unit(rng, n, 4)] + [rng.standard_normal((n, 3)) * s for s in (1, 1, 0.01, 0.05)]
    sj = [_unit(rng, n, 4)] + [rng.standard_normal((n, 3)) * s for s in (1, 1, 0.01, 0.05)]
    b0 = [rng.standard_normal((n, 3)) * 0.01, rng.standard_normal((n, 3)) * 0.05]
    a = jax.vmap(lambda *x: F_j.preintegration_residual(*x[:10], dj, jnp.asarray(sic15),
                                                         *x[10:], ext_j))(
        *map(jnp.asarray, si + sj + b0))
    b = torch.func.vmap(lambda *x: F_t.preintegration_residual(*x[:10], dt, _t(sic15),
                                                               *x[10:], ext_t))(
        *map(_t, si + sj + b0))
    close(b, a, 1e-12, "preintegration_residual")

    lin = [_unit(rng, W, 4)] + [rng.standard_normal((W, 3)) * s for s in (1, 1, 0.01, 0.05)]
    prior_j = F_j.PriorFactor(*map(jnp.asarray, lin + [rng.standard_normal((W * ES, W * ES)),
                                                       rng.standard_normal(W * ES)]))
    states = [_unit(rng, W, 4)] + [rng.standard_normal((W, 3)) * s for s in (1, 1, 0.01, 0.05)]
    a = F_j.prior_residual(st_j.FrameStates(*map(jnp.asarray, states)), prior_j)
    b = F_t.prior_residual(st_t.FrameStates(*map(_t, states)),
                           F_t.PriorFactor(*map(_t, _np(prior_j))))
    close(b, a, 1e-12, "prior_residual")


def _seq():
    return synth_j.generate(duration=4.0, n_landmarks=300, max_keypoints=40)


def _jax_window_problem():
    """The entry point's window (JAX package), as NumPy."""
    states, invd, pb, n_lm, n_obs = sp_j.build_window_problem(
        _seq(), f0=10, W=W, L_max=64, O_max=256)
    return _np(states), np.asarray(invd), _np(pb), n_lm, n_obs


def _check_problem_build(problem):
    # the port's build_window_problem against the JAX one on the same
    # sequence: index and mask arrays equal, floats (IMU factors integrated
    # by each package's scan) within 1e-12 relative, every dtype the same
    sj, ij, pj, n_lm, n_obs = problem
    seq = synth_t.generate(duration=4.0, n_landmarks=300, max_keypoints=40)
    st, it, pt, n_lm_t, n_obs_t = sp_t.build_window_problem(
        seq, f0=10, W=W, L_max=64, O_max=256, device="cpu")
    assert (n_lm_t, n_obs_t) == (n_lm, n_obs) and n_lm > 30 and n_obs > 150
    leaves_j = jax.tree_util.tree_leaves((sj, ij, pj))
    leaves_t = torch.utils._pytree.tree_leaves((st, it, pt))
    assert len(leaves_j) == len(leaves_t)
    for a, b in zip(leaves_j, leaves_t):
        assert str(b.dtype).split(".")[-1] == str(a.dtype), (a.dtype, b.dtype)
        if b.is_floating_point():
            close(b, a, 1e-12, "build_window_problem")
        else:
            np.testing.assert_array_equal(b.numpy(), a)
    # the conversion carries every leaf unchanged
    pc = convert.ba_problem_from(pj, "cpu")
    for a, b in zip(jax.tree_util.tree_leaves(pj), torch.utils._pytree.tree_leaves(pc)):
        assert str(b.dtype).split(".")[-1] == str(a.dtype)
        np.testing.assert_array_equal(b.numpy(), a)


def _full_problem(problem, seed):
    """The entry point's window with frame 0 fixed, every factor group
    populated (8 reprojection priors, 2 IMU priors, 8 rotation priors, one
    slot of each left invalid) and seeded perturbed states, as NumPy."""
    sj, ij, pj, _, _ = problem
    rng = np.random.default_rng(seed)
    d = rng.standard_normal((W, ES)) * 0.01
    d[:, 9:] *= 0.1
    s = _np(st_j.retract(st_j.FrameStates(*map(jnp.asarray, sj)), jnp.asarray(d)))
    invd = ij * (1.0 + 0.1 * rng.standard_normal(ij.shape))
    rf = pj.reproj
    o, o2 = slice(0, 8), slice(8, 16)
    valid8 = np.arange(8) < 7
    reproj_prior = F_j.ReprojPriorFactors(
        tgt=rf.tgt[o], q_ref=sj.q[rf.ref[o]], p_ref=sj.p[rf.ref[o]], inv_depth=ij[rf.lm[o]],
        z_ref=rf.z_ref[o], z_tgt=rf.z_tgt[o], valid=valid8)
    f = np.array([1, 3])
    imu_prior = F_j.ImuPriorFactors(
        j=pj.imu.j[f], q_i=sj.q[f], p_i=sj.p[f], v_i=sj.v[f],
        bg_i=rng.standard_normal((2, 3)) * 1e-3, ba_i=rng.standard_normal((2, 3)) * 1e-2,
        delta=jax.tree_util.tree_map(lambda a: a[f], pj.imu.delta),
        sqrt_inv_cov=pj.imu.sqrt_inv_cov[f], valid=np.array([True, True]))
    rot = F_j.RotFactors(tgt=rf.tgt[o2], q_ref=sj.q[rf.ref[o2]], z_ref=rf.z_ref[o2],
                         z_tgt=rf.z_tgt[o2], valid=valid8)
    opt_pose = np.arange(W) > 0
    pb = pj._replace(reproj_prior=reproj_prior, imu_prior=imu_prior, rot=rot,
                     opt_pose=opt_pose, opt_motion=opt_pose.copy())
    return s, invd, pb


def _linearize_all(ba, s, invd, pb):
    """Every linearize_* output, build_normal_system's and compute_cost's, of
    one package's `ba` module."""
    return (ba.linearize_reprojection(s, invd, pb), ba.linearize_reproj_prior(s, pb),
            ba.linearize_imu_prior(s, pb), ba.linearize_imu(s, pb),
            ba.linearize_rot(s, pb), ba.linearize_prior(s, pb),
            ba.build_normal_system(s, invd, pb), ba.compute_cost(s, invd, pb))


@functools.cache
def _linearize_all_j():
    """The JAX side, compiled once."""
    return jax.jit(functools.partial(_linearize_all, ba_j))


def _perturbed_solve_inputs(problem):
    """The entry point's window from the port's `perturbed_start` (test_ba.py's
    perturbation, frame 0 fixed), as NumPy for both packages."""
    sj, ij, pj, _, _ = problem
    s0, invd0, pb = sp_t.perturbed_start(convert.frame_states_from(sj, "cpu"), _t(ij),
                                         convert.ba_problem_from(pj, "cpu"))
    fixed0 = pb.opt_pose.numpy()
    assert not fixed0[0] and fixed0[1:].all()
    return (sj, st_j.FrameStates(*map(np.asarray, s0)), invd0.numpy(),
            pj._replace(opt_pose=fixed0, opt_motion=fixed0.copy()))


def _solve_problem(inputs, dtype):
    """The solve's inputs for `dtype`: in f32 the 1e15 gauge prior turns
    the rounding of q_lin^-1 q on the fixed frame 0 into a constant cost term
    of up to ~1e14, which ends the JAX solve after one step on the
    relative-decrease test; its size depends on whether the arithmetic fuses
    multiply-adds, so it is not comparable between the packages. Frame 0 is
    held by the masks, so the f32 comparison solves without the prior."""
    sgt, s0, invd0, pb = inputs["solve"]
    if dtype == "float32":
        pb = pb._replace(prior_valid=np.asarray(False))
    return sgt, s0, invd0, pb


def _estimator_inputs(problem):
    """The inputs of the linearization, Cholesky-failure, solve and
    marginalization checks, as NumPy."""
    return dict(lin=_full_problem(problem, 3), marg=_full_problem(problem, 11),
                solve=_perturbed_solve_inputs(problem))


def _jax_estimator_outputs(inputs):
    """The JAX package's outputs for those checks, as NumPy."""
    s, invd, pb = inputs["lin"]
    lin = _np(_linearize_all_j()(s, invd, pb))
    H, g, Hll, Hcl, bl, cmask = lin[6]
    args = (H, g, Hll, Hcl, bl, cmask, np.float64(1e-4), pb.opt_lm)
    chol = [_np(ba_j.solve_normal_system(*map(jnp.asarray, (sign * H, *args[1:]))))
            for sign in (-1.0, 1.0)]
    solve = {}
    for dtype in ("float64", "float32"):
        _, s0, invd0, pbs = _solve_problem(inputs, dtype)
        r = ba_j.solve_ba(*_cast_floats((st_j.FrameStates(*map(jnp.asarray, s0)),
                                         jnp.asarray(invd0), pbs), getattr(jnp, dtype)),
                          max_iterations=30)
        solve[dtype] = _np(dict(iterations=r.iterations, cost=r.cost,
                                initial_cost=r.initial_cost, states=r.states,
                                inv_depth=r.inv_depth))
    s, invd, pb = inputs["marg"]
    marg = _np(mg_j.marginalize_frame0(st_j.FrameStates(*map(jnp.asarray, s)),
                                       jnp.asarray(invd), jax.tree_util.tree_map(jnp.asarray, pb)))
    return dict(lin=lin, chol=chol, solve=solve, marg=marg)


def _check_linearization(inputs, want):
    # every linearize_* residual and Jacobian, build_normal_system's
    # (H, g, Hll, Hcl, bl, cmask) and compute_cost: f64, 1e-9 relative
    s, invd, pb = inputs["lin"]
    out_j = want["lin"]
    out_t = _linearize_all(ba_t, convert.frame_states_from(s, "cpu"), _t(invd),
                           convert.ba_problem_from(pb, "cpu"))
    names = ["reprojection (r, Jc, Jl)", "reproj_prior (r, Jc)", "imu_prior (r, Jc)",
             "imu (r, Jc)", "rot (r, Jc)", "prior (r, J)",
             "build_normal_system (H, g, Hll, Hcl, bl, cmask)"]
    for name, a, b in zip(names, out_j[:-1], out_t[:-1]):
        for k, (x, y) in enumerate(zip(a, b)):
            close(y, x, 1e-9, f"{name}[{k}]")
            assert np.abs(np.asarray(x)).max() > 0, f"{name}[{k}] is all zero"
    close(out_t[-1], out_j[-1], 1e-9, "compute_cost")


def _check_cholesky_failure(inputs, want):
    # a reduced system that is not positive definite: JAX's Cholesky gives
    # NaNs, the port's cholesky_ex a failure code; both take a zero camera
    # step and the same landmark step (1e-9 relative)
    pb = inputs["lin"][2]
    H, g, Hll, Hcl, bl, cmask = map(np.asarray, want["lin"][6])
    H = -H  # negative definite on the free columns
    args = (H, g, Hll, Hcl, bl, cmask, np.float64(1e-4), pb.opt_lm)
    dc_j, dl_j = want["chol"][0]
    dc_t, dl_t = ba_t.solve_normal_system(*map(_t, args))
    assert not np.asarray(dc_j).any() and not dc_t.any()
    assert np.abs(np.asarray(dl_j)).max() > 0
    close(dl_t, dl_j, 1e-9, "landmark step after a failed Cholesky")
    # and a positive definite one: the same step in both (1e-9 relative)
    args = (-H, *args[1:])
    for a, b in zip(want["chol"][1], ba_t.solve_normal_system(*map(_t, args))):
        close(b, a, 1e-9, "solve_normal_system")


def _check_solve(dtype, inputs, want):
    # (the inputs of `dtype`: _solve_problem)
    sgt, s0, invd0, pb = _solve_problem(inputs, dtype)
    rj = types.SimpleNamespace(**want["solve"][dtype])
    rt = ba_t.solve_ba(*cast_floats((convert.frame_states_from(s0, "cpu"), _t(invd0),
                                     convert.ba_problem_from(pb, "cpu")),
                                    getattr(torch, dtype)), max_iterations=30)
    it_j, it_t = int(rj.iterations), int(rt.iterations)
    c0 = float(rj.initial_cost)
    assert rt.states.p.dtype == getattr(torch, dtype)
    # both converge: cost down >= 1e3 x, positions within 5e-3 m of the truth
    for r in (rj, rt):
        assert float(r.cost) < 1e-3 * float(r.initial_cost)
        assert np.abs(np.asarray(r.states.p) - sgt.p).max() < 5e-3
    if dtype == "float64":
        # the same accepted steps; states and inverse depths within 1e-9;
        # costs within 1e-10 of the initial cost (the gauge prior's rounding
        # noise, ~1e-2, sits in the cost)
        assert it_t == it_j, (it_t, it_j)
        for a, b in zip(rj.states, rt.states):
            assert np.abs(b.numpy() - np.asarray(a)).max() <= 1e-9
        assert np.abs(rt.inv_depth.numpy() - np.asarray(rj.inv_depth)).max() <= 1e-9
        assert abs(float(rt.cost) - float(rj.cost)) <= 1e-10 * c0
        assert abs(float(rt.initial_cost) - c0) <= 1e-10 * c0
    else:
        # f32: accepted steps within 1 of each other; positions within 1e-5 m,
        # inverse depths within 1e-3 of each other; costs within 1e-10 of the
        # initial cost
        assert abs(it_t - it_j) <= 1, (it_t, it_j)
        assert np.abs(rt.states.p.numpy() - np.asarray(rj.states.p)).max() <= 1e-5
        assert np.abs(rt.inv_depth.numpy() - np.asarray(rj.inv_depth)).max() <= 1e-3
        assert abs(float(rt.cost) - float(rj.cost)) <= 1e-10 * c0
    return it_j, it_t


def _check_marginalization(inputs, want):
    # S^T S and S^T infovec (S's eigenvector signs are arbitrary): 1e-9
    # relative; the shifted linearization points exactly
    s, invd, pb = inputs["marg"]
    pj = want["marg"]
    pt = mg_t.marginalize_frame0(convert.frame_states_from(s, "cpu"), _t(invd),
                                 convert.ba_problem_from(pb, "cpu"))
    Sj, ivj = np.asarray(pj.sqrt_inv_cov), np.asarray(pj.infovec)
    St, ivt = pt.sqrt_inv_cov.numpy(), pt.infovec.numpy()
    close(St.T @ St, Sj.T @ Sj, 1e-9, "marginalize_frame0 S^T S")
    close(St.T @ ivt, Sj.T @ ivj, 1e-9, "marginalize_frame0 S^T infovec")
    assert np.abs(Sj.T @ ivj).max() > 0
    for name in ("q_lin", "p_lin", "v_lin", "bg_lin", "ba_lin"):
        np.testing.assert_array_equal(getattr(pt, name).numpy(), getattr(pj, name))


def test_estimator_matches_jax(child):
    problem = jax_ref(child, "estimation_problem", (_seq(), W, 64, 256), _jax_window_problem)()
    child(_check_lie_and_state)
    child(_check_preintegration)
    child(_check_triangulate)
    child(_check_residuals, problem)
    child(_check_problem_build, problem)
    inputs = child(_estimator_inputs, problem)
    want = jax_ref(child, "estimation", inputs, _jax_estimator_outputs, inputs)()
    child(_check_linearization, inputs, want)
    child(_check_cholesky_failure, inputs, want)
    assert child(_check_solve, "float64", inputs, want)[0] >= 3
    child(_check_solve, "float32", inputs, want)
    child(_check_marginalization, inputs, want)
