"""Port parity of models/builders.py: the host assembly and every device
program of the estimator's main path.

The JAX side runs in a spawned process that keeps the persistent compilation
cache (`jax_side`, tests/test_torch_image.py): an Odometry run of the
perfect-match synthetic backend with tests/test_e2e_synthetic.py's Caps and
profile (the programs that test and the other parity modules run), 0.5 px
of pixel noise, and the default window of 10 keyframes, so that the first
keyframes after the initialization (8 keyframes) take the window-filling
path and the next ones the steady fused step. Each device program's first
call is recorded (its inputs and outputs), and so is, at the first fused
keyframe step, the map and every spec with the host arrays the JAX package
assembled from them. Every program is then called again on its recorded
inputs in f64 (the reason is in `_check_programs`), with the programs the
run does not reach (`_solve_noprior_jit`, `_marginalize_jit`,
`_fused_window_tail_jit`). The records go to the spawned child as a
pickle; the child runs the port on the same inputs (see test_torch_image
for why the checks run there).
"""

import dataclasses
import pickle
import types

import numpy as np
import jax

from rd_vio_tpu.config import Config as ConfigJ
from rd_vio_tpu.datasets import synthetic as synth_j
from rd_vio_tpu.models import builders as builders_j
from rd_vio_tpu.models.feature_tracker import SyntheticBackend as SyntheticBackendJ
from rd_vio_tpu.models.odometry import Odometry as OdometryJ
from tests.test_torch_image import IN_CHILD, child, file_output, jax_ref, jax_side  # noqa: F401

if IN_CHILD:  # the port loads only where the checks run (test_torch_image)
    import torch

    from rd_vio_tpu_torch import convert
    from rd_vio_tpu_torch.estimation.state import FrameStates
    from rd_vio_tpu_torch.models import builders as builders_t
    from rd_vio_tpu_torch.models.sliding_window_tracker import SlidingWindowTracker

CAPS = dict(W=13, L=256, O=1536, Fi=16, R=128, IMU=64, IMU_KF=384)
DURATION_S = 2.6
# pixel noise (px), so that every solve has a cost above its dtype's noise
# floor and its accepted steps are a property of the problem
PIXEL_NOISE = 0.5
# device programs recorded at their first call during the run
RECORDED = ("_integrate_batch", "_triangulate_batch", "_fused_localize_subwindow_jit",
            "_fused_localize_subwindow_chain_jit", "_fused_localize_triangulate_jit",
            "_solve_prior_jit", "_fused_keyframe_jit", "_marginalize_tail_jit")


def make_config(K):
    cfg = ConfigJ()
    cfg.camera_intrinsic = K
    cfg.ransac_hypotheses = 128
    return cfg


def up64(tree):
    """Every floating-point NumPy leaf of a tree as f64."""
    return jax.tree_util.tree_map(
        lambda a: a.astype(np.float64) if isinstance(a, np.ndarray)
        and np.issubdtype(a.dtype, np.floating) else a, tree)


def plain_map(m):
    """The map's frames, tracks and store as plain objects (picklable; the
    attribute layout convert.map_from reads)."""
    def frame(f):
        c = lambda a: np.array(a)  # noqa: E731 (the run mutates some in place)
        return types.SimpleNamespace(
            id=f.id, t=f.t, q=c(f.q), p=c(f.p), v=c(f.v), bg=c(f.bg), ba=c(f.ba),
            bearings=c(f.bearings), track_ids=c(f.track_ids), flags=set(f.flags),
            imu_dt=c(f.imu_dt), imu_w=c(f.imu_w), imu_a=c(f.imu_a),
            subframes=[frame(s) for s in f.subframes],
            keyframe_imu=None if f.keyframe_imu is None else tuple(map(c, f.keyframe_imu)))

    st = m.store
    return types.SimpleNamespace(
        frames=[frame(f) for f in m.frames],
        tracks={tid: types.SimpleNamespace(id=t.id, row=t.row, obs=dict(t.obs),
                                           reprojection_error=t.reprojection_error)
                for tid, t in m.tracks.items()},
        store=types.SimpleNamespace(cap=st.cap, flags=st.flags.copy(),
                                    inv_depth=st.inv_depth.copy(), life=st.life.copy(),
                                    first_fid=st.first_fid.copy(), _free=list(st._free),
                                    _row_of_tid=st._row_of_tid.copy()))


def spec_ids(spec):
    """A BASpec with frames and tracks replaced by their ids (the form
    convert.ba_spec_from reads)."""
    ra = spec.reproj_arrays
    return dict(
        frames=[f.id for f in spec.frames], fix_pose=list(spec.fix_pose),
        fix_motion=list(spec.fix_motion), opt_tracks=[t.id for t in spec.opt_tracks],
        reproj=[(a.id, b.id, t.id, fx) for a, b, t, fx in spec.reproj],
        imu=[(a.id, b.id, imu, bg, ba_, kf) for a, b, imu, bg, ba_, kf in spec.imu],
        rot=[(a.id, b.id, t.id) for a, b, t in spec.rot],
        prior=jax.device_get(spec.prior),
        reproj_prior=[(a.id, b.id, t.id) for a, b, t in spec.reproj_prior],
        imu_prior=[(a.id, b.id, imu) for a, b, imu in spec.imu_prior],
        reproj_arrays=None if ra is None else dataclasses.asdict(ra),
        opt_invd=None if spec.opt_invd is None else np.array(spec.opt_invd),
    )


def record_jax_run(path):
    """The JAX run: records as described in the module docstring, pickled
    to `path`."""
    seq = _jax_seq()
    cfg = make_config(seq.K_mat)
    caps = builders_j.Caps(**CAPS)
    odo = OdometryJ(cfg, SyntheticBackendJ(seq), caps=caps)
    rec = {}
    saved = {}

    def recorder(name, fn):
        def call(*args, **kw):
            out = fn(*args, **kw)
            if name not in rec:
                rec[name] = jax.device_get((args, kw, out))
            return out
        return call

    def kf_snapshot(spec_loc, pending, spec_w, tracks_v, spec_m, frames_by_id, calib,
                    caps_, caps_loc=None, dtype=None, loc_dtype=None, max_iterations=10):
        if "keyframe_host" not in rec:
            arrays, lm_w = builders_j.assemble_keyframe_fused(
                spec_loc, pending, spec_w, tracks_v, spec_m, frames_by_id, calib, caps_,
                caps_loc=caps_loc, dtype=dtype, loc_dtype=loc_dtype)
            swt = odo.frontend.swt
            rec["keyframe_host"] = dict(
                map=plain_map(swt.map), prior=jax.device_get(swt.prior),
                spec_loc=spec_ids(spec_loc), spec_w=spec_ids(spec_w),
                spec_m=spec_ids(spec_m), pending=[t.id for t in pending],
                tracks_v=[t.id for t in tracks_v], caps_loc=dataclasses.asdict(caps_loc),
                arrays=jax.device_get(arrays), lm_w=dict(lm_w),
                empty_validation=builders_j._assemble_validation_ref(
                    [], frames_by_id, {}, {}, calib, 2 * caps_.L, caps_.O))
        out = saved["solve_keyframe_fused"](
            spec_loc, pending, spec_w, tracks_v, spec_m, frames_by_id, calib, caps_,
            caps_loc=caps_loc, dtype=dtype, loc_dtype=loc_dtype,
            max_iterations=max_iterations)
        if "keyframe_async" not in rec:
            # the async step on the same keyframe, in f64, its localize
            # anchor chained from the last subwindow solve's states (after
            # the synchronous step, so that the recorded first calls stay
            # that step's)
            swt = odo.frontend.swt
            prev, slot_of = swt._dev_sub
            prev = jax.tree_util.tree_map(lambda a: a.astype(np.float64), prev)
            lip = slot_of.get(spec_loc.imu_prior[0][0].id, -1)
            res, lm_w, transfer, prior = builders_j.solve_keyframe_fused_async(
                spec_loc, pending, spec_w, tracks_v, spec_m, frames_by_id, calib, caps_,
                caps_loc=caps_loc, dtype=np.float64, loc_dtype=np.float64,
                max_iterations=max_iterations, prev_states=prev, loc_ip_prev=lip)
            rec["keyframe_async"] = jax.device_get(dict(
                prev=prev, lip=lip, iterations=res.iterations, lm_w=dict(lm_w),
                transfer=transfer, prior=prior))
        return out

    for name in RECORDED + ("solve_keyframe_fused",):
        saved[name] = getattr(builders_j, name)
    try:
        for name in RECORDED:
            setattr(builders_j, name, recorder(name, saved[name]))
        builders_j.solve_keyframe_fused = kf_snapshot
        events = sorted([(t, 1, i) for i, t in enumerate(seq.t_imu)]
                        + [(t, 0, i) for i, t in enumerate(seq.t_frame)])
        for t, kind, i in events:
            if kind == 1:
                odo.add_motion(t, seq.gyro[i], seq.accel[i])
            else:
                odo.add_frame(t, i)
    finally:
        for name, fn in saved.items():
            setattr(builders_j, name, fn)
    assert set(RECORDED) | {"keyframe_host"} <= set(rec), sorted(rec)

    # every program again on its recorded inputs in f64, and the programs
    # the run does not reach
    calib = odo.calib.tree
    it = cfg.solver_iteration_limit
    f64 = {}
    for name in ("_fused_localize_subwindow_jit", "_fused_localize_subwindow_chain_jit",
                 "_fused_localize_triangulate_jit", "_solve_prior_jit", "_fused_keyframe_jit"):
        args, kw, _ = rec[name]
        args = up64(args)
        f64[name] = (args, jax.device_get(saved[name](*args, **kw)))
    pa_loc = f64["_fused_localize_subwindow_jit"][0][0]
    kf_args = f64["_fused_keyframe_jit"][0]
    pa_w, prior_w, va = kf_args[8], kf_args[11], kf_args[12]
    mt_args = rec["_marginalize_tail_jit"][0]
    pa_m, prior_m = mt_args[5], mt_args[9]
    f64["_solve_noprior_jit"] = ((pa_loc,), jax.device_get(
        builders_j._solve_noprior_jit(pa_loc, calib, max_iterations=it)))
    f64["_marginalize_jit"] = ((pa_m, prior_m), jax.device_get(
        builders_j._marginalize_jit(pa_m, calib, prior_m)))
    f64["_fused_window_tail_jit"] = ((pa_w, prior_w, va), jax.device_get(
        builders_j._fused_window_tail_jit(pa_w, prior_w, va, calib, max_iterations=it)))
    rec["f64"] = f64
    rec["calib"] = jax.device_get(calib)
    c = odo.calib
    rec["calib_host"] = types.SimpleNamespace(K=c.K, sqrt_inv_cov2=np.asarray(c.sqrt_inv_cov2), **{
        f: getattr(c, f) for f in ("q_bc_h", "p_bc_h", "q_bi_h", "p_bi_h",
                                   "cov_w_h", "cov_a_h", "cov_bg_h", "cov_ba_h")})
    rec["iterations"] = it
    with open(path, "wb") as fh:
        pickle.dump(rec, fh)


# ---------------------------------------------------------------------------
# the checks (in the child)
# ---------------------------------------------------------------------------


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def close64(a, b, what):
    """f64: within 1e-9 relative (absolute below magnitude 1)."""
    a, b = np.asarray(a, np.float64), _np(b).astype(np.float64)
    err = np.abs(a - b) / np.maximum(np.abs(a), 1.0)
    assert err.max(initial=0.0) <= 1e-9, f"{what}: {err.max():.3e} relative"


def same_result64(rj, rt, what):
    """f64 BAResult: the same accepted steps, states and inverse depths
    within 1e-9 relative."""
    assert int(rj.iterations) == int(rt.iterations), (what, rj.iterations, rt.iterations)
    for name, a, b in zip(FrameStates._fields, rj.states, rt.states):
        close64(a, b, f"{what} {name}")
    close64(rj.inv_depth, rt.inv_depth, f"{what} inv_depth")


def same_result32(rj, rt, what):
    """f32 BAResult (tests/test_torch_estimation.py's f32 bounds): accepted
    steps within 1, positions within 1e-5 m."""
    assert abs(int(rj.iterations) - int(rt.iterations)) <= 1, (what, rj.iterations,
                                                              rt.iterations)
    d = np.abs(np.asarray(rj.states.p, np.float64) - _np(rt.states.p)).max()
    assert d <= 1e-5, f"{what}: positions differ by {d:.3e} m"


def _pa(pa):
    return convert.problem_arrays_from(pa)


def _check_host(rec):
    """Host assembly on the copied map: the same specs and bit-identical
    arrays (ProblemArrays, reprojection, validation, triangulation), but for
    the preintegrated IMU deltas (see `same`)."""
    kh = rec["keyframe_host"]
    m = convert.map_from(kh["map"])
    calib = convert.calib_from(rec["calib_host"], "cpu")
    caps = builders_t.Caps(**CAPS)
    cfg = convert.config_from(make_config(calib.K))
    swt = SlidingWindowTracker(m, cfg, calib, caps)
    swt.prior = convert.prior_from(kh["prior"], "cpu")
    frames = list(m.frames)
    frames_by_id = {f.id: f for f in m.all_frames()}

    # the SWT's own selections over the copied map
    pending = swt._select_pending(frames[-1])
    assert [t.id for t in pending] == kh["pending"]
    pend_ids = {t.id for t in pending}
    spec_w = swt._window_spec(frames, frames_by_id, pending=pending)
    spec_m = swt._marg_spec(frames, frames_by_id, require_valid=False, pending_ids=pend_ids)
    for got, want in ((spec_w, kh["spec_w"]), (spec_m, kh["spec_m"])):
        ids = {"frames": [f.id for f in got.frames],
               "opt_tracks": [t.id for t in got.opt_tracks]}
        assert ids["frames"] == want["frames"] and ids["opt_tracks"] == want["opt_tracks"]
        for k, v in dataclasses.asdict(got.reproj_arrays).items():
            np.testing.assert_array_equal(v, want["reproj_arrays"][k], err_msg=k)
        np.testing.assert_array_equal(got.opt_invd, want["opt_invd"])
        assert len(got.imu) == len(want["imu"])
        for (a, b, imu, bg, ba_, kf), (ai, bi, imu_j, bgj, baj, kfj) in zip(got.imu, want["imu"]):
            assert (a.id, b.id, kf) == (ai, bi, kfj)
            for x, y in zip(imu + (bg, ba_), tuple(imu_j) + (bgj, baj)):
                np.testing.assert_array_equal(x, y)

    # the builders' assembly on the recorded specs
    args, kw = _keyframe_args(rec)
    arrays, lm_w = builders_t.assemble_keyframe_fused(
        *args, caps_loc=kw["caps_loc"], dtype=np.dtype(cfg.window_solver_dtype),
        loc_dtype=np.dtype(cfg.fast_solver_dtype))
    assert lm_w == kh["lm_w"]

    def same(a, b, path):
        if path.endswith("_delta"):
            # the preintegrated IMU deltas: the JAX package integrates them
            # with its native C++ preintegrator where that is built, the port
            # with the NumPy loop it falls back to; the two sum in another
            # order, so these agree to 1e-12 of each field's largest entry
            for k in b:
                x, y = np.asarray(a[k]), np.asarray(b[k])
                scale = max(np.abs(y).max(initial=0.0), 1e-300)
                assert np.abs(x - y).max(initial=0.0) <= 1e-12 * scale, f"{path}.{k}"
            return
        if isinstance(b, dict):
            assert set(a) == set(b), path
            for k in b:
                same(a[k], b[k], f"{path}.{k}")
        elif hasattr(b, "_fields"):
            for k in b._fields:
                same(getattr(a, k), getattr(b, k), f"{path}.{k}")
        else:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=path)

    same(arrays, kh["arrays"], "keyframe")
    # no validation tracks: the same arrays as the JAX package's track-major twin
    same(builders_t._assemble_validation([], frames_by_id, {}, {}, calib, 2 * caps.L, caps.O),
         kh["empty_validation"], "empty validation")


def _keyframe_args(rec):
    """The recorded first fused keyframe step's arguments, on the port's
    copy of the map: (spec_loc, pending, spec_w, tracks_v, spec_m,
    frames_by_id, calib, caps), {"caps_loc": ...}."""
    kh = rec["keyframe_host"]
    m = convert.map_from(kh["map"])
    calib = convert.calib_from(rec["calib_host"], "cpu")
    specs = {k: convert.ba_spec_from(kh[k], m, "cpu") for k in ("spec_loc", "spec_w", "spec_m")}
    tr = m.tracks
    frames_by_id = {f.id: f for f in m.all_frames()}
    return ((specs["spec_loc"], [tr[i] for i in kh["pending"]], specs["spec_w"],
             [tr[i] for i in kh["tracks_v"]], specs["spec_m"], frames_by_id, calib,
             builders_t.Caps(**CAPS)), {"caps_loc": builders_t.Caps(**kh["caps_loc"])})


def _check_async(rec):
    """`solve_keyframe_fused_async` with prev_states on both sides, in f64,
    on the recorded first fused keyframe step (the port's on its own
    assembly of the copied map, which _check_host holds equal to the JAX
    package's): the window solve's accepted steps equal, every state of the
    transfer tuple and the inverse depths within close64's 1e-9, the
    validation and triangulation verdicts equal, the new prior within
    same_prior's 1e-9 (fused_keyframe's f64 bounds)."""
    ka = rec["keyframe_async"]
    args, kw = _keyframe_args(rec)
    builders_t.PROGRAM_STATS.pop("fused_keyframe_async", None)
    n_kf = builders_t.KF_FUSED_COUNT.n
    res, lm_w, transfer, prior = builders_t.solve_keyframe_fused_async(
        *args, **kw, dtype=np.float64, loc_dtype=np.float64, max_iterations=rec["iterations"],
        prev_states=convert.frame_states_from(ka["prev"], "cpu"), loc_ip_prev=ka["lip"])
    assert builders_t.KF_FUSED_COUNT.n == n_kf + 1
    assert builders_t.PROGRAM_STATS["fused_keyframe_async"]["calls"] == 1
    assert lm_w == ka["lm_w"]
    assert int(res.iterations) == int(ka["iterations"])
    assert len(transfer) == len(ka["transfer"]) == 14
    names = [f"window {n}" for n in FrameStates._fields] + ["inv_depth"] + [
        f"localize {n}" for n in FrameStates._fields]
    for name, a, b in zip(names, ka["transfer"][:11], transfer[:11]):
        close64(a, b, f"keyframe async {name}")
    vj, okj, tij = ka["transfer"][11:]
    np.testing.assert_array_equal(vj, _np(transfer[11]))
    np.testing.assert_array_equal(okj, _np(transfer[12]))
    close64(np.asarray(tij)[okj], _np(transfer[13])[okj], "keyframe async tri_invd")
    same_prior(ka["prior"], prior, "keyframe async prior")


def _check_programs(rec):
    """Every device program on the recorded inputs, in f64: the window
    solves carry the marginalization prior, whose 1e15 gauge rows make an
    f32 comparison meaningless (tests/test_torch_estimation.py: in f32 the
    JAX solve stops after one step where the port's converges), so the
    programs are held at the f64 bounds; the run's own prior-free f32
    localize + subwindow call is held at that test's f32 bounds."""
    dev = "cpu"
    calib = convert.calib_tree_from(rec["calib"], dev)
    it = rec["iterations"]
    fs = lambda s: convert.frame_states_from(s, dev)  # noqa: E731

    args, _, out = rec["_integrate_batch"]
    d, sic = builders_t._integrate_batch(*(_t(a) for a in args))
    for name in d._fields:
        close64(getattr(out[0], name), getattr(d, name), f"integrate_batch {name}")
    close64(out[1], sic, "integrate_batch sqrt_inv_cov")

    args, _, out = rec["_triangulate_batch"]
    pts, ok = builders_t.triangulate_batch(*(_t(a) for a in args))
    np.testing.assert_array_equal(out[1], _np(ok))
    close64(np.asarray(out[0])[out[1]], _np(pts)[out[1]], "triangulate_batch")

    f64 = rec["f64"]
    (pa_loc, pa_sub, j_slot, _), out = f64["_fused_localize_subwindow_jit"]
    res = builders_t.fused_localize_subwindow(_pa(pa_loc), _pa(pa_sub), int(j_slot), calib, it)
    same_result64(out, res, "fused_localize_subwindow")

    (pa_loc, pa_sub, j_slot, prev, lip, sub_prev, _), out = \
        f64["_fused_localize_subwindow_chain_jit"]
    res = builders_t.fused_localize_subwindow_chain(
        _pa(pa_loc), _pa(pa_sub), int(j_slot), fs(prev), int(lip), _t(sub_prev), calib, it)
    same_result64(out, res, "fused_localize_subwindow_chain")

    (pa, b, qcw, pcw, m, us, _), (rj, ptsj, okj) = f64["_fused_localize_triangulate_jit"]
    rt, pts, ok = builders_t.fused_localize_triangulate(
        _pa(pa), *(_t(a) for a in (b, qcw, pcw, m, us)), calib, it)
    same_result64(rj, rt, "fused_localize_triangulate")
    np.testing.assert_array_equal(okj, _np(ok))
    close64(np.asarray(ptsj)[okj], _np(pts)[okj], "fused_localize_triangulate points")

    (pa, _, prior), out = f64["_solve_prior_jit"]
    same_result64(out, builders_t.solve_prior(_pa(pa), calib, convert.prior_from(prior, dev), it),
                  "solve_prior")

    a, (rj, rlj, vj, okj, tij) = f64["_fused_keyframe_jit"]
    res, res_loc, valid, tri_ok, tri_invd = builders_t.fused_keyframe(
        _pa(a[0]), *(_t(x) for x in a[1:8]), _pa(a[8]), int(a[9]), _t(a[10]),
        convert.prior_from(a[11], dev), {k: _t(v) for k, v in a[12].items()}, calib, it)
    same_result64(rj, res, "fused_keyframe window")
    same_result64(rlj, res_loc, "fused_keyframe localize")
    np.testing.assert_array_equal(vj, _np(valid))  # validation masks equal
    np.testing.assert_array_equal(okj, _np(tri_ok))
    close64(np.asarray(tij)[okj], _np(tri_invd)[okj], "fused_keyframe tri_invd")

    a, _, pj = rec["_marginalize_tail_jit"]
    pt = builders_t.marginalize_tail(
        fs(a[0]), _t(a[1]), _t(a[2]), _t(a[3]), _t(a[4]), _pa(a[5]), _t(a[6]), _t(a[7]),
        _t(a[8]), convert.prior_from(a[9], dev), calib)
    same_prior(pj, pt, "marginalize_tail")

    (pa,), out = f64["_solve_noprior_jit"]
    same_result64(out, builders_t.solve_noprior(_pa(pa), calib, it), "solve_noprior")
    (pa, prior), pj = f64["_marginalize_jit"]
    same_prior(pj, builders_t.marginalize(_pa(pa), calib, convert.prior_from(prior, dev)),
               "marginalize")
    (pa, prior, va), (rj, vj) = f64["_fused_window_tail_jit"]
    rt, vt = builders_t.fused_window_tail(_pa(pa), convert.prior_from(prior, dev),
                                          {k: _t(v) for k, v in va.items()}, calib, it)
    same_result64(rj, rt, "fused_window_tail")
    np.testing.assert_array_equal(vj, _np(vt))
    # the run's own f32 call (prior-free)
    (pa_loc, pa_sub, j_slot, _), _, out = rec["_fused_localize_subwindow_jit"]
    res = builders_t.fused_localize_subwindow(_pa(pa_loc), _pa(pa_sub), int(j_slot), calib, it)
    assert res.states.p.dtype == torch.float32
    same_result32(out, res, "fused_localize_subwindow f32")


def same_prior(pj, pt, what):
    """Priors within 1e-9 relative: the information S^T S and S^T infovec."""
    Sj, ivj = np.asarray(pj.sqrt_inv_cov), np.asarray(pj.infovec)
    St, ivt = _np(pt.sqrt_inv_cov), _np(pt.infovec)
    scale = np.abs(Sj.T @ Sj).max()
    d_info = np.abs(St.T @ St - Sj.T @ Sj).max() / scale
    d_vec = np.abs(St.T @ ivt - Sj.T @ ivj).max() / max(np.abs(Sj.T @ ivj).max(), 1.0)
    assert d_info <= 1e-9 and d_vec <= 1e-9, f"{what}: {d_info:.3e}, {d_vec:.3e}"
    for name in ("q_lin", "p_lin", "v_lin", "bg_lin", "ba_lin"):
        close64(getattr(pj, name), getattr(pt, name), f"{what} {name}")


def _check(path):
    with open(path, "rb") as fh:
        rec = pickle.load(fh)
    _check_host(rec)
    _check_programs(rec)
    _check_async(rec)


def _jax_seq():
    return synth_j.generate(duration=DURATION_S, n_landmarks=1200, max_keypoints=150,
                            pixel_noise=PIXEL_NOISE, seed=648)


def test_builders_match_jax(child, jax_side, tmp_path):
    path = str(tmp_path / "jax_builders.pkl")
    seq = _jax_seq()
    data = jax_ref(jax_side, "builders", (seq, make_config(seq.K_mat), CAPS), file_output,
                   record_jax_run, path)()
    with open(path, "wb") as fh:
        fh.write(data)
    child(_check, path)
