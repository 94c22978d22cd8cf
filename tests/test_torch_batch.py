"""Port parity of the lockstep batch runtime's device programs and
dispatcher (rd_vio_tpu_torch/batch), and of utils/batch_eval.

The JAX side runs in a spawned process that keeps the persistent
compilation cache (`jax_side`, tests/test_torch_image.py): a single-sequence
Odometry run of tests/test_torch_builders.py's setup (the perfect-match
synthetic backend, tests/test_e2e_synthetic.py's Caps and profile, 0.5 px of
pixel noise) with tests/test_torch_odometry.py's window of 4 keyframes,
until the first call of each program the batch runtime vmaps
(`_fused_localize_subwindow_chain_jit`, `_fused_keyframe_jit`,
`_marginalize_tail_jit`) has been recorded. From each record the checks build a
batch of N=3 rows: row 0 is the recorded call, row 1 the same with its
initial states moved (so its solves differ), row 2 an inactive row (a
dummy, as the dispatcher rides a sequence that did not submit). The JAX
package's `_batched_sub_jit` runs on that batch as the run made it (f32).

In the child, the port runs:
- each batched program (`dispatcher.batched_sub`, `batched_kf`,
  `batched_marg`) on the batch cast to f64, against the port's single-row
  function on each row: accepted steps equal, states within 1e-9 relative,
  validation masks equal, priors within 1e-9 (their information S^T S and
  S^T infovec: the square-root factor itself is unique only up to the
  eigenvectors' signs); the inactive row's chain and prior bit-unchanged;
- the batched subwindow chain in f32 against the JAX package's
  `_batched_sub_jit` on the same stacked inputs, carried over by
  rd_vio_tpu_torch/convert.py: per active row the positions and every leaf
  of the new chain within 1e-5 (tests/test_torch_estimation.py's f32
  position bound), the inactive row's chain equal;
- the dispatcher's protocol on those inputs: results only after flush(),
  dummy rows for sequences that did not submit, prior-row writes and
  reads, keyframe continuations run at the flush;
- utils/batch_eval against the JAX package's on the same stub runs, in
  tests/test_batch_eval.py's shape of check.

The runtime as a whole (BatchedVIO over whole sequences) is held against the
JAX package by chip_smoke.py's phase H on the card (each sequence's ATE
against the JAX lockstep CPU run): a lockstep CPU run to three batched
keyframe flushes would not fit this module's time budget.
"""

import dataclasses
import pickle

import numpy as np
import jax

from rd_vio_tpu.datasets import synthetic as synth_j
from rd_vio_tpu.models import builders as builders_j
from rd_vio_tpu.models.feature_tracker import SyntheticBackend as SyntheticBackendJ
from rd_vio_tpu.models.odometry import Odometry as OdometryJ
from rd_vio_tpu.utils import batch_eval as batch_eval_j
from tests.test_torch_builders import CAPS, PIXEL_NOISE, make_config, same_prior, up64
from tests.test_torch_image import IN_CHILD, child, file_output, jax_ref, jax_side  # noqa: F401

if IN_CHILD:  # the port loads only where the checks run (test_torch_image)
    import torch

    from rd_vio_tpu_torch import convert
    from rd_vio_tpu_torch.batch import dispatcher as disp_t
    from rd_vio_tpu_torch.estimation import factors as F_t
    from rd_vio_tpu_torch.estimation.state import FrameStates
    from rd_vio_tpu_torch.models import builders as builders_t
    from rd_vio_tpu_torch.utils import batch_eval as batch_eval_t

DURATION_S = 2.6  # tests/test_torch_builders.py's run
RECORDED = ("_fused_localize_subwindow_chain_jit", "_fused_keyframe_jit",
            "_marginalize_tail_jit")
N_ROWS = 3
ACTIVE = np.array([True, True, False])
# LM iterations of the f64 row-against-batch checks and of the dispatcher's
# programs (the f32 check against the JAX package runs the run's own limit):
# a row's result equals its single-row solve at any limit, and a smaller
# one keeps this module inside its time budget
IT_ROWS = 4


def _moved(pa, seed, scale=0.02):
    """A ProblemArrays (of either package, NumPy leaves) with its initial
    positions and velocities moved by seeded noise of `scale`."""
    rng = np.random.default_rng(seed)
    return pa._replace(p=(pa.p + scale * rng.standard_normal(pa.p.shape)).astype(pa.p.dtype),
                       v=(pa.v + scale * rng.standard_normal(pa.v.shape)).astype(pa.v.dtype))


def _stack(trees):
    return jax.tree_util.tree_map(lambda *a: np.stack(a), *trees)


def _jax_inputs():
    """The JAX run's sequence and config."""
    seq = synth_j.generate(duration=DURATION_S, n_landmarks=1200, max_keypoints=150,
                           pixel_noise=PIXEL_NOISE, seed=648)
    cfg = make_config(seq.K_mat)
    # a window of 4 keyframes (tests/test_torch_odometry.py's): the same
    # program shapes as the default window's, and the first fused keyframe
    # step a few keyframes after the initialization
    cfg.sliding_window_size = 4
    return seq, cfg


def record_jax_batch(path):
    """The JAX run (see the module docstring); its records pickled to
    `path`."""
    seq, cfg = _jax_inputs()
    odo = OdometryJ(cfg, SyntheticBackendJ(seq), caps=builders_j.Caps(**CAPS))
    rec, saved = {}, {}

    def recorder(name, fn):
        def call(*args, **kw):
            out = fn(*args, **kw)
            if name not in rec:
                rec[name] = jax.device_get((args, kw))
            return out
        return call

    for name in RECORDED:
        saved[name] = getattr(builders_j, name)
    try:
        for name in RECORDED:
            setattr(builders_j, name, recorder(name, saved[name]))
        events = sorted([(t, 1, i) for i, t in enumerate(seq.t_imu)]
                        + [(t, 0, i) for i, t in enumerate(seq.t_frame)])
        for t, kind, i in events:
            if kind == 1:
                odo.add_motion(t, seq.gyro[i], seq.accel[i])
            else:
                odo.add_frame(t, i)
                if set(RECORDED) <= set(rec):
                    break
    finally:
        for name, fn in saved.items():
            setattr(builders_j, name, fn)
    assert set(RECORDED) <= set(rec), sorted(rec)

    rec["iterations"] = rec["_fused_localize_subwindow_chain_jit"][1]["max_iterations"]
    with open(path, "wb") as fh:
        pickle.dump(rec, fh)


def run_jax_batched_sub(path, out_path):
    """The JAX package's `_batched_sub_jit` on the batch of the record at
    `path` (rows 0-2, f32 as the run made them); (batch, new chain,
    transfer) pickled to `out_path`."""
    from rd_vio_tpu.batch import dispatcher as disp_j

    with open(path, "rb") as fh:
        rec = pickle.load(fh)
    (pa_loc, pa_sub, j_slot, prev, lip, sub_prev, calib), kw = \
        rec["_fused_localize_subwindow_chain_jit"]
    rows_loc = [pa_loc, _moved(pa_loc, 1), pa_loc]
    rows_sub = [pa_sub, _moved(pa_sub, 2), pa_sub]
    chain = _stack([prev, prev, jax.tree_util.tree_map(lambda a: a + 0.5, prev)])
    batch = dict(pa_loc=_stack(rows_loc), pa_sub=_stack(rows_sub),
                 j_slots=np.full(N_ROWS, j_slot, np.int32), chain=chain,
                 lip=np.array([lip, lip, -1], np.int32),
                 sp=np.stack([sub_prev, sub_prev, np.full_like(sub_prev, -1)]),
                 active=ACTIVE)
    new_chain, transfer = jax.device_get(disp_j._batched_sub_jit(
        batch["pa_loc"], batch["pa_sub"], batch["j_slots"], batch["chain"], batch["lip"],
        batch["sp"], batch["active"], calib, kw["max_iterations"]))
    with open(out_path, "wb") as fh:
        pickle.dump((batch, new_chain, transfer), fh)


# ---------------------------------------------------------------------------
# the checks (in the child)
# ---------------------------------------------------------------------------


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _t(a):
    return torch.from_numpy(np.array(a))


def close64(a, b, what):
    """f64: within 1e-9 relative (absolute below magnitude 1)."""
    a, b = _np(a).astype(np.float64), _np(b).astype(np.float64)
    err = np.abs(a - b) / np.maximum(np.abs(a), 1.0)
    assert err.max(initial=0.0) <= 1e-9, f"{what}: {err.max():.3e} relative"


def same_row(rb, i, rs, what):
    """Row i of a batched BAResult against a single-row one: the same
    accepted steps, states and inverse depths within 1e-9 relative."""
    assert int(rb.iterations[i]) == int(rs.iterations), (what, i, rb.iterations, rs.iterations)
    for name, a, b in zip(FrameStates._fields, rb.states, rs.states):
        close64(a[i], b, f"{what} row {i} {name}")
    close64(rb.inv_depth[i], rs.inv_depth, f"{what} row {i} inv_depth")


def _row(tree, i):
    """Row i of a stacked tree (dicts, NamedTuples, tensors or arrays)."""
    if isinstance(tree, dict):
        return {k: _row(v, i) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(_row(x, i) for x in tree))
    return tree[i]


def _rows64(rows):
    """Stack host rows (port types) after casting their floats to f64."""
    return disp_t._stack_trees([up64(r) for r in rows])


def _load(path):
    with open(path, "rb") as fh:
        return pickle.load(fh)


def _check_sub(path, sub_path):
    rec = _load(path)
    batch, chain_j, transfer_j = _load(sub_path)
    it = rec["iterations"]
    calib = convert.calib_tree_from(rec["_fused_localize_subwindow_chain_jit"][0][6], "cpu")
    pa = lambda t: convert.stacked_from(t)  # noqa: E731
    up = lambda t: builders_t._up(t, "cpu")  # noqa: E731
    chain = convert.batched_chain_from(batch["chain"], "cpu")
    args = (pa(batch["pa_loc"]), pa(batch["pa_sub"]), batch["j_slots"], None,
            batch["lip"], batch["sp"])

    # f64: the batched program against single rows (the active ones)
    loc64, sub64 = (_rows64([_row(a, i) for i in range(N_ROWS)]) for a in args[:2])
    chain64 = FrameStates(*(c.double() for c in chain))
    rb = builders_t.fused_localize_subwindow_chain(
        up(loc64), up(sub64), _t(batch["j_slots"]), chain64, _t(batch["lip"]),
        _t(batch["sp"]), calib, IT_ROWS, rows=True)
    for i in np.flatnonzero(ACTIVE):
        rs = builders_t.fused_localize_subwindow_chain(
            _row(loc64, i), _row(sub64, i), int(batch["j_slots"][i]), _row(chain64, i),
            int(batch["lip"][i]), _t(batch["sp"][i]), calib, IT_ROWS)
        same_row(rb, i, rs, "batched_sub")

    # f32, as the run made it: against the JAX package's _batched_sub_jit;
    # the inactive row's chain bit-unchanged
    new_chain, transfer = disp_t.batched_sub(
        up(args[0]), up(args[1]), _t(batch["j_slots"]), chain, _t(batch["lip"]),
        _t(batch["sp"]), _t(ACTIVE), calib, it)
    assert transfer[1].dtype == torch.float32
    pj = np.asarray(transfer_j[1], np.float64)
    for i in np.flatnonzero(ACTIVE):
        d = np.abs(pj[i] - _np(transfer[1][i]).astype(np.float64)).max()
        assert d <= 1e-5, f"batched_sub f32 row {i}: positions differ by {d:.3e} m"
        for a, b in zip(new_chain, chain_j):
            assert np.abs(_np(a[i]).astype(np.float64) - np.asarray(b[i], np.float64)).max() \
                <= 1e-5
    for a, b, c in zip(new_chain, chain_j, chain):  # the inactive row on both sides
        np.testing.assert_array_equal(_np(a[2]), np.asarray(b[2]))
        assert torch.equal(a[2], c[2])
    iters = disp_t.builders.ba.ROW_ITERATIONS
    assert len(iters[-1]) == N_ROWS and len(iters) >= 2


def _kf_rows(rec):
    """The recorded keyframe step as 3 host rows (port types, f64) and the
    three priors (row 2's moved, so that its row is told apart)."""
    a, _ = rec["_fused_keyframe_jit"]
    keys = ("pa_loc", "b", "qcw", "pcw", "m_tri", "us", "tri_aqc", "tri_apc", "pa_w", "j_w",
            "wlm_tri")
    row0 = dict(zip(keys, a[:11]))
    row0["va"] = a[12]
    m_args, _ = rec["_marginalize_tail_jit"]
    row0.update(pa_m=m_args[5], mlm_vti=m_args[6], mlm_from_w=m_args[7], mlm_tri=m_args[8])
    row0 = convert.stacked_from(up64(row0))
    row1 = dict(row0, pa_loc=_moved(row0["pa_loc"], 3), pa_w=_moved(row0["pa_w"], 4, 0.01))
    prior = convert.prior_from(up64(a[11]), "cpu")
    prior2 = prior._replace(sqrt_inv_cov=prior.sqrt_inv_cov * 1.5)
    priors = F_t.PriorFactor(*(torch.stack(x) for x in zip(prior, prior, prior2)))
    return [row0, row1, row0], priors, convert.calib_tree_from(a[13], "cpu")


class _Stub:
    """A stand-in Odometry for batch_eval: tracking from its third frame,
    publishing the ground truth moved by a seeded offset."""

    def __init__(self, gt, seed):
        self.gt, self.rng, self.n = gt, np.random.default_rng(seed), 0
        self.handler = self
        self.latest = None

    def add_motion(self, t, w, a):
        pass

    def add_frame(self, t, image):
        self.n += 1
        self.latest = (t, None, self.gt(t) + 1e-3 * self.rng.standard_normal(3))

    def state(self):
        return 1 if self.n >= 3 else 0

    def get_latest_state(self):
        return self.latest


def _eval_jobs(seed):
    t = np.arange(40) * 0.05
    gt = lambda tt: np.array([np.sin(tt), np.cos(tt), 0.1 * tt])  # noqa: E731
    ev = [("imu", tt + 0.01, np.zeros(3), np.zeros(3)) for tt in t]
    ev += [("frame", tt, i) for i, tt in enumerate(t)]
    ev.sort(key=lambda e: (e[1], 0 if e[0] == "frame" else 1))
    return [(f"seq_{k}", lambda k=k: _Stub(gt, seed + k), ev, gt) for k in range(2)]


def _check_batch_eval(want):
    for parallel in (False, True):
        res = batch_eval_t.run_batch(_eval_jobs(5), parallel=parallel)
        assert set(res) == {"seq_0", "seq_1"}
        for name, r in res.items():
            assert (r.n_frames, r.n_tracked) == (want[name]["n_frames"], want[name]["n_tracked"])
            assert r.n_tracked > 30 and r.ate is not None and r.ate < 0.1
            np.testing.assert_allclose(r.ate, want[name]["ate"], rtol=1e-12)
        s = batch_eval_t.summarize(res)
        assert s["sequences"] == 2 and s["total_frames"] == want["summary"]["total_frames"]
        np.testing.assert_allclose(s["max_ate"], want["summary"]["max_ate"], rtol=1e-12)


def _check_dispatcher(path):
    """The dispatcher's protocol on the recorded problems (f32 subwindow
    rows, f64 keyframe rows), N=3 sequences, and the batched keyframe
    programs of its keyframe flush against the single-row step."""
    rec = _load(path)
    (pa_loc, pa_sub, j, _, _, _, _), _ = rec["_fused_localize_subwindow_chain_jit"]
    it = IT_ROWS
    calib_t = convert.calib_tree_from(rec["_fused_localize_subwindow_chain_jit"][0][6], "cpu")
    calib = types_calib(calib_t)
    d = disp_t.BatchDispatcher(N_ROWS, calib, it)
    builders_t.PROGRAM_STATS.clear()
    pa_loc = convert.stacked_from(_stack([pa_loc, _moved(pa_loc, 1)]))
    pa_sub = convert.stacked_from(_stack([pa_sub, _moved(pa_sub, 2)]))
    j = int(j)
    W = pa_sub.q.shape[1]
    none = np.full(W, -1, np.int32)

    # tick 1: sequences 0 and 2 submit, 1 rides as a dummy
    f0 = d.submit_sub(0, _row(pa_loc, 0), _row(pa_sub, 0), j, -1, none)
    f2 = d.submit_sub(2, _row(pa_loc, 1), _row(pa_sub, 1), j, -1, none)
    try:
        f0.wait()
        raise AssertionError("a result was readable before flush()")
    except RuntimeError:
        pass
    d.flush()
    assert builders_t.PROGRAM_STATS["batched_sub"]["calls"] == 1
    r0, r2 = f0.wait(), f2.wait()
    chain = d._chain
    q_id = torch.tensor([1.0, 0, 0, 0], dtype=chain.q.dtype)
    assert torch.equal(chain.q[1], q_id.expand_as(chain.q[1]))  # the dummy row
    assert torch.equal(chain.p[1], torch.zeros_like(chain.p[1]))
    np.testing.assert_array_equal(r0[1], _np(chain.p[0]))
    np.testing.assert_array_equal(r2[1], _np(chain.p[2]))

    # tick 2: only sequence 2, chained on its previous row; 0 rides as a
    # dummy copy of its tick-1 problem and keeps its chain row
    before = [c.clone() for c in d._chain]
    d.submit_sub(2, _row(pa_loc, 1), _row(pa_sub, 1), j, j, np.arange(W, dtype=np.int32))
    assert d._sub_cache[0][0] is not None
    d.flush()
    for a, b in zip(d._chain, before):
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])

    # prior rows: written at the next keyframe flush, read back exactly
    rows, priors, _ = _kf_rows(rec)
    for i in range(N_ROWS):
        d.put_prior_row(i, _row(priors, i))
    got = d.get_prior_row(2)
    for x, y in zip(got, _row(priors, 2)):
        assert torch.equal(x, y)
    # a keyframe tick: sequences 0 and 1 submit; their continuations run at
    # the flush, after the results are readable. Each active row equals
    # its single-row step; the dummy row's prior stays as it was.
    ran = []
    futs = {}
    for i in (0, 1):
        futs[i] = d.submit_kf(i, rows[i], continuation=lambda i=i: ran.append(
            (i, futs[i].wait()[1].copy())))
    assert not ran
    disp_t.CAPTURE_BATCH, disp_t.CAPTURED_BATCH = True, None
    try:
        d.flush()
    finally:
        disp_t.CAPTURE_BATCH = False
    assert sorted(i for i, _ in ran) == [0, 1] and d.n_kf_flushes == 1
    assert d.ever_submitted == {0, 1}
    assert builders_t.PROGRAM_STATS["batched_kf"]["calls"] == 1
    assert builders_t.PROGRAM_STATS["batched_marg"]["calls"] == 1
    res, res_loc, valid, tri_ok, tri_invd, new_priors = disp_t.CAPTURED_BATCH["out"]
    for i, p in ran:
        np.testing.assert_array_equal(p, _np(res.states.p[i]))
    for i in (0, 1):
        rs, rls, vs, oks, tis, prior_s = builders_t.run_keyframe_fused(
            rows[i], _row(priors, i), calib_t, it)
        same_row(res, i, rs, "batched_kf window")
        same_row(res_loc, i, rls, "batched_kf localize")
        np.testing.assert_array_equal(_np(valid[i]), _np(vs))
        np.testing.assert_array_equal(_np(tri_ok[i]), _np(oks))
        ok = _np(oks)
        close64(_np(tri_invd[i])[ok], _np(tis)[ok], f"batched_kf row {i} tri_invd")
        same_prior(prior_s, d.get_prior_row(i), f"batched_marg row {i}")
    for x, y in zip(d.get_prior_row(2), _row(priors, 2)):
        assert torch.equal(x, y)


def types_calib(tree):
    """builders.CalibArrays whose device tree is `tree` (on the CPU)."""
    c = builders_t.CalibArrays(K=np.eye(3), sqrt_inv_cov2=np.eye(2), q_bc_h=np.zeros(4),
                               p_bc_h=np.zeros(3), q_bi_h=np.zeros(4), p_bi_h=np.zeros(3),
                               cov_w_h=np.eye(3), cov_a_h=np.eye(3), cov_bg_h=np.eye(3),
                               cov_ba_h=np.eye(3), device="cpu")
    return dataclasses.replace(c, _tree=tree)


def test_batched_programs_match_rows_and_jax(child, jax_side, tmp_path):
    path, sub_path = str(tmp_path / "jax_batch.pkl"), str(tmp_path / "jax_sub.pkl")
    child(int, 0)  # the child starts here, before jax_side sets its environment
    record = jax_ref(jax_side, "batch_record", (*_jax_inputs(), CAPS), file_output,
                     record_jax_batch, path)()
    with open(path, "wb") as fh:
        fh.write(record)
    # the JAX batched program and the dispatcher's checks (which need only
    # the record) run at once, each in its own process
    jax_sub = jax_ref(jax_side, "batch_sub", record, file_output, run_jax_batched_sub, path,
                      sub_path)
    child(_check_dispatcher, path)
    with open(sub_path, "wb") as fh:
        fh.write(jax_sub())
    child(_check_sub, path, sub_path)


def test_batch_eval_matches_jax(child):
    res = batch_eval_j.run_batch(_eval_jobs(5))
    want = {k: dict(n_frames=r.n_frames, n_tracked=r.n_tracked, ate=r.ate)
            for k, r in res.items()}
    want["summary"] = batch_eval_j.summarize(res)
    child(_check_batch_eval, want)
