"""Port parity of the landmark-sharded distributed BA
(rd_vio_tpu_torch/parallel/dist_ba.py) on the CPU.

The problem is tests/test_dist_ba.py's (W=6, L=192, O=1024, frame 0 fixed,
its perturbation from seed 5), built in the child by the port's copy of
the synthetic window problem and handed to both packages as NumPy arrays.
A `jax_side` process relays it out for 4 shards and solves it with the JAX
package's `solve_ba_sharded` on a 4-device mesh (the suite's virtual CPU
devices). In the child the port:
- relays the same problem out: new_slot, every reprojection array, the
  landmark mask and the inverse depths equal to the JAX package's bit for
  bit, and the cost of the relaid problem equal to the original's within
  1e-9 relative (tests/test_dist_ba.py's bound);
- solves the relaid problem over 4 gloo ranks on the CPU (the child is rank
  0, the others processes of `python -m rd_vio_tpu_torch.parallel.dist_ba`,
  each with a 30 s collective timeout): p, q and the optimized inverse
  depths within 1e-8 (tests/test_dist_ba.py's tolerance) of the JAX
  package's sharded solve and of the port's own `solve_ba` of the same
  problem, every rank on the same count of LM iterations, every serving
  rank exiting 0 once stopped.
A last check holds the group to failing fast: a rank that dies in a solve,
and a rank that joins and never answers, each make rank 0 raise, the first
at once and the second within the group's timeout (3 s), never hang.
"""

import time

import numpy as np
import jax

from tests.test_torch_image import IN_CHILD, child, jax_ref, jax_side  # noqa: F401

if IN_CHILD:  # the port loads only where the checks run (test_torch_image)
    import torch

    from rd_vio_tpu_torch.estimation import ba as ba_t
    from rd_vio_tpu_torch.parallel import dist_ba as dist_t

W = 6
N_SHARDS = 4
ITERS = 8
TOL = 1e-8
RANK_TIMEOUT_S = 30.0


# the nested NamedTuple of each field of the estimator's problem, by name
_NESTED = {"BAProblem": {"reproj": "ReprojFactors", "reproj_prior": "ReprojPriorFactors",
                         "imu": "ImuFactors", "imu_prior": "ImuPriorFactors",
                         "rot": "RotFactors", "prior": "PriorFactor",
                         "ext": "Extrinsics"},
           "ImuFactors": {"delta": "PreintDelta"},
           "ImuPriorFactors": {"delta": "PreintDelta"}}


def _flat(tree, prefix=""):
    """A NamedTuple tree of tensors as {dotted path: NumPy array}."""
    out = {}
    for name, v in zip(tree._fields, tree):
        if hasattr(v, "_fields"):
            out.update(_flat(v, prefix + name + "."))
        else:
            out[prefix + name] = v.numpy() if hasattr(v, "numpy") else np.asarray(v)
    return out


def _tree(classes, cls, flat, prefix=""):
    """The inverse of _flat, with one package's NamedTuple classes (by
    name, from _classes); leaves as they are in `flat`."""
    nested = _NESTED.get(cls, {})
    return classes[cls](**{
        f: _tree(classes, nested[f], flat, prefix + f + ".") if f in nested
        else flat[prefix + f] for f in classes[cls]._fields})


def _classes(ba, factors, preint_delta):
    """A package's problem NamedTuples by name."""
    return dict(BAProblem=ba.BAProblem, PreintDelta=preint_delta, **{
        n: getattr(factors, n) for n in ("ReprojFactors", "ReprojPriorFactors", "ImuFactors",
                                         "ImuPriorFactors", "RotFactors", "PriorFactor",
                                         "Extrinsics")})


def _port_problem():
    """tests/test_dist_ba.py's problem, start and perturbation (seed 5),
    built by the port's copy of the JAX package's synthetic window problem,
    as NumPy arrays: (states0, invd0, problem)."""
    from rd_vio_tpu_torch.datasets import synthetic
    from rd_vio_tpu_torch.datasets.synthetic_problems import build_window_problem
    from rd_vio_tpu_torch.estimation.state import ES_SIZE, retract

    seq = synthetic.generate(duration=6.0, n_landmarks=500, max_keypoints=100)
    states_gt, invd_gt, pb, _, _ = build_window_problem(
        seq, f0=10, W=W, L_max=192, O_max=1024, device="cpu")
    fixed0 = torch.arange(W) > 0
    pb = pb._replace(opt_pose=pb.opt_pose & fixed0, opt_motion=pb.opt_motion & fixed0)
    rng = np.random.default_rng(5)
    d = np.zeros((W, ES_SIZE))
    d[1:, 0:3] = rng.standard_normal((W - 1, 3)) * 0.01
    d[1:, 3:6] = rng.standard_normal((W - 1, 3)) * 0.03
    states0 = retract(states_gt, torch.from_numpy(d))
    invd0 = torch.clamp(invd_gt * 1.05, min=1e-3)
    return _flat(states0), invd0.numpy(), _flat(pb)


def _jax_relayout_and_solve(states0, invd0, pb):
    """The JAX package's relayout for N_SHARDS and its sharded solve on an
    N_SHARDS mesh, whole under jax.jit (called as it is, shard_map runs op
    by op, ~10x slower on the CPU)."""
    import jax.numpy as jnp

    from rd_vio_tpu.estimation import ba, factors
    from rd_vio_tpu.estimation.state import FrameStates
    from rd_vio_tpu.ops.preintegration import PreintDelta
    from rd_vio_tpu.parallel import dist_ba

    pb = jax.tree_util.tree_map(
        jnp.asarray, _tree(_classes(ba, factors, PreintDelta), "BAProblem", pb))
    s0 = FrameStates(**{k: jnp.asarray(v) for k, v in states0.items()})
    mesh = dist_ba.make_vio_mesh(N_SHARDS)
    invd_s, pb_s, new_slot = dist_ba.relayout_for_sharding(jnp.asarray(invd0), pb, N_SHARDS)
    invd_dev, pb_dev = dist_ba.shard_problem(mesh, invd_s, pb_s)
    solve = jax.jit(lambda s, i, p: dist_ba.solve_ba_sharded(s, i, p, mesh,
                                                             max_iterations=ITERS))
    s_d, invd_d, _ = solve(s0, invd_dev, pb_dev)
    return dict(invd_s=np.asarray(invd_s), opt_lm=np.asarray(pb_s.opt_lm),
                reproj={k: np.asarray(v) for k, v in pb_s.reproj._asdict().items()},
                new_slot=new_slot, p=np.asarray(s_d.p), q=np.asarray(s_d.q),
                invd=np.asarray(invd_d))


def _check_relayout_and_sharded_solve(prob, j):
    from rd_vio_tpu_torch.estimation import factors as F_t
    from rd_vio_tpu_torch.estimation.state import FrameStates
    from rd_vio_tpu_torch.ops.preintegration import PreintDelta

    states_h, invd_h, pb_h = prob
    states0 = FrameStates(**{k: torch.from_numpy(v) for k, v in states_h.items()})
    invd0 = torch.from_numpy(invd_h)
    pb = _tree(_classes(ba_t, F_t, PreintDelta), "BAProblem",
               {k: torch.from_numpy(v) for k, v in pb_h.items()})

    # (a) the relayout, bit for bit, and the cost it preserves
    invd_s, pb_s, new_slot = dist_t.relayout_for_sharding(invd0, pb, N_SHARDS)
    np.testing.assert_array_equal(new_slot, j["new_slot"])
    np.testing.assert_array_equal(invd_s.numpy(), j["invd_s"])
    np.testing.assert_array_equal(pb_s.opt_lm.numpy(), j["opt_lm"])
    for name, a in zip(pb_s.reproj._fields, pb_s.reproj):
        ref = j["reproj"][name]
        assert a.numpy().dtype == ref.dtype, (name, a.dtype, ref.dtype)
        np.testing.assert_array_equal(a.numpy(), ref, err_msg=name)
    c0 = float(ba_t.compute_cost(states0, invd0, pb))
    c1 = float(ba_t.compute_cost(states0, invd_s, pb_s))
    assert abs(c0 - c1) <= 1e-9 * max(1.0, abs(c0)), (c0, c1)

    # (b) the sharded solve over N_SHARDS gloo ranks on the CPU
    init = dist_t.local_init_method()
    ranks = dist_t.RankProcesses(N_SHARDS, "gloo", init, device="cpu",
                                 timeout_s=RANK_TIMEOUT_S, threads=1)
    try:
        group = dist_t.make_group(0, N_SHARDS, "gloo", init, device="cpu",
                                  timeout_s=RANK_TIMEOUT_S)
        s_d, invd_d, cost_d = dist_t.solve_on_group(group, states0, invd_s, pb_s,
                                                     max_iterations=ITERS)
        info = dict(group.last_solve)
        dist_t.stop_serving(group)
    finally:
        dist_t.close_group()
        exits = ranks.wait(RANK_TIMEOUT_S)
    assert all(rc == 0 for rc, _ in exits), exits
    assert info["rank_iterations"] == [info["iterations"]] * N_SHARDS, info
    # per iteration one packed all_reduce and one of the cost, and the first cost's
    assert info["all_reduce_calls"] == 2 * info["iterations"] + 1, info
    assert all(bool(torch.isfinite(a).all()) for a in (*s_d, invd_d, cost_d))
    single = ba_t.solve_ba(states0, invd_s, pb_s, max_iterations=ITERS)
    opt = pb_s.opt_lm.numpy()
    for ref_p, ref_q, ref_invd in ((j["p"], j["q"], j["invd"]),
                                   (single.states.p, single.states.q, single.inv_depth)):
        np.testing.assert_allclose(s_d.p.numpy(), np.asarray(ref_p), rtol=0, atol=TOL)
        np.testing.assert_allclose(s_d.q.numpy(), np.asarray(ref_q), rtol=0, atol=TOL)
        np.testing.assert_allclose(invd_d.numpy()[opt], np.asarray(ref_invd)[opt],
                                   rtol=0, atol=TOL)
    assert float(cost_d) < 1e-3 * c0  # it converged


def test_relayout_and_sharded_solve_match_jax(child, jax_side):
    prob = child(_port_problem)
    want = jax_ref(jax_side, "dist_ba", prob, _jax_relayout_and_solve, *prob)()
    child(_check_relayout_and_sharded_solve, prob, want)


# a rank that joins, takes rank 0's first command and then dies, or never
# answers again; it says when it has imported the port, so that the group's
# short timeout bounds the fault and not the rank's start
_FAULTY_RANK = (
    "import os, sys, time\n"
    "from rd_vio_tpu_torch.parallel import dist_ba\n"
    "print('imported', flush=True)\n"
    "g = dist_ba.make_group(1, 2, 'gloo', sys.argv[1], device='cpu', timeout_s=3.0)\n"
    "dist_ba._command(g)\n"
    "if sys.argv[2] == 'die':\n"
    "    os._exit(3)\n"
    "time.sleep(300)\n"
)


def _check_faulty_rank_raises(mode):
    """Rank 0's solve_on_group raises (within 5 s of the fault, or the
    group's 3 s timeout plus 10 s), and its group closes."""
    import select
    import subprocess
    import sys
    from pathlib import Path

    from rd_vio_tpu_torch.datasets import synthetic
    from rd_vio_tpu_torch.datasets.synthetic_problems import build_window_problem

    seq = synthetic.generate(duration=1.0, n_landmarks=200, max_keypoints=60)
    states, invd, pb, _, _ = build_window_problem(seq, f0=2, W=3, L_max=32, O_max=128,
                                                  device="cpu")
    invd, pb, _ = dist_t.relayout_for_sharding(invd, pb, 2)
    init = dist_t.local_init_method()
    root = Path(dist_t.__file__).resolve().parents[2]
    proc = subprocess.Popen([sys.executable, "-c", _FAULTY_RANK, init, mode], cwd=root,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        ready, _, _ = select.select([proc.stdout], [], [], 120.0)
        assert ready and proc.stdout.readline().strip() == "imported"
        group = dist_t.make_group(0, 2, "gloo", init, device="cpu", timeout_s=3.0)
        t0 = time.perf_counter()
        try:
            dist_t.solve_on_group(group, states, invd, pb, max_iterations=4)
        except RuntimeError as e:
            waited = time.perf_counter() - t0
            err = e
        else:
            raise AssertionError(f"rank 0 did not raise when its peer {mode}")
    finally:
        dist_t.close_group()
        proc.kill()
        proc.wait()
    assert waited < (5.0 if mode == "die" else 13.0), (mode, waited, err)
    return waited


def test_faulty_rank_makes_rank_0_raise(child):
    for mode in ("die", "hang"):
        child(_check_faulty_rank_raises, mode)
