"""The LK kernels on the card: the fused forward + reverse kernel and the
per-level kernel against their plain versions, launch counting, a keypoint
set that trips every status rule, and the wrappers' input checks; and the
window VI-BA solve on the card against the same solve on the CPU; a few
frames of Odometry (the synthetic backend) on the card, synchronous, and
threaded with the device PARSAC, which is also held against the CPU; the
batched LM solve of the lockstep runtime, its CUDA-graph replay against its
eager run and its rows against single solves, a short lockstep run on
the card, and the undistortion's remap against its CPU run; the
landmark-sharded solve over NCCL and over gloo ranks on the card, and a
tracker checkpoint's round trip on the card with bicubic intensity. Every
test is marked `cuda` and skips where there is no CUDA device; this file
imports no JAX, so on a GPU machine without JAX it runs as

    python -m pytest --noconftest tests/test_torch_cuda.py -q

chip_smoke.py phase A makes the kernel-vs-plain comparisons at the slice's
full sizes. torch and the port are imported inside the tests, so that a
test runner without a card never loads them.
"""

import shutil

import numpy as np
import pytest

N = 64


@pytest.fixture
def dev():
    if shutil.which("nvidia-smi") is None:
        pytest.skip("needs a CUDA device and nvcc (no nvidia-smi here; "
                    "chip_smoke.py phase A runs this comparison on the card)")
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (chip_smoke.py phase A "
                    "runs this comparison on the card)")
    return torch.device("cuda", 0)


def _pair(dev):
    import torch

    from rd_vio_tpu_torch.datasets import synthetic
    from rd_vio_tpu_torch.datasets.renderer import SequenceRenderer
    from rd_vio_tpu_torch.ops.image import gftt, pyramid

    seq = synthetic.generate(duration=0.2, n_landmarks=1200, excitation=0.05)
    rend = SequenceRenderer(seq, image_size=(320, 240))
    a, b = (torch.from_numpy(np.asarray(rend.render(i), np.float32)).to(dev)
            for i in (0, 2))
    pix, val, _ = gftt.detect_gftt(a, torch.zeros((1, 2), device=dev),
                                   torch.zeros(1, dtype=torch.bool, device=dev),
                                   max_points=N, min_dist=10.0)
    return pyramid.build_pyramid(a, 3), pyramid.build_pyramid(b, 3), pix, val


def _agreement(a, b):
    """(status agreement, agreed tracks, median flow difference in px)."""
    (tr_a, st_a), (tr_b, st_b) = a, b
    st_a, st_b = st_a.cpu().numpy(), st_b.cpu().numpy()
    both = st_a & st_b
    d = np.linalg.norm(tr_a.cpu().numpy()[both] - tr_b.cpu().numpy()[both], axis=-1)
    return (st_a == st_b).mean(), both.sum(), np.median(d)


@pytest.mark.cuda
def test_fused_kernel_matches_plain(dev):
    import torch

    from rd_vio_tpu_torch.ops.image import klt

    pa, pb, pix, val = _pair(dev)
    before = klt.launches, klt.fwd_rev_launches
    out_k = klt.lk_track_fwd_rev(pa, pb, pix, pix, val)
    torch.cuda.synchronize()
    assert klt.fwd_rev_launches - before[1] == 1  # one launch per call
    klt.lk_track_fwd_rev(pa, pb, pix, pix, val)
    assert klt.fwd_rev_launches - before[1] == 2
    assert klt.launches == before[0]  # and none of the per-level kernel
    out_p = klt.lk_track_fwd_rev_plain(pa, pb, pix, pix, val)
    # status agreement >= 0.995, median flow difference <= 1e-3 px
    agree, n, med = _agreement(out_k, out_p)
    assert agree >= 0.995 and n > 30
    assert med <= 1e-3


@pytest.mark.cuda
def test_level_kernel_path_matches_plain(dev):
    import torch

    from rd_vio_tpu_torch.ops.image import klt

    pa, pb, pix, val = _pair(dev)
    before = klt.launches, klt.fwd_rev_launches
    out_k = klt.lk_track_fwd_rev_plain(pa, pb, pix, pix, val, level=klt.lk_level)
    torch.cuda.synchronize()
    assert klt.launches - before[0] == 8  # 4 levels x 2 directions
    assert klt.fwd_rev_launches == before[1]
    out_p = klt.lk_track_fwd_rev_plain(pa, pb, pix, pix, val)
    agree, n, med = _agreement(out_k, out_p)
    assert agree >= 0.995 and n > 30
    assert med <= 1e-3
    # the iteration counts of one level: kernel and plain stop together,
    # but for a step that lands within rounding of the 0.01 px threshold
    p = (pix + klt.PADB).contiguous()
    _, _, it_k = klt.lk_level_iters(pa[0], pb[0], p, p, val)
    _, _, it_p = klt._lk_level_plain_iters(pa[0], pb[0], p, p, val, 30, 0.01)
    assert it_k.dtype == torch.int32
    assert ((it_k - it_p).abs() <= 1).float().mean() >= 0.95
    assert (it_k[~val] == 0).all()


@pytest.mark.cuda
def test_fused_kernel_status_rules(dev):
    import torch

    from rd_vio_tpu_torch.ops.image import klt, pyramid
    from rd_vio_tpu_torch.tools import lk_bench

    pa, pb, pix, val = _pair(dev)
    flat = (90, 150, 130, 190)
    pa = pyramid.build_pyramid(lk_bench.paint_flat_patch(pa[0], flat), 3)
    pb = pyramid.build_pyramid(lk_bench.paint_flat_patch(pb[0], flat), 3)
    pts, pred, valid, kind = lk_bench.edge_case_keypoints(
        pix[val].cpu().numpy(), N, 240, 320, flat, seed=2, per_kind=6)
    args = (pa, pb, *(torch.from_numpy(x).to(dev) for x in (pts, pred, valid)))
    _, st_k = klt.lk_track_fwd_rev(*args)
    _, st_p = klt.lk_track_fwd_rev_plain(*args)
    st_k, st_p = st_k.cpu().numpy(), st_p.cpu().numpy()
    np.testing.assert_array_equal(st_k, st_p)  # exactly equal
    assert not st_k[kind >= 0].any() and st_k[kind < 0].sum() > 20


@pytest.mark.cuda
def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    from rd_vio_tpu_torch.ops.image import klt

    pa, pb, pix, val = _pair(dev)
    p = (pix + klt.PADB).contiguous()
    args = [pa[0], pb[0], p, p, val]
    bad = [
        (0, pa[0].double()),  # dtype
        (0, pa[0].t()),  # contiguity (and shape)
        (2, p.cpu()),  # device
        (4, val[:-1]),  # shape
    ]
    for i, t in bad:
        a = list(args)
        a[i] = t
        with pytest.raises(ValueError):
            klt.lk_level(*a)

    wide = pa[1].repeat(1, 2)[:, :pa[1].shape[1]]  # right shape, strided
    assert wide.shape == pa[1].shape and not wide.is_contiguous()
    bad = [
        (pa, pb, pix.cpu(), pix, val),  # device
        (pa, pb, pix.double(), pix, val),  # dtype of the keypoints
        ([pa[0].double()] + pa[1:], pb, pix, pix, val),  # dtype of a level
        ([pa[0], wide] + pa[2:], pb, pix, pix, val),  # non-contiguous level
        (pa + pa + pa[:1], pb + pb + pb[:1], pix, pix, val),  # 9 levels
        (pa, pb[:3], pix, pix, val),  # unequal pyramids: level count
        (pa, pb[:3] + [pb[2]], pix, pix, val),  # unequal pyramids: a shape
        (pa, pb, pix, pix, val[:-1]),  # shape
    ]
    before = klt.fwd_rev_launches
    for a in bad:
        with pytest.raises(ValueError):
            klt.lk_track_fwd_rev(*a)
    assert klt.fwd_rev_launches == before


@pytest.mark.cuda
def test_window_solve_on_the_card_matches_the_cpu(dev):
    # the f64 LM solve of the entry point's window (W=6, L=64, O=256) from
    # test_ba.py's perturbation: the card takes the same accepted steps as
    # the CPU, or one more or fewer (index_add_ adds with atomics, cuBLAS in
    # another order), and lands within 1e-6 m of it and 5e-3 m of the truth
    import torch

    from rd_vio_tpu_torch.datasets import synthetic
    from rd_vio_tpu_torch.datasets.synthetic_problems import (
        build_window_problem, perturbed_start)
    from rd_vio_tpu_torch.estimation import ba

    seq = synthetic.generate(duration=4.0, n_landmarks=300, max_keypoints=40)
    out = {}
    for d in ("cpu", dev):
        gt, invd, pb, _, _ = build_window_problem(seq, f0=10, W=6, L_max=64,
                                                  O_max=256, device=d)
        res = ba.solve_ba(*perturbed_start(gt, invd, pb), max_iterations=30)
        out[str(d)] = (gt, res)
    gt, cpu = out["cpu"]
    card = out[str(dev)][1]
    assert card.states.p.device.type == "cuda"
    assert abs(int(card.iterations) - int(cpu.iterations)) <= 1
    assert float(card.cost) < 1e-3 * float(card.initial_cost)
    p_card = card.states.p.cpu()
    assert torch.isfinite(p_card).all()
    assert (p_card - cpu.states.p).abs().max() <= 1e-6
    assert (p_card - gt.p).abs().max() <= 5e-3


@pytest.mark.cuda
def test_odometry_runs_on_the_card(dev):
    """Odometry with the perfect-match synthetic backend on the card through
    its initialization and a few tracked frames: the estimator's tensors on
    the card, finite published poses within 0.05 m of the truth after SE3
    alignment (tests/test_e2e_synthetic.py's bound)."""
    from rd_vio_tpu_torch.config import Config
    from rd_vio_tpu_torch.datasets import synthetic
    from rd_vio_tpu_torch.models import builders
    from rd_vio_tpu_torch.models.feature_tracker import SyntheticBackend
    from rd_vio_tpu_torch.models.odometry import Odometry
    from rd_vio_tpu_torch.utils.trajectory import ate_rmse

    seq = synthetic.generate(duration=2.4, n_landmarks=1200, max_keypoints=150, seed=648)
    cfg = Config()
    cfg.camera_intrinsic = seq.K_mat
    cfg.sliding_window_size = 4
    cfg.ransac_hypotheses = 128
    odo = Odometry(cfg, SyntheticBackend(seq), caps=builders.Caps(
        W=13, L=256, O=1536, Fi=16, R=128, IMU=64, IMU_KF=384))
    assert odo.device.type == "cuda" and odo.calib.tree.cov_w.device.type == "cuda"
    events = sorted([(t, 1, i) for i, t in enumerate(seq.t_imu)]
                    + [(t, 0, i) for i, t in enumerate(seq.t_frame)])
    est_t, est_p = [], []
    for t, kind, i in events:
        if kind == 1:
            odo.add_motion(t, seq.gyro[i], seq.accel[i])
            continue
        odo.add_frame(t, i)
        if odo.state() == 1:
            ls = odo.handler.get_latest_state()
            if ls is not None and (not est_t or ls[0] != est_t[-1]):
                est_t.append(ls[0])
                est_p.append(ls[2])
    assert len(est_p) >= 5 and np.isfinite(est_p).all()
    gt_by_t = {round(t, 6): p for t, p in zip(seq.t_frame, seq.p_wb)}
    gt = np.stack([gt_by_t[round(t, 6)] for t in est_t])
    assert ate_rmse(np.asarray(est_p), gt) < 0.05


@pytest.mark.cuda
def test_threaded_device_parsac_odometry_on_the_card(dev):
    """The threaded Odometry with the device PARSAC (parsac_host_masks=False)
    on the card, the synthetic backend: the workers run, every frame after
    the first tracked one is estimated, the device judge ran, the ATE under
    0.05 m, both workers exit on close(). Then imu_parsac_pnp on the card
    against the same call on the CPU: masks within 2 slots, confidences
    within 1e-9 (atomic against sequential f64 bin sums)."""
    import torch

    from rd_vio_tpu_torch.config import Config
    from rd_vio_tpu_torch.datasets import synthetic
    from rd_vio_tpu_torch.datasets.synthetic_problems import pnp_scene
    from rd_vio_tpu_torch.models import builders
    from rd_vio_tpu_torch.models import sliding_window_tracker as swt
    from rd_vio_tpu_torch.models.feature_tracker import SyntheticBackend
    from rd_vio_tpu_torch.models.odometry import Odometry
    from rd_vio_tpu_torch.ops import parsac
    from rd_vio_tpu_torch.ops.ransac import GumbelSource
    from rd_vio_tpu_torch.utils.trajectory import ate_rmse

    seq = synthetic.generate(duration=2.4, n_landmarks=1200, max_keypoints=150, seed=648)
    cfg = Config()
    cfg.camera_intrinsic = seq.K_mat
    cfg.sliding_window_size = 4
    cfg.ransac_hypotheses = 128
    cfg.parsac_flag = True
    cfg.parsac_dynamic_probability = 0.15
    cfg.parsac_threshold = 1.0
    cfg.parsac_host_masks = False
    judged = swt.PARSAC_STATS["judge"]
    odo = Odometry(cfg, SyntheticBackend(seq), caps=builders.Caps(
        W=13, L=256, O=1536, Fi=16, R=128, IMU=64, IMU_KF=384), threaded=True)
    published = []
    odo.frontend.on_publish = lambda lo: published.append((lo[0], lo[3].copy()))
    events = sorted([(t, 1, i) for i, t in enumerate(seq.t_imu)]
                    + [(t, 0, i) for i, t in enumerate(seq.t_frame)])
    try:
        for t, kind, i in events:
            if kind == 1:
                odo.add_motion(t, seq.gyro[i], seq.accel[i])
            else:
                odo.add_frame(t, i)
        odo.join()
        assert odo.handler.get_latest_state()[0] == seq.t_frame[-1]
    finally:
        odo.close()
    assert not odo.handler._ft_worker.is_alive() and not odo.handler._fe_worker.is_alive()
    assert swt.PARSAC_STATS["judge"] > judged
    est_t = np.array([t for t, _ in published])
    first = int(np.flatnonzero(np.isclose(seq.t_frame, est_t[0]))[0])
    np.testing.assert_array_equal(est_t, seq.t_frame[first:])
    est_p = np.stack([p for _, p in published])
    gt_by_t = {round(t, 6): p for t, p in zip(seq.t_frame, seq.p_wb)}
    assert ate_rmse(est_p, np.stack([gt_by_t[round(t, 6)] for t in est_t])) < 0.05

    sc = pnp_scene(4, n=256)
    out = {}
    for d in ("cpu", dev):
        t = lambda a: torch.from_numpy(np.asarray(a)).to(d)  # noqa: E731
        g = GumbelSource(5, "cpu").draw((32, 256)).to(d)
        out[str(d)] = parsac.imu_parsac_pnp(
            g, t(sc["x_world"]), t(sc["p_norm"]), t(sc["valid"]), t(sc["lens"]),
            t(sc["R_cw"]), t(sc["t_cw"]), parsac.default_bin_confidences(d),
            threshold=1.0 / 460.0, dynamic_prob=0.15)
    cpu, card = out["cpu"], out[str(dev)]
    assert card.inlier_mask.device.type == "cuda"
    assert int((card.inlier_mask.cpu() != cpu.inlier_mask).sum()) <= 2
    assert bool(card.prior_ok.cpu()) == bool(cpu.prior_ok)
    assert float((card.bin_confidences.cpu() - cpu.bin_confidences).abs().max()) <= 1e-9
    assert int(cpu.inlier_count) > 0.5 * sc["valid"].sum()


@pytest.mark.cuda
def test_batched_solve_graphed_matches_eager_and_rows(dev):
    """estimation/ba.solve_ba_rows on the card: its LM iteration replayed
    from a CUDA graph against the same solve run eagerly, and each row
    against its single-row solve_ba. The kernels are the same, but the
    card's atomic sums (index_add) round differently from run to run, and
    the last step of a converged solve may then be accepted on one side
    only (graphed 7, 7, 7 against eager 7, 7, 6 in the first run on the
    card): accepted steps within 1, positions within 1e-6 m, in f64."""
    import torch
    from torch.utils._pytree import tree_map

    from rd_vio_tpu_torch.datasets import synthetic
    from rd_vio_tpu_torch.datasets.synthetic_problems import (
        build_window_problem, perturbed_start)
    from rd_vio_tpu_torch.estimation import ba

    seq = synthetic.generate(duration=2.0, n_landmarks=600, max_keypoints=100, seed=3)
    probs = [perturbed_start(*build_window_problem(seq, f0, 8, L_max=64, O_max=1024,
                                                   device=dev)[:3], seed=s)
             for f0, s in ((2, 7), (6, 8), (10, 9))]
    S, I, P = (tree_map(lambda *x: torch.stack(x), *[p[k] for p in probs]) for k in range(3))
    graphed = ba.solve_ba_rows(S, I, P, max_iterations=15)
    ba.ROW_GRAPHS = False
    try:
        eager = ba.solve_ba_rows(S, I, P, max_iterations=15)
    finally:
        ba.ROW_GRAPHS = True
    assert int((graphed.iterations - eager.iterations).abs().max()) <= 1
    assert float((graphed.states.p - eager.states.p).abs().max()) <= 1e-6
    for i, (s, iv, pb) in enumerate(probs):
        r = ba.solve_ba(s, iv, pb, max_iterations=15)
        assert abs(int(r.iterations) - int(graphed.iterations[i])) <= 1
        assert float((r.states.p - graphed.states.p[i]).abs().max()) <= 1e-6


@pytest.mark.cuda
def test_batch_runtime_on_the_card(dev):
    """A short lockstep run of three sequences (window of 4 keyframes, so
    that batched keyframe steps come early) on the card: every sequence
    tracks with finite poses, batched keyframe flushes ran, the native
    library was called."""
    from rd_vio_tpu_torch import native
    from rd_vio_tpu_torch.batch import run_sequences_lockstep
    from rd_vio_tpu_torch.config import Config
    from rd_vio_tpu_torch.datasets import synthetic
    from rd_vio_tpu_torch.models import builders
    from rd_vio_tpu_torch.models.feature_tracker import SyntheticBackend

    seqs = [synthetic.generate(duration=2.5, n_landmarks=1200, max_keypoints=150,
                               seed=648 + 7 * i) for i in range(3)]
    cfgs = []
    for q in seqs:
        cfg = Config()
        cfg.camera_intrinsic, cfg.sliding_window_size, cfg.parsac_flag = q.K_mat, 4, True
        cfgs.append(cfg)
    native.CALLS.clear()
    caps = builders.Caps(W=13, L=128, O=1024, Fi=16, R=64, IMU=64, IMU_KF=384)
    n, est, _, kf = run_sequences_lockstep(cfgs, [SyntheticBackend(q) for q in seqs], seqs,
                                           caps=caps)
    assert n == len(seqs[0].t_frame) and kf[-1] >= 1
    for e in est:
        assert len(e) > 5 and np.isfinite(np.stack([p for _, p in e])).all()
    assert native.CALLS["preintegrate_batch"] > 0


@pytest.mark.cuda
def test_remap_matches_cpu(dev):
    """The undistortion's remap (ops/image/undistort.remap_bilinear) on the
    card against its run on the CPU, at EuRoC cam0's 752x480 with its
    radtan coefficients: equal bit for bit (the blend's fused steps are
    written out, so neither side contracts them its own way)."""
    import torch

    from rd_vio_tpu_torch.ops.image.undistort import build_remap, remap_bilinear

    K = np.array([[458.654, 0.0, 367.215], [0.0, 457.296, 248.375], [0.0, 0.0, 1.0]])
    dist = np.array([-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05])
    maps = build_remap(K, dist, "radtan", 752, 480)
    rng = np.random.default_rng(5)
    img = rng.uniform(0, 255, (480, 752)).astype(np.float32)
    args = [torch.from_numpy(a) for a in (img, *maps)]
    cpu = remap_bilinear(*args).numpy()
    card = remap_bilinear(*(a.to(dev) for a in args))
    assert card.device.type == "cuda" and card.dtype == torch.float32
    np.testing.assert_array_equal(card.cpu().numpy(), cpu)


@pytest.mark.cuda
def test_sharded_solve_on_the_card(dev):
    """The landmark-sharded solve (parallel/dist_ba.py) of the entry
    point's window on the card: over NCCL at world size 1, and over 2 gloo
    ranks on the one card (collectives staged through pinned host
    buffers), each within 1e-6 m of the single-card solve_ba of the same
    relaid problem, every rank on the same LM iterations."""
    import torch

    from rd_vio_tpu_torch.datasets import synthetic
    from rd_vio_tpu_torch.datasets.synthetic_problems import (
        build_window_problem, perturbed_start)
    from rd_vio_tpu_torch.estimation import ba
    from rd_vio_tpu_torch.parallel import dist_ba

    seq = synthetic.generate(duration=4.0, n_landmarks=300, max_keypoints=40)
    gt, invd, pb, _, _ = build_window_problem(seq, f0=10, W=6, L_max=64, O_max=256,
                                              device=dev)
    s0, invd0, pb = perturbed_start(gt, invd, pb)
    for backend, n in (("nccl", 1), ("gloo", 2)):
        invd_s, pb_s, _ = dist_ba.relayout_for_sharding(invd0, pb, n)
        init = dist_ba.local_init_method()
        ranks = dist_ba.RankProcesses(n, backend, init, device=dev, timeout_s=60.0)
        try:
            group = dist_ba.make_group(0, n, backend, init, device=dev, timeout_s=60.0)
            assert group.staged == (backend == "gloo")
            s, invd_d, _ = dist_ba.solve_on_group(group, s0, invd_s, pb_s, max_iterations=30)
            its = group.last_solve["rank_iterations"]
            dist_ba.stop_serving(group)
        finally:
            dist_ba.close_group()
            exits = ranks.wait(60.0)
        assert all(rc == 0 for rc, _ in exits), exits
        assert its == [its[0]] * n
        ref = ba.solve_ba(s0, invd_s, pb_s, max_iterations=30)
        assert s.p.device.type == "cuda" and bool(torch.isfinite(invd_d).all())
        assert float((s.p - ref.states.p).abs().max()) <= 1e-6


@pytest.mark.cuda
def test_checkpoint_round_trip_on_the_card(dev, tmp_path):
    """A few frames of Odometry on the card (the synthetic backend, the
    device PARSAC), its tracker saved and loaded back onto the card: every
    array of the two trackers' states equal, the generator's state
    included; and bicubic intensity on the card against the CPU."""
    import torch

    from rd_vio_tpu_torch.config import Config
    from rd_vio_tpu_torch.datasets import synthetic
    from rd_vio_tpu_torch.models import builders
    from rd_vio_tpu_torch.models.feature_tracker import SyntheticBackend
    from rd_vio_tpu_torch.models.odometry import Odometry
    from rd_vio_tpu_torch.ops.image import intensity
    from rd_vio_tpu_torch.utils import checkpoint

    seq = synthetic.generate(duration=1.6, n_landmarks=1200, max_keypoints=150, seed=648)
    cfg = Config()
    cfg.camera_intrinsic = seq.K_mat
    cfg.sliding_window_size = 4
    cfg.initializer_keyframe_num = 4
    cfg.initializer_keyframe_gap = 4
    cfg.parsac_host_masks = False
    odo = Odometry(cfg, SyntheticBackend(seq),
                   caps=builders.Caps(W=13, L=256, O=1536, Fi=16, R=128, IMU=64, IMU_KF=384))
    events = sorted([(t, 1, i) for i, t in enumerate(seq.t_imu)]
                    + [(t, 0, i) for i, t in enumerate(seq.t_frame)])
    for t, kind, i in events:
        if kind == 1:
            odo.add_motion(t, seq.gyro[i], seq.accel[i])
        else:
            odo.add_frame(t, i)
        swt = odo.frontend.swt
        if kind == 0 and swt is not None and swt.prior is not None:
            break
    path = str(tmp_path / "ckpt.npz")
    checkpoint.save_tracker(path, swt)
    back = checkpoint.load_tracker(path, cfg, swt.calib, swt.caps)
    assert back.prior.sqrt_inv_cov.device.type == "cuda"
    assert back.bin_conf_imu.device.type == "cuda"
    a, b = checkpoint.tracker_state(swt), checkpoint.tracker_state(back)
    assert set(a) == set(b) and "torch_gumbel_state" in a
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        if x.dtype == object:
            assert x.tolist() == y.tolist(), k
        else:
            np.testing.assert_array_equal(x, y, err_msg=k)

    rng = np.random.default_rng(648)
    img = rng.uniform(0, 255, (120, 160)).astype(np.float32)
    pts = np.stack([rng.uniform(-2, 162, 200), rng.uniform(-2, 122, 200)], -1)
    vc, gc = intensity.evaluate_bicubic(torch.from_numpy(img), pts)
    vd, gd = intensity.evaluate_bicubic(torch.from_numpy(img).to(dev), pts)
    assert vd.device.type == "cuda"
    assert float((vd.cpu() - vc).abs().max()) <= 1e-3
    assert float((gd.cpu() - gc).abs().max()) <= 1e-3
