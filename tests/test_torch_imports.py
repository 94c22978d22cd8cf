"""rd_vio_tpu_torch (and chip_smoke.py, the port's example runners and the
EuRoC layout writer) import neither JAX nor the JAX package, and every
module imports on a machine with no nvcc and no CUDA;
`convert` carries the JAX side's config into the port field by field, and
the port's checks run in the child process of test_torch_image alone. The
port's entry points compute on the GPU unless the caller names another
device: Odometry, the batch runtime and the calibration's device constants
included."""

import subprocess
import sys
from pathlib import Path

import numpy as np

from rd_vio_tpu.config import Config as ConfigJ
from tests.test_torch_image import IN_CHILD, child  # noqa: F401

if IN_CHILD:  # the port loads only where the checks run (test_torch_image)
    import inspect

    import torch

    from rd_vio_tpu_torch import convert
    from rd_vio_tpu_torch.config import Config as ConfigT
    from rd_vio_tpu_torch.datasets import synthetic_problems
    from rd_vio_tpu_torch.estimation import factors, state
    from rd_vio_tpu_torch.models import builders as builders_t
    from rd_vio_tpu_torch.models.feature_tracker import FeatureTracker, SyntheticBackend
    from rd_vio_tpu_torch.models.image_backend import TorchImageBackend
    from rd_vio_tpu_torch.models.odometry import Odometry
    from rd_vio_tpu_torch.ops import frontend_loop, preintegration, ransac
    from rd_vio_tpu_torch.ops.image import klt

ROOT = Path(__file__).resolve().parents[1]


def _modules():
    """Every module of the package, found on disk (importing the package to
    walk it would load torch into this process)."""
    names = []
    for path in (ROOT / "rd_vio_tpu_torch").rglob("*.py"):
        parts = path.relative_to(ROOT).with_suffix("").parts
        names.append(".".join(parts[:-1] if parts[-1] == "__init__" else parts))
    return sorted(names)


def _check_imports_without_jax():
    # the port's runners and the layout writer of chip_smoke.py's phase I
    entry = ["examples.torch_run_synthetic", "examples.torch_run_euroc",
             "examples.torch_run_advio", "scripts.euroc_layout"]
    mods = _modules() + ["chip_smoke"] + entry
    assert "rd_vio_tpu_torch.ops.image.klt" in mods
    assert "rd_vio_tpu_torch.estimation.ba" in mods
    assert "rd_vio_tpu_torch.models.handler" in mods
    for m in ("models.odometry", "models.frontend", "models.initializer",
              "models.sliding_window_tracker", "models.builders", "ops.homography",
              "ops.parsac_np", "ops.frontend_step_np", "utils.trajectory",
              "ops.parsac", "ops.pnp", "ops.essential5", "native", "batch",
              "batch.dispatcher", "batch.swt", "batch.runtime", "utils.batch_eval",
              "ops.camera", "ops.image.undistort", "datasets.euroc", "datasets.advio",
              "datasets.video", "utils.pose_stream", "utils.viewer", "parallel",
              "parallel.dist_ba", "utils.checkpoint", "ops.image.intensity"):
        assert f"rd_vio_tpu_torch.{m}" in mods, m
    code = (
        "import sys, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['rd_vio_tpu'] = None\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'rd_vio_tpu' or m.startswith('rd_vio_tpu.')]\n"
        "assert all(sys.modules[m] is None for m in bad), bad\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


def _check_config_converts():
    cj = ConfigJ()
    cj.feature_tracker_max_keypoint_detection = 200
    cj.camera_intrinsic = np.diag([300.0, 310.0, 1.0])
    ct = convert.config_from(cj)
    assert type(ct).__module__ == "rd_vio_tpu_torch.config"
    assert ct.feature_tracker_max_keypoint_detection == 200
    np.testing.assert_array_equal(ct.camera_intrinsic, cj.camera_intrinsic)
    assert ct.camera_intrinsic is not cj.camera_intrinsic


def _check_entry_points_default_to_the_card():
    # a caller that names no device gets the GPU (and, without one, an error
    # at the first upload), never a silent CPU run; where there is no
    # default the device is a required argument
    cfg = ConfigT()
    backend = TorchImageBackend(cfg)
    assert backend.device.type == "cuda"
    assert backend.lk is klt.lk_track_fwd_rev  # the fused kernel's wrapper
    for fn in (ransac.GumbelSource.__init__, frontend_loop.init_state):
        assert inspect.signature(fn).parameters["device"].default is inspect.Parameter.empty
    assert inspect.signature(frontend_loop.ft_loop_step).parameters["lk"].default \
        is klt.lk_track_fwd_rev
    # the tracker follows its backend's device unless told otherwise
    on_cpu = TorchImageBackend(cfg, "cpu")
    ft = FeatureTracker(cfg, builders_t.CalibArrays.from_config(cfg),
                        builders_t.Caps(), on_cpu)
    assert ft.device == torch.device("cpu") == on_cpu.device
    assert ft._K_dev.device.type == "cpu"
    # the estimator's makers of tensors from nothing default to the card;
    # initial_prior follows the states it is given
    for fn in (state.zero_states, preintegration.zero_delta, factors.empty_reproj_prior,
               factors.empty_imu_prior, synthetic_problems.identity_ext,
               synthetic_problems.build_window_problem):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
    prior = factors.initial_prior(2, state.zero_states(2, device="cpu"))
    assert prior.sqrt_inv_cov.device.type == "cpu"
    # the calibration's device constants and Odometry: the card by default,
    # Odometry raises without one unless asked for the CPU, and follows its
    # backend's device
    calib = builders_t.CalibArrays.from_config(cfg)
    assert calib.device == "cuda"
    assert inspect.signature(builders_t.CalibArrays.from_config).parameters[
        "device"].default == "cuda"
    assert builders_t.CalibArrays.from_config(cfg, "cpu").tree.cov_w.device.type == "cpu"
    assert inspect.signature(Odometry).parameters["device"].default is None
    assert not torch.cuda.is_available()
    # threaded too: no fall-back to the CPU, and no worker thread started
    import threading

    n_threads = threading.active_count()
    for kw in ({}, {"device": "cuda"}, {"threaded": True},
               {"threaded": True, "device": "cuda"}):
        try:
            Odometry(cfg, SyntheticBackend(None), **kw)
        except RuntimeError as e:
            assert "no CUDA device" in str(e)
        else:
            raise AssertionError(f"Odometry({kw}) made without a card")
    assert threading.active_count() == n_threads
    odo = Odometry(cfg, SyntheticBackend(None), device="cpu")
    assert odo.calib.tree.cov_w.device.type == "cpu"
    # the branches the port refused before now run: the threaded pipeline,
    # the device PARSAC, the 5-point initializer and the device mask program
    # of the host-mask tracker; a threaded Odometry's workers exit on close()
    import dataclasses

    all_on = dataclasses.replace(cfg, parsac_host_masks=False, initializer_use_5pt=True,
                                 feature_tracker_host_masks=False)
    odo = Odometry(all_on, SyntheticBackend(None), device="cpu", threaded=True)
    workers = (odo.handler._ft_worker, odo.handler._fe_worker)
    assert all(w.is_alive() for w in workers) and odo.healthy()
    odo.close()
    assert not any(w.is_alive() for w in workers)
    # the dataset layer: the runners' functions and the undistorter
    from rd_vio_tpu_torch.datasets import advio, euroc

    for fn in (euroc.run_euroc, euroc.make_undistorter, euroc.Undistorter,
               advio.run_advio, advio.AdvioDataset):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
    distorted = dataclasses.replace(cfg, camera_distortion_flag=1)
    try:
        euroc.make_undistorter(distorted)
    except RuntimeError:
        pass  # no card: the tables' upload fails
    else:
        raise AssertionError("an undistorter made on the card without one")
    assert euroc.make_undistorter(distorted, "cpu").map_x.device.type == "cpu"
    # the sharded BA's groups and serving ranks: the card unless the caller
    # names another device (gloo on the CPU, as the tests run them); the
    # checkpoint restores onto the calibration's device (the card by
    # default); intensity computes where its image lies
    from rd_vio_tpu_torch.ops.image import intensity
    from rd_vio_tpu_torch.parallel import dist_ba
    from rd_vio_tpu_torch.utils import checkpoint

    for fn in (dist_ba.make_group, dist_ba.RankProcesses):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
    assert "device" not in inspect.signature(checkpoint.load_tracker).parameters
    v, g = intensity.evaluate_bicubic(torch.zeros(8, 8), np.array([[3.5, 4.25]]))
    assert v.device.type == g.device.type == "cpu" and v.dtype == torch.float32
    assert Odometry(cfg, on_cpu).device == torch.device("cpu")
    try:
        Odometry(cfg, on_cpu, device="cuda")
    except ValueError:
        pass
    else:
        raise AssertionError("Odometry on another device than its backend")


def _check_batch_runtime_defaults_to_the_card():
    """BatchedVIO and run_sequences_lockstep: the card unless the caller
    asks for the CPU; without a card the default raises and starts no
    thread. On the CPU every sequence's tracker is the dispatcher-coupled
    BatchSWT, sharing one dispatcher."""
    import functools
    import threading

    from rd_vio_tpu_torch.batch import BatchedVIO, run_sequences_lockstep
    from rd_vio_tpu_torch.batch.swt import BatchSWT

    cfgs = [ConfigT(), ConfigT()]
    assert inspect.signature(BatchedVIO).parameters["device"].default is None
    assert inspect.signature(run_sequences_lockstep).parameters["device"].default is None
    builders_t.PROGRAM_STATS.clear()
    n_threads = threading.active_count()
    for kw in ({}, {"device": "cuda"}):
        try:
            BatchedVIO(cfgs, [SyntheticBackend(None)] * 2, **kw)
        except RuntimeError as e:
            assert "no CUDA device" in str(e)
        else:
            raise AssertionError(f"BatchedVIO({kw}) made without a card")
    assert threading.active_count() == n_threads
    vio = BatchedVIO(cfgs, [SyntheticBackend(None)] * 2, device="cpu")
    assert vio.device == torch.device("cpu") and vio.disp.device == torch.device("cpu")
    for i, odo in enumerate(vio.odos):
        f = odo.frontend.swt_factory
        assert isinstance(f, functools.partial) and f.func is BatchSWT
        assert f.keywords == {"dispatcher": vio.disp, "seq_index": i}
    vio.close()  # a flush with nothing submitted runs no program
    assert "batched_kf" not in builders_t.PROGRAM_STATS


def test_batch_runtime_defaults_to_the_card(child):
    child(_check_batch_runtime_defaults_to_the_card)


def _check_counters_under_threads():
    """What a threaded Odometry's two workers write at once: StageTimer's
    span log, builders.PROGRAM_STATS (through _count) and the parsac
    call counts. 12 threads (more than the cores) x 200 updates each with a
    1 us switch interval: no update is lost."""
    import threading

    from rd_vio_tpu_torch.models import sliding_window_tracker as swt
    from rd_vio_tpu_torch.utils.metrics import StageTimer

    timer = StageTimer(bound=10 ** 6)
    builders_t.PROGRAM_STATS.pop("stress", None)
    judged = swt.PARSAC_STATS["judge"]

    def work():
        for _ in range(200):
            with timer.time("stress"):
                builders_t._count("stress", lambda: None)
            swt._record_parsac("judge", {}, ())

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(12)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads)
    assert timer.stats()["stress"]["n"] == 12 * 200
    assert builders_t.PROGRAM_STATS.pop("stress")["calls"] == 12 * 200
    assert swt.PARSAC_STATS["judge"] - judged == 12 * 200


def test_counters_are_thread_safe(child):
    child(_check_counters_under_threads)


def _in_child():
    return IN_CHILD, "torch" in sys.modules


def test_entry_points_default_to_the_card(child):
    child(_check_entry_points_default_to_the_card)


def test_port_imports_without_jax(child):
    _check_imports_without_jax()
    child(_check_config_converts)
    # torch and the port load in the child only
    assert child(_in_child) == (True, True)
    assert not IN_CHILD and "torch" not in sys.modules
