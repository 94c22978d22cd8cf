"""Port parity of the image ops: pyramid, CLAHE, Poisson-disk filter, GFTT.

The same seeded NumPy inputs go through the JAX package's function and the
port's counterpart (rd_vio_tpu_torch, on the CPU), with the tolerance stated
beside each comparison.

This module also holds what every tests/test_torch_*.py module shares:
`child`, which runs a module's checks in a spawned process, `jax_side`,
which runs the JAX half of a whole-pipeline check in another, and
`rendered_frames`. Only those processes import torch and the port, and
only they compile the checks' JAX programs, so the test runner's own
processes stay as they are without the port: jaxlib's CPU backend crashes intermittently
in long, compile-heavy processes (tests/conftest.py), and with the port's
checks running inside the workers, tests/test_async_keyframe.py was seen to
crash in jaxlib's executable serialization. For the same reason these
modules hold few tests each, most of them one.
"""

import functools
import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor

import numpy as np
import jax.numpy as jnp
import pytest

from rd_vio_tpu.datasets import synthetic as synth_j
from rd_vio_tpu.datasets.renderer import SequenceRenderer
from rd_vio_tpu.models import image_backend as ib_j
from rd_vio_tpu.ops import poisson_disk as pd_j
from rd_vio_tpu.ops.image import clahe as clahe_j
from rd_vio_tpu.ops.image import gftt as gftt_j
from rd_vio_tpu.ops.image import pyramid as pyr_j

IN_CHILD = multiprocessing.parent_process() is not None
# set in the environment of a `jax_side` process (see there)
KEEP_JAX_CACHE = "RDVIO_TEST_KEEP_JAX_CACHE"
if IN_CHILD:
    import jax
    import torch

    from rd_vio_tpu_torch.models import image_backend as ib_t
    from rd_vio_tpu_torch.ops import poisson_disk as pd_t
    from rd_vio_tpu_torch.ops.image import clahe as clahe_t
    from rd_vio_tpu_torch.ops.image import gftt as gftt_t
    from rd_vio_tpu_torch.ops.image import pyramid as pyr_t

    # as tests/conftest.py sets it for the test runner's own processes
    jax.config.update("jax_platforms", "cpu")
    # The checks neither read nor write the persistent compilation cache
    # that the suite's workers share: its entries are written in place, and
    # a reader racing a writer of the same program gets a partial entry.
    # (A `jax_side` process keeps it: it runs the JAX package's own
    # programs, the ones its tests compile.)
    if not os.environ.get(KEEP_JAX_CACHE):
        jax.config.update("jax_enable_compilation_cache", False)
    # One intra-op thread: the suite runs in several worker processes at
    # once, and torch's OpenMP threads spin-waiting against them make the
    # many small ops of these checks tens of times slower.
    torch.set_num_threads(1)


CHILD_TIMEOUT_S = 600


def _spawned(env=None):
    """A spawned one-process pool and call(fn, *args) into it; `env` is set
    in the environment the process starts with (it starts at the first
    call). call.submit(fn, *args) starts the call and returns a function
    that waits for its result (with the same time limit), so that the
    caller can do other work meanwhile."""
    ctx = multiprocessing.get_context("spawn")
    pool = ProcessPoolExecutor(max_workers=1, mp_context=ctx)

    def submit(fn, *args):
        saved = {k: os.environ.get(k) for k in env or {}}
        os.environ.update(env or {})
        try:
            fut = pool.submit(fn, *args)
        finally:
            for k, v in saved.items():
                if v is None:
                    del os.environ[k]
                else:
                    os.environ[k] = v

        def result():
            try:
                return fut.result(timeout=CHILD_TIMEOUT_S)
            except TimeoutError:
                for proc in list(pool._processes.values()):
                    proc.kill()
                raise

        return result

    def call(fn, *args):
        return submit(fn, *args)()

    call.submit = submit
    return pool, call


@pytest.fixture(scope="module")
def child():
    """call(fn, *args): fn(*args) in this module's spawned child process.
    An assertion that fails there fails the calling test. A call that takes
    longer than CHILD_TIMEOUT_S kills the child and fails the test, so a
    hung child costs one test, not the whole run's time limit."""
    pool, call = _spawned()
    try:
        yield call
    finally:
        pool.shutdown(wait=True, cancel_futures=True)


_JAX_SIDE = []  # the (pool, call) of this test process's jax_side process


@pytest.fixture(scope="module")
def jax_side():
    """call(fn, *args) like `child`'s, in a second spawned process that
    keeps JAX's persistent compilation cache: the JAX half of a parity check
    that runs the JAX package's pipeline (its programs are the ones that
    package's own tests compile, so the cache serves them). A process apart
    from the test runner's keeps the count of compiles per process low:
    jaxlib's CPU backend aborts intermittently in long, compile-heavy
    processes (tests/conftest.py), and a suite's worker that compiled these
    programs was seen to abort in the cache write. One such process serves
    every module of a test process (it ends when that process exits), so
    that the modules share the programs it has loaded."""
    if not _JAX_SIDE or _JAX_SIDE[0][0]._broken:  # a killed process is not reused
        _JAX_SIDE[:] = [_spawned({KEEP_JAX_CACHE: "1"})]
    return _JAX_SIDE[0][1]


def rendered_frames(n, size=(320, 240), seed=648):
    """n uint8 frames of the bench's rendered sequence at `size` (W, H)."""
    seq = synth_j.generate(duration=max(n, 2) / 20.0, n_landmarks=1200,
                           max_keypoints=150, excitation=0.05, seed=seed)
    rend = SequenceRenderer(seq, image_size=size)
    return seq, rend, [np.asarray(rend.render(i), np.uint8) for i in range(n)]


@functools.cache
def _frame():
    return rendered_frames(1)[2][0]


def _check_pyramid():
    # f32 sums in the same order: max abs <= 1e-4 (sum-order rounding)
    img = _frame().astype(np.float32)
    pj = pyr_j.build_pyramid(jnp.asarray(img), 3)
    pt = pyr_t.build_pyramid(torch.from_numpy(img), 3)
    assert len(pt) == len(pj) == 4
    for a, b in zip(pj, pt):
        assert tuple(b.shape) == a.shape
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-4, rtol=0)


def _check_clahe(size):
    # >= 99.9% of pixels within 1e-3 and all within 1.0: a LUT entry whose
    # cdf lands on a .5 boundary may round the other way
    _, _, frames = rendered_frames(1, size=size, seed=11)
    img = frames[0]
    pj = ib_j._preprocess_fused(jnp.asarray(img), tx=8, ty=8, clip=6.0,
                                levels=3, clahe_on=True)
    pt = ib_t.preprocess_fused(torch.from_numpy(img), tx=8, ty=8, clip=6.0,
                               levels=3, clahe_on=True)
    d = np.abs(pt[0].numpy() - np.asarray(pj[0]))
    assert (d <= 1e-3).mean() >= 0.999
    assert d.max() <= 1.0
    for a, b in zip(pj[1:], pt[1:]):
        assert np.abs(b.numpy() - np.asarray(a)).max() <= 1.0


def _check_clahe_direct():
    rng = np.random.default_rng(5)
    img = np.clip(rng.normal(120, 30, (96, 128)), 0, 255).astype(np.float32)
    a = np.asarray(clahe_j.clahe(jnp.asarray(img), 8, 8, 6.0))
    b = clahe_t.clahe(torch.from_numpy(img), 8, 8, 6.0).numpy()
    d = np.abs(a - b)
    assert (d <= 1e-3).mean() >= 0.999 and d.max() <= 1.0


def _check_poisson_filter(preset):
    # exact equality on the same inputs
    rng = np.random.default_rng(7 + preset)
    pts = rng.uniform(-5, 165, (96, 2)).astype(np.float32)
    pts[::7] = pts[1::7][: len(pts[::7])] + 3.0  # close pairs
    valid = rng.uniform(size=96) > 0.15
    a = np.asarray(pd_j.poisson_disk_filter(
        jnp.asarray(pts), jnp.asarray(valid), min_distance=10.0,
        width=160.0, height=120.0, preset_count=preset))
    b = pd_t.poisson_disk_filter(
        torch.from_numpy(pts), torch.from_numpy(valid), min_distance=10.0,
        width=160.0, height=120.0, preset_count=preset).numpy()
    np.testing.assert_array_equal(a, b)
    assert b.sum() > 20


def _check_gftt():
    # >= 98% of detections matched within 1e-3 px (a Harris plateau or a
    # rounding-level response difference may swap two candidates)
    img = _frame().astype(np.float32)
    rng = np.random.default_rng(3)
    ex = rng.uniform(30, 290, (64, 2)).astype(np.float32)
    ev = rng.uniform(size=64) > 0.5
    pj, vj, _ = gftt_j.detect_gftt(jnp.asarray(img), jnp.asarray(ex),
                                   jnp.asarray(ev), max_points=120,
                                   min_dist=10.0)
    pt, vt, _ = gftt_t.detect_gftt(torch.from_numpy(img), torch.from_numpy(ex),
                                   torch.from_numpy(ev), max_points=120,
                                   min_dist=10.0)
    pj = np.asarray(pj)[np.asarray(vj)]
    pt = pt.numpy()[vt.numpy()]
    assert len(pj) > 50
    assert abs(len(pt) - len(pj)) <= 0.02 * len(pj)
    d = np.linalg.norm(pj[:, None] - pt[None], axis=-1).min(axis=1)
    assert (d <= 1e-3).mean() >= 0.98


def test_image_ops_match_jax(child):
    child(_check_pyramid)
    for size in [(320, 240), (150, 110)]:
        child(_check_clahe, size)
    child(_check_clahe_direct)
    for preset in [0, 12]:
        child(_check_poisson_filter, preset)
    child(_check_gftt)
