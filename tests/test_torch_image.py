"""Port parity of the image ops: pyramid, CLAHE, Poisson-disk filter, GFTT.

The same seeded NumPy inputs go through the JAX package's function and the
port's counterpart (rd_vio_tpu_torch, on the CPU), with the tolerance stated
beside each comparison.

This module also holds what every tests/test_torch_*.py module shares:
`child`, which runs the checks in a spawned process (one per test process,
shared by its modules; `child2` is a second one for two port runs at
once), `jax_side`, which runs the JAX half of a whole-pipeline check in
another, `jax_ref`, which gives a JAX half's stored output
(tests/torch_ref) instead of running it when its key matches, and
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
# When set, the path of a file to which every call into a spawned process
# appends one JSON line: the test, the process ("child" or "jax_side"), the
# function, and the wall-clock times of its submission, its start and end
# in the process, and its return (scripts/torch_test_times.py reads them).
TIMING_LOG = "RDVIO_TEST_TIMING_LOG"


def _timed(fn, *args):
    import time

    t0 = time.time()
    out = fn(*args)
    return t0, time.time(), out


def _spawned(env=None):
    """A spawned one-process pool and call(fn, *args) into it; `env` is set
    in the environment the process starts with (it starts at the first
    call). call.submit(fn, *args) starts the call and returns a function
    that waits for its result (with the same time limit), so that the
    caller can do other work meanwhile."""
    import time

    ctx = multiprocessing.get_context("spawn")
    pool = ProcessPoolExecutor(max_workers=1, mp_context=ctx)
    log = os.environ.get(TIMING_LOG)
    kind = "jax_side" if env and KEEP_JAX_CACHE in env else "child"

    def submit(fn, *args):
        saved = {k: os.environ.get(k) for k in env or {}}
        os.environ.update(env or {})
        t_submit = time.time()
        try:
            fut = pool.submit(_timed, fn, *args) if log else pool.submit(fn, *args)
        finally:
            for k, v in saved.items():
                if v is None:
                    del os.environ[k]
                else:
                    os.environ[k] = v

        def result():
            try:
                out = fut.result(timeout=CHILD_TIMEOUT_S)
            except TimeoutError:
                for proc in list(pool._processes.values()):
                    proc.kill()
                raise
            if not log:
                return out
            import json

            t_start, t_end, out = out
            with open(log, "a") as f:
                f.write(json.dumps(dict(
                    test=os.environ.get("PYTEST_CURRENT_TEST", "").split(" ")[0],
                    proc=kind, pool=f"{os.getpid()}:{id(pool)}",
                    fn=getattr(fn, "__name__", str(fn)),
                    submit=t_submit, start=t_start, end=t_end,
                    returned=time.time())) + "\n")
            return out

        return result

    def call(fn, *args):
        return submit(fn, *args)()

    call.submit = submit
    return pool, call


_CHILD = []  # the (pool, call) of this test process's child process
_CHILD2 = []  # the same of its second child (`child2`)
_JAX_SIDE = []  # the (pool, call) of this test process's jax_side process


def _shared(box, env=None):
    """The call of the process kept in `box`, started anew if there is none
    or it was killed."""
    if not box or box[0][0]._broken:
        box[:] = [_spawned(env)]
    return box[0][1]


@pytest.fixture(scope="module")
def child():
    """call(fn, *args): fn(*args) in this test process's spawned child
    process. An assertion that fails there fails the calling test. A call
    that takes longer than CHILD_TIMEOUT_S kills the child and fails the
    test, so a hung child costs one test, not the whole run's time limit.
    One child serves every module of a test process (it ends when that
    process exits; a killed child is replaced), so that each module does not
    pay its start and its imports of jax, torch and the port: a check that
    reads a module-level counter or capture of the port sets it first."""
    return _shared(_CHILD)


@pytest.fixture(scope="module")
def child2():
    """A second process like `child`'s, for a module whose checks run two
    port runs at once (tests/test_torch_odometry.py,
    tests/test_torch_initializer.py)."""
    return _shared(_CHILD2)


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
    return _shared(_JAX_SIDE, {KEEP_JAX_CACHE: "1"})


# Stored outputs of the JAX halves (`jax_ref`): one lzma-compressed pickle
# per reference, {"key": ..., "out": ...}. The JAX package is frozen, so a
# stored output whose key matches is the output the JAX run would give.
# scripts/build_torch_ref.py rebuilds them (it runs the tests with
# WRITE_REF set, which stores every reference computed live).
REF_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_ref")
WRITE_REF = "RDVIO_TEST_WRITE_REF"


@functools.cache
def _jax_package_digest():
    """sha256 of every .py and .cpp file of rd_vio_tpu/, path and bytes, and
    of the versions of jax, jaxlib and numpy."""
    import glob
    import hashlib

    import jax
    import jaxlib

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    h = hashlib.sha256()
    for pat in ("*.py", "*.cpp"):
        for path in sorted(glob.glob(os.path.join(root, "rd_vio_tpu", "**", pat),
                                     recursive=True)):
            h.update(os.path.relpath(path, root).encode())
            with open(path, "rb") as fh:
                h.update(fh.read())
    h.update(f"jax {jax.__version__} jaxlib {jaxlib.__version__} "
             f"numpy {np.__version__}".encode())
    return h.hexdigest()


def _digest(obj, h):
    """Feed `obj` into hashlib object `h`: arrays by dtype, shape and bytes,
    containers, dataclasses and plain objects by their fields in a fixed
    order, anything else by its repr."""
    import dataclasses

    if isinstance(obj, np.ndarray) or isinstance(obj, np.generic):
        a = np.ascontiguousarray(obj)
        h.update(f"array {a.dtype} {a.shape}".encode())
        h.update(a.tobytes() if a.dtype != object else repr(a.tolist()).encode())
    elif isinstance(obj, dict):
        h.update(b"dict")
        for k in sorted(obj, key=repr):
            h.update(repr(k).encode())
            _digest(obj[k], h)
    elif isinstance(obj, (list, tuple)):
        h.update(f"{type(obj).__name__} {len(obj)}".encode())
        for x in obj:
            _digest(x, h)
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        h.update(type(obj).__name__.encode())
        _digest({f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}, h)
    elif hasattr(obj, "__dict__") and not callable(obj):
        h.update(type(obj).__name__.encode())
        _digest(vars(obj), h)
    else:
        h.update(repr(obj).encode())


def _closure_source(fns):
    """The source of each function or class of `fns` and, transitively, of every function and
    class of a test module (tests/*.py) that their code names, with the
    functions' default values and the values of the plain constants their
    code names (numbers, strings, tuples, dicts): what the JAX half runs, helpers imported from other test modules
    included. Names are qualified names, not module names (a test module is
    imported both as `tests.<name>` and as `<name>`)."""
    import inspect
    import types

    tests_dir = os.path.dirname(os.path.abspath(__file__))
    seen, parts = set(), []

    def names(code):
        yield from code.co_names
        for c in code.co_consts:
            if isinstance(c, types.CodeType):
                yield from names(c)

    def visit(obj):
        if not (inspect.isfunction(obj) or inspect.isclass(obj)) or obj in seen:
            return
        try:
            in_tests = os.path.dirname(inspect.getsourcefile(obj)) == tests_dir
        except TypeError:
            in_tests = False
        if not in_tests:
            return
        seen.add(obj)
        parts.append(f"{obj.__qualname__}\n{inspect.getsource(obj)}")
        if inspect.isfunction(obj):  # default values are bound at definition
            parts.append(f"defaults {obj.__defaults__!r} {obj.__kwdefaults__!r}")
            codes, glb = [obj.__code__], obj.__globals__
        else:
            codes = [f.__code__ for f in vars(obj).values() if inspect.isfunction(f)]
            glb = vars(inspect.getmodule(obj))
        for code in codes:
            for n in sorted(set(names(code))):
                v = glb.get(n)
                if inspect.isfunction(v) or inspect.isclass(v):
                    visit(v)
                elif isinstance(v, (bool, int, float, str, tuple, dict)):
                    parts.append(f"{n} = {v!r}")

    for f in fns:
        visit(f)
    return "\n".join(parts)


def ref_source_digest(fns):
    """The part of a stored output's key that its JAX half's code fixes:
    sha256 of the JAX package's sources and the versions
    (`_jax_package_digest`) and of `_closure_source(fns)`."""
    import hashlib

    h = hashlib.sha256(_jax_package_digest().encode())
    h.update(_closure_source(fns).encode())
    return h.hexdigest()


def ref_key(name, src, inputs):
    """The key of a stored JAX output: sha256 of its name, of `src`
    (`ref_source_digest`) and of `inputs`, the check's input arrays as built
    (`_digest`)."""
    import hashlib

    h = hashlib.sha256(f"{name} {src}".encode())
    _digest(inputs, h)
    return h.hexdigest()


def _qualified(f):
    return f"{f.__module__.split('.')[-1]}:{f.__qualname__}"


def load_ref(name):
    """The record stored for `name` ({"key", "src", "fns", "out"}), or None."""
    import lzma
    import pickle

    path = os.path.join(REF_DIR, f"{name}.pkl.xz")
    if not os.path.exists(path):
        return None
    with lzma.open(path, "rb") as fh:
        return pickle.load(fh)


def jax_ref(call, name, inputs, fn, *args):
    """Start the JAX half fn(*args) and return a function that waits for
    its output, as call.submit does (`call`: jax_side). When
    tests/torch_ref/<name>.pkl.xz holds an output under the same key
    (`ref_key` of `ref_source_digest` of fn and the functions among args,
    and of `inputs`), that output is returned instead and nothing runs; a
    missing key runs fn live, and a different one too, with a warning (a
    stored output whose code part is stale also fails
    test_stored_jax_outputs_are_current); with WRITE_REF set a live output
    is stored under its key."""
    import lzma
    import pickle
    import warnings

    fns = [f for f in (fn, *args) if callable(f) and f is not file_output]
    src = ref_source_digest(fns)
    key = ref_key(name, src, inputs)
    stored = load_ref(name)
    if stored is not None:
        if stored["key"] == key:
            return lambda: stored["out"]
        warnings.warn(f"tests/torch_ref/{name}.pkl.xz is stale (its "
                      f"{'inputs' if stored.get('src') == src else 'code'} changed): the JAX "
                      f"half runs live; rebuild it with scripts/build_torch_ref.py")
    result = call.submit(fn, *args)

    def live():
        out = result()
        if os.environ.get(WRITE_REF):
            os.makedirs(REF_DIR, exist_ok=True)
            with lzma.open(os.path.join(REF_DIR, f"{name}.pkl.xz"), "wb", preset=9) as fh:
                pickle.dump({"key": key, "src": src, "fns": [_qualified(f) for f in fns],
                             "out": out}, fh, protocol=4)
        return out

    return live


def file_output(fn, *args):
    """fn(*args), which writes its output to the path args[-1]; returns the
    file's bytes (for `jax_ref` of a JAX half that writes a file)."""
    fn(*args)
    with open(args[-1], "rb") as fh:
        return fh.read()


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


def test_stored_jax_outputs_are_current():
    """Every stored JAX output (tests/torch_ref) is current: the code part
    of its key (`ref_source_digest` of the functions its record names, with
    the JAX package's sources and the versions of jax, jaxlib and numpy) is
    what this tree gives, so a change to a JAX half or to a helper it calls
    fails here instead of quietly running that half live; and the stored
    outputs take at most 5 MB."""
    import glob
    import importlib

    paths = sorted(glob.glob(os.path.join(REF_DIR, "*.pkl.xz")))
    assert paths, "no stored JAX outputs"
    total = sum(os.path.getsize(p) for p in paths)
    assert total <= 5 * 1024 * 1024, f"tests/torch_ref holds {total} bytes"
    stale = []
    for path in paths:
        name = os.path.basename(path)[:-len(".pkl.xz")]
        rec = load_ref(name)
        fns = []
        for q in rec["fns"]:
            mod, qual = q.split(":")
            obj = importlib.import_module(f"tests.{mod}")
            for part in qual.split("."):
                obj = getattr(obj, part)
            fns.append(obj)
        if ref_source_digest(fns) != rec["src"]:
            stale.append(name)
    assert not stale, (f"stale stored JAX outputs {stale}: rebuild them with "
                       f"python scripts/build_torch_ref.py")
