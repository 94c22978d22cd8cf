"""Port parity of the native host library (rd_vio_tpu_torch/native) and of
the host copies that call it: ops/preintegration_np.py, models/quat_np.py
and ops/poisson_disk.poisson_disk_filter_np.

The JAX package's results are computed here, in the test process (NumPy
and its own native library, no device program); the port's in the spawned
child (`child`, tests/test_torch_image.py), from the same seeded NumPy
inputs. The port builds its library from its own copies of the JAX
package's C++ sources with the same flags, so the two native libraries give
the same bits; each native result agrees with its NumPy loop to 1e-12 of
the field's largest entry (tests/test_native.py's bound); and the NumPy
loops of the two packages, with both native paths switched off as
tests/test_native.py does, give the same bits.
"""

import contextlib
import os

import numpy as np
import pytest

from rd_vio_tpu import native as nat_j
from rd_vio_tpu.models import quat_np as quat_j
from rd_vio_tpu.ops import poisson_disk as pd_j
from rd_vio_tpu.ops import preintegration_np as pre_j
from tests.test_torch_image import IN_CHILD, child  # noqa: F401

if IN_CHILD:  # the port loads only where the checks run (test_torch_image)
    from rd_vio_tpu_torch import native as nat_t
    from rd_vio_tpu_torch.models import quat_np as quat_t
    from rd_vio_tpu_torch.ops import poisson_disk as pd_t
    from rd_vio_tpu_torch.ops import preintegration_np as pre_t

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCES = ("preintegrator.cpp", "sensor_queue.cpp")
COVS = [np.eye(3) * c for c in (2.9e-8, 4e-6, 3.8e-10, 9e-6)]


def _imu_batch(seed, F=5, N=40):
    rng = np.random.default_rng(seed)
    dts = np.zeros((F, N))
    ws = np.zeros((F, N, 3))
    accs = np.zeros((F, N, 3))
    for f in range(F):
        n = rng.integers(5, N)
        dts[f, :n] = rng.uniform(0.004, 0.006, n)
        ws[f, :n] = rng.normal(0, 0.3, (n, 3))
        accs[f, :n] = rng.normal(0, 2.0, (n, 3)) + [0, 0, 9.8]
    return dts, ws, accs, rng.normal(0, 0.01, (F, 3)), rng.normal(0, 0.05, (F, 3))


def _state(seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=4)
    return q / np.linalg.norm(q), rng.normal(size=3), rng.normal(size=3)


def _points(seed, n=160):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-5, 165, (n, 2))
    pts[::7] = pts[1::7][: len(pts[::7])] + 3.0  # close pairs
    return pts, rng.uniform(size=n) > 0.15


def _inputs():
    """Every seeded input of the checks, by name."""
    dts, ws, accs, bg, ba = _imu_batch(3)
    q0, p0, v0 = _state(4)
    pts, valid = _points(7)
    rng = np.random.default_rng(8)
    qa, qb = (v / np.linalg.norm(v) for v in rng.normal(size=(2, 4)))
    va, vb = rng.normal(size=(2, 3))
    R = quat_j.q_to_R(qa)
    return dict(dts=dts, ws=ws, accs=accs, bg=bg, ba=ba, q0=q0, p0=p0, v0=v0, pts=pts,
                valid=valid, qa=qa, qb=qb, va=va, vb=vb, R=R)


def _jax_outputs(x, native_on: bool):
    """The JAX package's results on `x`: its native library, or (off) its
    NumPy loops."""
    out = {
        "full": pre_j.integrate_full_batch(x["dts"], x["ws"], x["accs"], x["bg"], x["ba"],
                                           *COVS),
        "predict": pre_j.predict_frame_mean(x["q0"], x["p0"], x["v0"], x["bg"][0], x["ba"][0],
                                            x["dts"][0], x["ws"][0], x["accs"][0]),
        "dq": pre_j.interval_rotation_mean(x["dts"][1], x["ws"][1], x["accs"][1], x["bg"][1],
                                           x["ba"][1]),
        "poisson": [pd_j.poisson_disk_filter_np(x["pts"], x["valid"], 10.0, 160.0, 120.0,
                                                preset_count=k) for k in (0, 12)],
    }
    if not native_on:
        t, dq, dp, dv = pre_j.integrate_mean(x["dts"][2], x["ws"][2], x["accs"][2],
                                             x["bg"][2], x["ba"][2])
        out["mean"] = (t, dq, dp, dv)
        out["predict_mean"] = pre_j.predict_mean(t, dq, dp, dv, x["q0"], x["p0"], x["v0"])
        out["quat"] = dict(
            qmul=quat_j.qmul(x["qa"], x["qb"]), qconj=quat_j.qconj(x["qa"]),
            cross=quat_j._cross3(x["va"], x["vb"]), qrot=quat_j.qrot(x["qa"], x["va"]),
            qnorm=quat_j.qnorm(x["qa"] * 3.0), q_to_R=quat_j.q_to_R(x["qa"]),
            R_to_q=quat_j.R_to_q(x["R"]),
            two=quat_j.q_from_two_vectors(x["va"], x["vb"]))
    return out


@contextlib.contextmanager
def _jax_native_off():
    saved = nat_j.available
    nat_j.available = lambda: False
    try:
        yield
    finally:
        nat_j.available = saved


@contextlib.contextmanager
def _port_native_off():
    saved = nat_t.available
    nat_t.available = lambda: False
    try:
        yield
    finally:
        nat_t.available = saved


def _port_outputs(x, native_on: bool):
    with (contextlib.nullcontext() if native_on else _port_native_off()):
        out = {
            "full": pre_t.integrate_full_batch(x["dts"], x["ws"], x["accs"], x["bg"],
                                               x["ba"], *COVS),
            "predict": pre_t.predict_frame_mean(x["q0"], x["p0"], x["v0"], x["bg"][0],
                                                x["ba"][0], x["dts"][0], x["ws"][0],
                                                x["accs"][0]),
            "dq": pre_t.interval_rotation_mean(x["dts"][1], x["ws"][1], x["accs"][1],
                                               x["bg"][1], x["ba"][1]),
            "poisson": [pd_t.poisson_disk_filter_np(x["pts"], x["valid"], 10.0, 160.0, 120.0,
                                                    preset_count=k) for k in (0, 12)],
        }
        if not native_on:
            t, dq, dp, dv = pre_t.integrate_mean(x["dts"][2], x["ws"][2], x["accs"][2],
                                                 x["bg"][2], x["ba"][2])
            out["mean"] = (t, dq, dp, dv)
            out["predict_mean"] = pre_t.predict_mean(t, dq, dp, dv, x["q0"], x["p0"],
                                                     x["v0"])
            out["quat"] = dict(
                qmul=quat_t.qmul(x["qa"], x["qb"]), qconj=quat_t.qconj(x["qa"]),
                cross=quat_t._cross3(x["va"], x["vb"]), qrot=quat_t.qrot(x["qa"], x["va"]),
                qnorm=quat_t.qnorm(x["qa"] * 3.0), q_to_R=quat_t.q_to_R(x["qa"]),
                R_to_q=quat_t.R_to_q(x["R"]),
                two=quat_t.q_from_two_vectors(x["va"], x["vb"]))
    return out


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}.{k}")
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    else:
        yield path, np.asarray(tree)


def _same_bits(a, b):
    la, lb = list(_leaves(a)), list(_leaves(b))
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (path, x), (_, y) in zip(la, lb):
        np.testing.assert_array_equal(x, y, err_msg=path)


def _close_1e12(a, b):
    """Each field within 1e-12 of its largest entry (the two sum in another
    order); masks equal."""
    for (path, x), (_, y) in zip(_leaves(a), _leaves(b)):
        if x.dtype == bool:
            np.testing.assert_array_equal(x, y, err_msg=path)
            continue
        scale = max(np.abs(y).max(initial=0.0), 1e-300)
        assert np.abs(x - y).max(initial=0.0) <= 1e-12 * scale, path


# -- the checks (in the child) ---------------------------------------------


def _check_sources():
    """The port's copies: the same code as the JAX package's sources; only
    comment lines may differ (the port's name the reference's files without
    a local path)."""
    for name in SOURCES:
        with open(os.path.join(REPO, "rd_vio_tpu", "native", name)) as fh:
            a = fh.read().splitlines()
        with open(os.path.join(REPO, "rd_vio_tpu_torch", "native", name)) as fh:
            b = fh.read().splitlines()
        assert len(a) == len(b), name
        diff = [(x, y) for x, y in zip(a, b) if x != y]
        assert len(diff) <= 1, (name, diff)
        assert all(x.startswith("//") and y.startswith("//") for x, y in diff), (name, diff)
    assert nat_t.available()
    lib = nat_t.library_path()
    assert lib.parent == nat_t.BUILD_DIR and lib.exists()
    assert os.path.relpath(lib, REPO).startswith(os.path.join("rd_vio_tpu_torch", "_build"))


def _check_native(x, jax_native):
    nat_t.CALLS.clear()
    port = _port_outputs(x, native_on=True)
    assert nat_t.CALLS["preintegrate_batch"] == 1 and nat_t.CALLS["predict_mean"] == 2
    assert nat_t.CALLS["poisson_filter"] == 2
    _same_bits(port, jax_native)  # one source, one compiler, one set of flags
    plain = _port_outputs(x, native_on=False)
    _close_1e12({k: port[k] for k in ("full", "predict", "dq", "poisson")},
                {k: plain[k] for k in ("full", "predict", "dq", "poisson")})


def _check_numpy(x, jax_numpy):
    nat_t.CALLS.clear()
    _same_bits(_port_outputs(x, native_on=False), jax_numpy)
    assert sum(nat_t.CALLS.values()) == 0


def _check_queue():
    """tests/test_native.py's two sensor-queue checks on the port's queue."""
    q = nat_t.NativeSensorQueue()
    q.push_gyro(0.000, [0.0, 0.0, 0.0])
    q.push_gyro(0.010, [1.0, 2.0, 3.0])
    q.push_gyro(0.020, [2.0, 4.0, 6.0])
    q.push_accel(0.005, [9.0, 0.0, 0.0])
    q.push_accel(0.015, [9.5, 0.0, 0.0])
    assert q.fused_count() == 2
    rows = q.pop_interval(0.012)
    assert len(rows) == 1
    np.testing.assert_allclose(rows[0, 0], 0.005)
    np.testing.assert_allclose(rows[0, 1:4], [0.5, 1.0, 1.5])  # midpoint gyro
    np.testing.assert_allclose(rows[0, 4], 9.0)
    rows = q.pop_interval(1.0)
    assert len(rows) == 1
    np.testing.assert_allclose(rows[0, 1:4], [1.5, 3.0, 4.5])
    q.destroy()

    q = nat_t.NativeSensorQueue(capacity=16)
    for i in range(20):
        q.push_motion(i * 0.01, [1.0, 2.0, 3.0], [4.0, 5.0, 6.0])
    assert q.fused_count() == 16  # bounded ring
    rows = q.pop_interval(10.0, cap=32)
    assert len(rows) == 16
    q.destroy()


# -- the tests --------------------------------------------------------------


def test_native_sources_and_build(child):
    child(_check_sources)


@pytest.mark.skipif(not nat_j.available(), reason="the JAX package's native library "
                    "(it links libpng) did not build")
def test_native_matches_jax_native(child):
    x = _inputs()
    child(_check_native, x, _jax_outputs(x, native_on=True))


def test_numpy_twins_match_jax(child):
    x = _inputs()
    with _jax_native_off():
        want = _jax_outputs(x, native_on=False)
    child(_check_numpy, x, want)


def test_native_sensor_queue(child):
    child(_check_queue)
