"""Native (C++) host components: the batched IMU preintegrator, the mean-only
IMU predictor, the greedy Poisson-disk filter and the sensor queue.

Port of the JAX package's native/__init__.py, without its EuRoC loader (it
links libpng; it comes with the datasets). The sources beside this file
(`preintegrator.cpp`, `sensor_queue.cpp`) are the JAX package's, code for
code. At first use they are compiled with g++ (the JAX package's flags:
-O2 -std=c++17 -shared -fPIC -pthread) into rd_vio_tpu_torch/_build/, under
a name that carries the sources' hash, and bound through ctypes. Several
processes may build at once (the tests run under xdist): each compiles to a
temporary name and `os.replace`s it into place.

ctypes releases the interpreter lock for the duration of a foreign call, so
a threaded pipeline's other worker runs meanwhile.

`available()` is False where the library cannot be built (no g++); the
callers (ops/preintegration_np.py, ops/poisson_disk.py) then take their
NumPy loops. `CALLS` counts the calls of each entry point, so that a run can
show that the native path was taken.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

_HERE = Path(__file__).resolve().parent
_SOURCES = ("sensor_queue.cpp", "preintegrator.cpp")
BUILD_DIR = _HERE.parent / "_build"
_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC", "-pthread")

_lock = threading.Lock()
_lib = None
_error = None  # the build's or load's exception, once it failed

# calls of each native entry point (guarded by _calls_lock: the threaded
# pipeline calls them from two workers)
CALLS: collections.Counter = collections.Counter()
_calls_lock = threading.Lock()


def _count(name: str):
    with _calls_lock:
        CALLS[name] += 1


def library_path() -> Path:
    """Where the library of the current sources is (or will be) built."""
    h = hashlib.sha256()
    for s in _SOURCES:
        h.update((_HERE / s).read_bytes())
    h.update(" ".join(_FLAGS).encode())
    return BUILD_DIR / f"librdvio_native_{h.hexdigest()[:12]}.so"


def build() -> Path:
    """Compile the sources unless their library is there already."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = ["g++", *_FLAGS, *(str(_HERE / s) for s in _SOURCES), "-o", tmp]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed ({proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return so


def _bind(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    i64, f64 = ctypes.c_int64, ctypes.c_double
    dptr = ctypes.POINTER(ctypes.c_double)
    u8ptr = ctypes.POINTER(ctypes.c_ubyte)
    # sensor queue
    lib.rdvio_queue_create.argtypes = [i64]
    lib.rdvio_queue_create.restype = i64
    lib.rdvio_queue_push_gyro.argtypes = [i64] + [f64] * 4
    lib.rdvio_queue_push_accel.argtypes = [i64] + [f64] * 4
    lib.rdvio_queue_push_motion.argtypes = [i64, f64, dptr, dptr]
    lib.rdvio_queue_fused_count.argtypes = [i64]
    lib.rdvio_queue_fused_count.restype = i64
    lib.rdvio_queue_pop_interval.argtypes = [i64, f64, dptr, i64]
    lib.rdvio_queue_pop_interval.restype = i64
    lib.rdvio_queue_destroy.argtypes = [i64]
    # preintegrator
    lib.rdvio_preintegrate_batch.argtypes = [ctypes.c_longlong] * 2 + [dptr] * 20
    lib.rdvio_predict_mean.argtypes = [ctypes.c_longlong] + [dptr] * 11
    lib.rdvio_poisson_filter.argtypes = [
        ctypes.c_longlong, dptr, u8ptr, f64, f64, f64, ctypes.c_longlong, u8ptr]
    return lib


def load_library() -> ctypes.CDLL:
    """Build (once per source hash) and load the library; raises on failure
    (and again on every later call, without another attempt)."""
    global _lib, _error
    with _lock:
        if _lib is not None:
            return _lib
        if _error is not None:
            raise RuntimeError("native library unavailable") from _error
        try:
            _lib = _bind(build())
        except Exception as e:  # noqa: BLE001 - kept and re-raised
            _error = e
            raise
        return _lib


def available() -> bool:
    try:
        load_library()
        return True
    except Exception:  # noqa: BLE001
        return False


_DP = ctypes.POINTER(ctypes.c_double)


def _f64(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.float64)


def _p(a: np.ndarray):
    return a.ctypes.data_as(_DP)


def preintegrate_batch(dts, ws, accs, bg, ba, cov_w, cov_a, cov_bg, cov_ba):
    """Batched sequential IMU preintegration on the host (f64), returning a
    dict of NumPy arrays with leading axis F: t, q, p, v, cov, dq_dbg,
    dp_dbg, dp_dba, dv_dbg, dv_dba, sqrt_inv_cov. Shapes: dts (F, N);
    ws/accs (F, N, 3); bg/ba (F, 3); cov_* (3, 3)."""
    lib = load_library()
    _count("preintegrate_batch")
    F, N = np.shape(dts)
    ins = [_f64(a) for a in (dts, ws, accs, bg, ba, cov_w, cov_a, cov_bg, cov_ba)]
    out = {
        "t": np.zeros(F), "q": np.zeros((F, 4)), "p": np.zeros((F, 3)),
        "v": np.zeros((F, 3)), "cov": np.zeros((F, 15, 15)),
        "dq_dbg": np.zeros((F, 3, 3)), "dp_dbg": np.zeros((F, 3, 3)),
        "dp_dba": np.zeros((F, 3, 3)), "dv_dbg": np.zeros((F, 3, 3)),
        "dv_dba": np.zeros((F, 3, 3)), "sqrt_inv_cov": np.zeros((F, 15, 15)),
    }
    lib.rdvio_preintegrate_batch(F, N, *(_p(a) for a in ins),
                                 *(_p(a) for a in out.values()))
    return out


def predict_mean(q0, p0, v0, bg, ba, dts, ws, accs):
    """Mean-only IMU propagation of one interval (f64); returns (q, p, v).
    Mirrors ops/preintegration_np.predict_frame_mean."""
    lib = load_library()
    _count("predict_mean")
    dts, ws, accs = _f64(dts), _f64(ws), _f64(accs)
    q0, p0, v0, bg, ba = _f64(q0), _f64(p0), _f64(v0), _f64(bg), _f64(ba)
    q, p, v = np.zeros(4), np.zeros(3), np.zeros(3)
    lib.rdvio_predict_mean(len(dts), _p(dts), _p(ws), _p(accs), _p(bg), _p(ba),
                           _p(q0), _p(p0), _p(v0), _p(q), _p(p), _p(v))
    return q, p, v


def poisson_filter(points, valid, min_distance, width, height,
                   preset_count: int = 0):
    """Greedy Poisson-disk grid filter; returns the accepted mask (N,) bool."""
    lib = load_library()
    _count("poisson_filter")
    pts = _f64(points)
    val = np.ascontiguousarray(valid, dtype=np.uint8)
    acc = np.zeros(len(pts), np.uint8)
    u8 = ctypes.POINTER(ctypes.c_ubyte)
    lib.rdvio_poisson_filter(len(pts), _p(pts), val.ctypes.data_as(u8),
                             float(min_distance), float(width), float(height),
                             int(preset_count), acc.ctypes.data_as(u8))
    return acc.astype(bool)


class NativeSensorQueue:
    """Gyro/accel interleaving ring buffer (reference handler.cpp:56-152)."""

    def __init__(self, capacity: int = 8192):
        self.lib = load_library()
        self.handle = self.lib.rdvio_queue_create(capacity)

    def push_gyro(self, t: float, w):
        self.lib.rdvio_queue_push_gyro(self.handle, t, w[0], w[1], w[2])

    def push_accel(self, t: float, a):
        self.lib.rdvio_queue_push_accel(self.handle, t, a[0], a[1], a[2])

    def push_motion(self, t: float, w, a):
        self.lib.rdvio_queue_push_motion(self.handle, t, _p(_f64(w)), _p(_f64(a)))

    def fused_count(self) -> int:
        return int(self.lib.rdvio_queue_fused_count(self.handle))

    def pop_interval(self, t_end: float, cap: int = 1024) -> np.ndarray:
        out = np.zeros((cap, 7))
        n = self.lib.rdvio_queue_pop_interval(self.handle, t_end, _p(out), cap)
        return out[: max(n, 0)]

    def destroy(self):
        if self.handle:
            self.lib.rdvio_queue_destroy(self.handle)
            self.handle = 0
