"""Native (C++) host components: the batched IMU preintegrator, the mean-only
IMU predictor, the greedy Poisson-disk filter, the sensor queue and the EuRoC
loader.

Port of the JAX package's native/__init__.py. The sources beside this file
are the JAX package's, code for code (comments may differ). They build into
two libraries: `preintegrator.cpp` and `sensor_queue.cpp` into the host
library, and `euroc_loader.cpp` (CSV parse, libpng decode to f32, a
prefetch thread pool) into a library of its own that links libpng, so that
the host library builds where libpng is missing. At first use each is
compiled with g++ (the JAX package's flags: -O2 -std=c++17 -shared -fPIC
-pthread) into rd_vio_tpu_torch/_build/, under a name that carries its
sources' hash, and bound through ctypes. Several processes may build at once
(the tests run under xdist): each compiles to a temporary name and
`os.replace`s it into place.

ctypes releases the interpreter lock for the duration of a foreign call, so
a threaded pipeline's other worker runs meanwhile.

`available()` is False where the host library cannot be built (no g++); the
callers (ops/preintegration_np.py, ops/poisson_disk.py) then take their
NumPy loops. `euroc_available()` is False where the loader cannot be built
(no libpng headers); the EuRoC runner then reads through PIL. `CALLS` counts
the calls of each entry point, so that a run can show that the native path
was taken.
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

from rd_vio_tpu_torch.utils.metrics import GLOBAL_TIMER

_HERE = Path(__file__).resolve().parent
_SOURCES = ("sensor_queue.cpp", "preintegrator.cpp")
_EUROC_SOURCES = ("euroc_loader.cpp",)
_EUROC_LIBS = ("-lpng",)
BUILD_DIR = _HERE.parent / "_build"
_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC", "-pthread")

# calls of each native entry point (guarded by _calls_lock: the threaded
# pipeline calls them from two workers)
CALLS: collections.Counter = collections.Counter()
_calls_lock = threading.Lock()


def _count(name: str):
    with _calls_lock:
        CALLS[name] += 1


def _library_path(stem: str, sources, libs) -> Path:
    h = hashlib.sha256()
    for s in sources:
        h.update((_HERE / s).read_bytes())
    h.update(" ".join(_FLAGS + libs).encode())
    return BUILD_DIR / f"{stem}_{h.hexdigest()[:12]}.so"


def library_path() -> Path:
    """Where the host library of the current sources is (or will be) built."""
    return _library_path("librdvio_native", _SOURCES, ())


def euroc_library_path() -> Path:
    """Where the EuRoC loader's library is (or will be) built."""
    return _library_path("librdvio_euroc", _EUROC_SOURCES, _EUROC_LIBS)


def _build(so: Path, sources, libs) -> Path:
    """Compile `sources` into `so` unless it is there already."""
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = ["g++", *_FLAGS, *(str(_HERE / s) for s in sources), "-o", tmp, *libs]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed ({proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return so


def build() -> Path:
    """Compile the host library unless it is there already."""
    return _build(library_path(), _SOURCES, ())


def build_euroc() -> Path:
    """Compile the EuRoC loader's library unless it is there already."""
    return _build(euroc_library_path(), _EUROC_SOURCES, _EUROC_LIBS)


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


def _bind_euroc(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    i64 = ctypes.c_int64
    cint_p = ctypes.POINTER(ctypes.c_int)
    lib.rdvio_euroc_open.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.rdvio_euroc_open.restype = i64
    lib.rdvio_euroc_imu_count.argtypes = [i64]
    lib.rdvio_euroc_imu_count.restype = i64
    lib.rdvio_euroc_imu_data.argtypes = [i64, ctypes.POINTER(ctypes.c_double)]
    lib.rdvio_euroc_imu_data.restype = None
    lib.rdvio_euroc_frame_count.argtypes = [i64]
    lib.rdvio_euroc_frame_count.restype = i64
    lib.rdvio_euroc_frame_times.argtypes = [i64, ctypes.POINTER(ctypes.c_double)]
    lib.rdvio_euroc_frame_times.restype = None
    lib.rdvio_euroc_image_size.argtypes = [i64, cint_p, cint_p]
    lib.rdvio_euroc_image_size.restype = None
    lib.rdvio_euroc_load_image.argtypes = [i64, i64, ctypes.POINTER(ctypes.c_float)]
    lib.rdvio_euroc_load_image.restype = ctypes.c_int
    lib.rdvio_euroc_prefetch.argtypes = [i64, i64, i64]
    lib.rdvio_euroc_prefetch.restype = None
    lib.rdvio_euroc_close.argtypes = [i64]
    lib.rdvio_euroc_close.restype = None
    return lib


class _Loader:
    """Build (once per source hash) and load one library; raises on failure
    (and again on every later call, without another attempt)."""

    def __init__(self, build_fn, bind_fn):
        self._build, self._bind = build_fn, bind_fn
        self._lock = threading.Lock()
        self._lib = None
        self._error = None  # the build's or load's exception, once it failed

    def __call__(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is not None:
                return self._lib
            if self._error is not None:
                raise RuntimeError("native library unavailable") from self._error
            try:
                self._lib = self._bind(self._build())
            except Exception as e:  # noqa: BLE001 - kept and re-raised
                self._error = e
                raise
            return self._lib


load_library = _Loader(build, _bind)
load_euroc_library = _Loader(build_euroc, _bind_euroc)


def available() -> bool:
    try:
        load_library()
        return True
    except Exception:  # noqa: BLE001
        return False


def euroc_available() -> bool:
    try:
        load_euroc_library()
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


class NativeEurocDataset:
    """Fast EuRoC reader backed by the native loader (CSV + libpng decode with
    background prefetch)."""

    def __init__(self, mav0_dir: str, n_threads: int = 2):
        self.lib = load_euroc_library()
        _count("euroc_open")
        self.handle = self.lib.rdvio_euroc_open(mav0_dir.encode(), n_threads)
        if not self.handle:
            raise IOError(f"failed to open EuRoC dir {mav0_dir}")
        n_imu = self.lib.rdvio_euroc_imu_count(self.handle)
        buf = np.zeros((n_imu, 7))
        self.lib.rdvio_euroc_imu_data(self.handle, _p(buf))
        self.imu_t = buf[:, 0].copy()
        self.gyro = buf[:, 1:4].copy()
        self.accel = buf[:, 4:7].copy()
        ts = np.zeros(self.lib.rdvio_euroc_frame_count(self.handle))
        self.lib.rdvio_euroc_frame_times(self.handle, _p(ts))
        self.frame_t = ts
        w, h = ctypes.c_int(), ctypes.c_int()
        self.lib.rdvio_euroc_image_size(self.handle, ctypes.byref(w), ctypes.byref(h))
        self.width, self.height = w.value, h.value

    def load_image(self, idx: int, prefetch_ahead: int = 8) -> np.ndarray:
        """Frame `idx` as (H, W) f32 grayscale; queues the next
        `prefetch_ahead` frames for the decode threads."""
        _count("euroc_load_image")
        out = np.zeros((self.height, self.width), np.float32)
        with GLOBAL_TIMER.time("ds.load"):
            rc = self.lib.rdvio_euroc_load_image(
                self.handle, idx, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        if rc != 0:
            raise IOError(f"image decode failed for frame {idx} (rc={rc})")
        if prefetch_ahead:
            self.lib.rdvio_euroc_prefetch(self.handle, idx + 1, prefetch_ahead)
        return out

    def close(self):
        if self.handle:
            self.lib.rdvio_euroc_close(self.handle)
            self.handle = 0

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 - interpreter teardown
            pass
