"""EuRoC MAV dataset reader (mav0 layout).

Port of the JAX package's datasets/euroc.py. Behavioral reference: the
reference's examples/dataset.hpp:454-624 (EuRoC class: cam0/data.csv + PNG
images, imu0/data.csv gyro+accel, undistortion on read) and
examples/test_euroc.cpp (interleaved IMU/frame streaming).

PNG decoding via PIL; undistortion via the precomputed remap table
(ops/image/undistort), whose two tables are uploaded to the device once.
Ground truth from state_groundtruth_estimate0 for ATE. Host spans (in
utils.metrics.GLOBAL_TIMER): `ds.load` for a frame's decode, `ds.undistort`
for its remap, upload and fetch included.
"""

from __future__ import annotations

import csv
import dataclasses
import os
from typing import Callable, Iterator, Optional

import numpy as np

from rd_vio_tpu_torch.utils.metrics import GLOBAL_TIMER


@dataclasses.dataclass
class EurocEvent:
    t: float
    kind: str  # "imu" | "frame"
    gyro: Optional[np.ndarray] = None
    accel: Optional[np.ndarray] = None
    image_path: Optional[str] = None


class EurocDataset:
    def __init__(self, mav0_dir: str, undistort=None):
        """mav0_dir: path containing cam0/, imu0/, state_groundtruth_estimate0/.

        undistort: optional callable (H, W) image -> undistorted image
        (make_undistorter, from the sensor YAML)."""
        self.root = mav0_dir
        self.undistort = undistort
        self.imu = self._read_imu(os.path.join(mav0_dir, "imu0", "data.csv"))
        self.frames = self._read_cam(os.path.join(mav0_dir, "cam0", "data.csv"))
        gt_path = os.path.join(
            mav0_dir, "state_groundtruth_estimate0", "data.csv"
        )
        self.ground_truth = (
            self._read_gt(gt_path) if os.path.exists(gt_path) else None
        )

    @staticmethod
    def _read_imu(path):
        ts, gyro, accel = [], [], []
        with open(path) as f:
            for row in csv.reader(f):
                if not row or row[0].startswith("#"):
                    continue
                ts.append(int(row[0]) * 1e-9)
                gyro.append([float(x) for x in row[1:4]])
                accel.append([float(x) for x in row[4:7]])
        return {
            "t": np.asarray(ts),
            "gyro": np.asarray(gyro),
            "accel": np.asarray(accel),
        }

    def _read_cam(self, path):
        ts, files = [], []
        data_dir = os.path.join(os.path.dirname(path), "data")
        with open(path) as f:
            for row in csv.reader(f):
                if not row or row[0].startswith("#"):
                    continue
                ts.append(int(row[0]) * 1e-9)
                files.append(os.path.join(data_dir, row[1].strip()))
        return {"t": np.asarray(ts), "files": files}

    @staticmethod
    def _read_gt(path):
        ts, p, q = [], [], []
        with open(path) as f:
            for row in csv.reader(f):
                if not row or row[0].startswith("#"):
                    continue
                ts.append(int(row[0]) * 1e-9)
                p.append([float(x) for x in row[1:4]])
                q.append([float(x) for x in row[4:8]])  # w x y z
        return {"t": np.asarray(ts), "p": np.asarray(p), "q": np.asarray(q)}

    def load_image(self, path) -> np.ndarray:
        from PIL import Image

        with GLOBAL_TIMER.time("ds.load"):
            img = np.asarray(Image.open(path).convert("L"), dtype=np.float32)
        if self.undistort is not None:
            img = self.undistort(img)
        return img

    def events(self) -> Iterator[EurocEvent]:
        """Time-ordered interleaved IMU + frame events, IMU first on equal
        time (reference test_euroc.cpp:46-95)."""
        items = [
            (t, 0, i) for i, t in enumerate(self.imu["t"])
        ] + [(t, 1, i) for i, t in enumerate(self.frames["t"])]
        items.sort()
        for t, kind, i in items:
            if kind == 0:
                yield EurocEvent(
                    t=t, kind="imu",
                    gyro=self.imu["gyro"][i], accel=self.imu["accel"][i],
                )
            else:
                yield EurocEvent(
                    t=t, kind="frame", image_path=self.frames["files"][i]
                )


class Undistorter:
    """(H, W) host image -> undistorted (H, W) f32 host image: one bilinear
    remap (ops/image/undistort.remap_bilinear) on `device`, whose tables
    were uploaded there once, at construction. The frame goes up and comes
    back on every call (the image backend's preprocess takes host arrays)."""

    def __init__(self, map_y: np.ndarray, map_x: np.ndarray, device="cuda"):
        from rd_vio_tpu_torch.utils.host import to_device

        self.device = device
        self.map_y = to_device(map_y, device)
        self.map_x = to_device(map_x, device)

    def __call__(self, img) -> np.ndarray:
        from rd_vio_tpu_torch.ops.image.undistort import remap_bilinear
        from rd_vio_tpu_torch.utils.host import fetch, to_device

        with GLOBAL_TIMER.time("ds.undistort"):
            x = to_device(np.asarray(img, np.float32), self.device)
            return fetch(remap_bilinear(x, self.map_y, self.map_x))


def make_undistorter(cfg, device="cuda") -> Optional[Undistorter]:
    """Build an image undistorter from a Config (None when the distortion
    flag is off)."""
    if not cfg.camera_distortion_flag:
        return None
    from rd_vio_tpu_torch.ops.image.undistort import build_remap

    W, H = cfg.camera_resolution
    map_y, map_x = build_remap(
        cfg.camera_intrinsic, cfg.camera_distortion,
        cfg.camera_distortion_model, W, H,
    )
    return Undistorter(map_y, map_x, device)


def collect_latest(odo, est_t: list, est_p: list):
    """After a frame: append the latest state's (t, p) once tracking
    (the runners' and bench.py's collection of estimates)."""
    if odo.state() == 1:
        ls = odo.handler.get_latest_state()
        if ls is not None:
            est_t.append(ls[0])
            est_p.append(ls[2])


def run_euroc(mav0_dir: str, sensor_yaml: str, setting_yaml: str,
              max_frames: Optional[int] = None, caps=None, device="cuda",
              threaded: bool = False,
              on_odometry: Optional[Callable] = None):
    """test_euroc equivalent: stream a EuRoC sequence through the Odometry on
    `device` (the card unless the caller names another) and return (est_t,
    est_p, dataset, odometry). `on_odometry(odo)` runs before the first
    event. A threaded Odometry is returned as it stands after the last
    event: call join() before reading its final state, and close()."""
    from rd_vio_tpu_torch.config import load_config
    from rd_vio_tpu_torch.models.image_backend import TorchImageBackend
    from rd_vio_tpu_torch.models.odometry import Odometry

    cfg = load_config(sensor_yaml, setting_yaml)
    und = make_undistorter(cfg, device)
    ds = EurocDataset(mav0_dir, undistort=und)
    backend = TorchImageBackend(cfg, device)
    odo = Odometry(cfg, backend, caps=caps, threaded=threaded)
    if on_odometry is not None:
        on_odometry(odo)

    est_t, est_p = [], []
    n = 0
    for ev in ds.events():
        if ev.kind == "imu":
            odo.add_motion(ev.t, ev.gyro, ev.accel)
        else:
            odo.add_frame(ev.t, ds.load_image(ev.image_path))
            n += 1
            collect_latest(odo, est_t, est_p)
            if max_frames and n >= max_frames:
                break
    return np.asarray(est_t), np.asarray(est_p), ds, odo
