"""ADVIO dataset reader.

Port of the JAX package's datasets/advio.py. Behavioral reference: the
reference's examples/dataset.hpp:633-821 (ADVIO class: frames.mov video +
separate accelerometer/gyroscope CSVs, four per-sequence-group iPhone
intrinsics/distortion tables, flip(-1) + undistort-on-read, streamed via
addAcc/addGyro).

Video path: `frames.mov` is demuxed by the dependency-free ISO-BMFF reader in
datasets/video.py (MJPEG decodes in-process; ADVIO's shipped H.264 gets the
documented one-time ffmpeg extraction hint). A pre-extracted `frames/`
directory, when present, takes priority — it skips per-frame decode cost.
The undistortion's remap tables are uploaded to the device once.
"""

from __future__ import annotations

import csv
import os
from typing import Iterator, Optional

import numpy as np

from rd_vio_tpu_torch.utils.metrics import GLOBAL_TIMER

# Per-sequence-group iPhone calibration (reference dataset.hpp:634-665
# seq_intrinsics_/seq_distortions_ tables; distortion is radtan k1 k2 p1 p2)
SEQ_INTRINSICS = [
    dict(fx=1077.2, fy=1079.3, cx=362.14, cy=636.39),  # seq 1-12
    dict(fx=1082.4, fy=1084.4, cx=364.68, cy=643.31),  # seq 13-17
    dict(fx=1076.9, fy=1078.5, cx=360.96, cy=639.31),  # seq 18-19
    dict(fx=1081.1, fy=1082.1, cx=359.59, cy=640.79),  # seq 20-23
]
SEQ_DISTORTIONS = [
    (-0.0003, -0.0009, 0.0478, 0.0339),  # seq 1-12
    (0.0007, -0.0002, 0.0366, 0.0803),   # seq 13-17
    (-0.0054, 0.0473, 0.0510, -0.0354),  # seq 18-19
    (0.0009, -0.0018, 0.0556, -0.0454),  # seq 20-23
]
RESOLUTION = (720, 1280)  # portrait iPhone capture (W, H)


def seq_group(seq_id: int) -> int:
    """Sequence-id -> calibration-group (reference get_seq_group)."""
    if 1 <= seq_id <= 12:
        return 0
    if 13 <= seq_id <= 17:
        return 1
    if 18 <= seq_id <= 19:
        return 2
    if 20 <= seq_id <= 23:
        return 3
    raise ValueError(f"invalid ADVIO seq id: {seq_id}")


class AdvioDataset:
    def __init__(self, advio_dir: str, seq_id: int = 1,
                 undistort: bool = True, device="cuda"):
        """advio_dir: either the `advio-XX` sequence directory itself or the
        dataset root containing it (reference layout:
        <root>/advio-XX/iphone/{frames.mov, frames.csv, accelerometer.csv,
        gyro.csv}). device: where frames are remapped (undistort=True)."""
        seq_dir = os.path.join(advio_dir, f"advio-{seq_id:02d}")
        if not os.path.isdir(seq_dir):
            seq_dir = advio_dir  # advio_dir IS the sequence directory
        root = os.path.join(seq_dir, "iphone")
        self.root = root
        self.accel = self._read_csv3(os.path.join(root, "accelerometer.csv"))
        self.gyro = self._read_csv3(os.path.join(root, "gyro.csv"))

        group = seq_group(seq_id)
        self.intrinsics = dict(SEQ_INTRINSICS[group], resolution=RESOLUTION)
        self.distortion = SEQ_DISTORTIONS[group]

        # frame source: extracted frames/ dir wins, else demux frames.mov
        self._mov = None
        frames_dir = os.path.join(root, "frames")
        t_csv = self._read_frame_times(os.path.join(root, "frames.csv"))
        if os.path.isdir(frames_dir):
            self.frames = t_csv
        else:
            from rd_vio_tpu_torch.datasets.video import MovReader

            self._mov = MovReader(os.path.join(root, "frames.mov"))
            # the reference trusts frames.csv timestamps and pulls frames
            # sequentially from the video (dataset.hpp:755-768)
            n = min(len(self._mov), len(t_csv["t"]))
            self.frames = {"t": t_csv["t"][:n], "files": [None] * n}

        self._undistort = None
        if undistort:
            from rd_vio_tpu_torch.datasets.euroc import Undistorter
            from rd_vio_tpu_torch.ops.image.undistort import build_remap

            intr = self.intrinsics
            K = np.array([[intr["fx"], 0, intr["cx"]],
                          [0, intr["fy"], intr["cy"]], [0, 0, 1.0]])
            W, H = RESOLUTION
            self._undistort = Undistorter(
                *build_remap(K, np.asarray(self.distortion), "radtan", W, H), device)

    @staticmethod
    def _read_csv3(path):
        ts, vals = [], []
        with open(path) as f:
            for row in csv.reader(f):
                if not row or row[0].startswith("#"):
                    continue
                ts.append(float(row[0]))
                vals.append([float(x) for x in row[1:4]])
        return {"t": np.asarray(ts), "v": np.asarray(vals)}

    def _read_frame_times(self, path):
        ts, files = [], []
        frames_dir = os.path.join(self.root, "frames")
        with open(path) as f:
            for i, row in enumerate(csv.reader(f)):
                if not row or row[0].startswith("#"):
                    continue
                ts.append(float(row[0]))
                # extracted frame naming: frame index or explicit filename
                name = row[1].strip() if len(row) > 1 else f"{i:06d}.png"
                files.append(os.path.join(frames_dir, name))
        return {"t": np.asarray(ts), "files": files}

    def load_image(self, idx: int) -> np.ndarray:
        with GLOBAL_TIMER.time("ds.load"):
            if self._mov is not None:
                img = self._mov.decode(idx)
            else:
                from PIL import Image

                img = np.asarray(
                    Image.open(self.frames["files"][idx]).convert("L"),
                    dtype=np.float32,
                )
        # reference dataset.hpp:725-728: cv::flip(img, img, -1) (both axes,
        # the iPhone mounts upside down), then undistort with the group calib
        img = img[::-1, ::-1]
        und = self._undistort
        if und is not None and img.shape == tuple(und.map_y.shape):
            img = und(img)
        return np.ascontiguousarray(img)

    def events(self) -> Iterator[tuple]:
        """Time-ordered (t, kind, index) with kind in {"gyro", "accel",
        "frame"} — ADVIO streams gyro/accel separately
        (reference test_advio.cpp addAcc/addGyro)."""
        items = (
            [(t, "gyro", i) for i, t in enumerate(self.gyro["t"])]
            + [(t, "accel", i) for i, t in enumerate(self.accel["t"])]
            + [(t, "frame", i) for i, t in enumerate(self.frames["t"])]
        )
        items.sort(key=lambda x: (x[0], x[1]))
        yield from items


def run_advio(advio_dir: str, seq_id: int = 1,
              setting_yaml: Optional[str] = None,
              max_frames: Optional[int] = None, caps=None,
              undistort: bool = True, config_hook=None, device="cuda"):
    """test_advio equivalent: separate gyro/accel streams through the handler
    interleaver, on `device` (the card unless the caller names another).
    Returns (est_t, est_p, dataset, odometry)."""
    from rd_vio_tpu_torch.config import Config, load_config
    from rd_vio_tpu_torch.datasets.euroc import collect_latest
    from rd_vio_tpu_torch.models.image_backend import TorchImageBackend
    from rd_vio_tpu_torch.models.odometry import Odometry

    ds = AdvioDataset(advio_dir, seq_id=seq_id, undistort=undistort, device=device)
    cfg = load_config(setting_yaml=setting_yaml) if setting_yaml else Config()
    intr = ds.intrinsics
    cfg.camera_intrinsic = np.array(
        [[intr["fx"], 0, intr["cx"]], [0, intr["fy"], intr["cy"]], [0, 0, 1.0]]
    )
    cfg.camera_resolution = intr["resolution"]
    if config_hook is not None:
        config_hook(cfg, ds)
    odo = Odometry(cfg, TorchImageBackend(cfg, device), caps=caps)

    est_t, est_p = [], []
    n = 0
    for t, kind, i in ds.events():
        if kind == "gyro":
            odo.add_gyroscope(t, ds.gyro["v"][i])
        elif kind == "accel":
            odo.add_accelerometer(t, ds.accel["v"][i])
        else:
            odo.add_frame(t, ds.load_image(i))
            n += 1
            collect_latest(odo, est_t, est_p)
            if max_frames and n >= max_frames:
                break
    return np.asarray(est_t), np.asarray(est_p), ds, odo
