"""Write a rendered synthetic sequence as a EuRoC MAV `mav0` layout.

NumPy and PIL only, so that both packages' runs read the same files:
chip_smoke.py's phase I (the PyTorch port), scripts/jax_ate_reference.py
--euroc (the JAX package on the CPU) and the parity tests. The layout is what
datasets/euroc.py reads: `imu0/data.csv`, `cam0/data.csv` with uint8 PNGs
under `cam0/data/`, `state_groundtruth_estimate0/data.csv`, and beside them
a `sensor.yaml` (OpenCV-YAML, the EuRoC sensor file's keys) and a
`setting.yaml`.

With a distortion, each frame is distorted on the host: the distorted pixel
p_d samples the pinhole frame bilinearly at `undistort_pixels(p_d)` (the
caller's camera.undistort_points_pixel, in f64), clamped to the frame's edge
where that point leaves it. Timestamps are written in integer nanoseconds.
"""

from __future__ import annotations

import os

import numpy as np

# EuRoC MAV dataset, mav0/cam0/sensor.yaml: radtan k1 k2 p1 p2
EUROC_CAM0_RADTAN = (-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05)

# bench.py's reference-yaml profile (bench.py make_config(light=False), the
# block used when the reference setting.yaml is absent) in setting.yaml's
# keys; its ransac_hypotheses = 128 has no key, so a run from these files
# keeps the code default
REFERENCE_SETTINGS = {
    "sliding_window": {"size": 12, "subframe_size": 5, "force_keyframe_landmarks": 50},
    "feature_tracker": {"min_keypoint_distance": 10.0, "max_keypoint_detection": 200,
                        "max_frames": 20},
    "solver": {"iteration_limit": 30},
    "rotation": {"misalignment_threshold": 0.02},
    "parsac": {"parsac_flag": 1, "dynamic_probability": 0.15, "threshold": 1.0,
               "keyframe_check_size": 1},
}


def _ns(t: float) -> int:
    return int(round(t * 1e9))


def distortion_map(undistort_pixels, width: int, height: int):
    """(map_y, map_x) f64 (H, W): where each distorted pixel samples the
    pinhole frame."""
    ys, xs = np.mgrid[0:height, 0:width].astype(np.float64)
    p_u = np.asarray(undistort_pixels(np.stack([xs, ys], axis=-1).reshape(-1, 2)),
                     np.float64)
    return p_u[:, 1].reshape(height, width), p_u[:, 0].reshape(height, width)


def sample_clamped(img: np.ndarray, map_y: np.ndarray, map_x: np.ndarray) -> np.ndarray:
    """Bilinear sample of img (H, W) at (map_y, map_x) in f64, the sample
    point clamped to the frame."""
    H, W = img.shape
    x = np.clip(map_x, 0.0, W - 1.0)
    y = np.clip(map_y, 0.0, H - 1.0)
    x0 = np.minimum(np.floor(x).astype(np.int64), W - 2)
    y0 = np.minimum(np.floor(y).astype(np.int64), H - 2)
    wx, wy = x - x0, y - y0
    im = np.asarray(img, np.float64)
    return (im[y0, x0] * (1 - wy) * (1 - wx) + im[y0, x0 + 1] * (1 - wy) * wx
            + im[y0 + 1, x0] * wy * (1 - wx) + im[y0 + 1, x0 + 1] * wy * wx)


def _yaml_list(v) -> str:
    return "[" + ", ".join(repr(float(x)) for x in v) + "]"


def _yaml_block(d: dict, indent: int = 0) -> str:
    out = []
    for k, v in d.items():
        if isinstance(v, dict):
            out.append(" " * indent + f"{k}:\n" + _yaml_block(v, indent + 2))
        else:
            out.append(" " * indent + f"{k}: {v}\n")
    return "".join(out)


def write_layout(root: str, seq, frames, K, dist=None, undistort_pixels=None,
                 settings=None, imu_after_s: float = 0.02):
    """Write `frames` ((H, W) pinhole images of seq.t_frame[:len(frames)],
    values in [0, 255]) and the sequence's IMU samples up to `imu_after_s`
    past the last frame as a mav0 layout under `root`.

    dist: radtan (k1, k2, p1, p2) to distort the frames with (then
    undistort_pixels, (N, 2) f64 distorted pixels -> undistorted pixels, is
    required), or None for pinhole frames. The sensor.yaml carries K, the
    distortion (flag 1 when dist is given), identity extrinsics and the
    default Config's noise; setting.yaml carries `settings` (nested dict;
    default REFERENCE_SETTINGS). Returns (mav0 dir, sensor.yaml,
    setting.yaml)."""
    from PIL import Image

    n = len(frames)
    H, W = np.shape(frames[0])
    mav0 = os.path.join(root, "mav0")
    for d in ("imu0", os.path.join("cam0", "data"), "state_groundtruth_estimate0"):
        os.makedirs(os.path.join(mav0, d), exist_ok=True)
    t_last = seq.t_frame[n - 1]
    with open(os.path.join(mav0, "imu0", "data.csv"), "w") as f:
        f.write("#timestamp [ns],w_RS_S_x,w_RS_S_y,w_RS_S_z,a_RS_S_x,a_RS_S_y,a_RS_S_z\n")
        for i, t in enumerate(seq.t_imu):
            if t > t_last + imu_after_s:
                break
            f.write(f"{_ns(t)}," + ",".join(repr(float(v)) for v in seq.gyro[i]) + ","
                    + ",".join(repr(float(v)) for v in seq.accel[i]) + "\n")
    maps = None
    if dist is not None:
        maps = distortion_map(undistort_pixels, W, H)
    with open(os.path.join(mav0, "cam0", "data.csv"), "w") as f:
        f.write("#timestamp [ns],filename\n")
        for i in range(n):
            img = np.asarray(frames[i], np.float64)
            if maps is not None:
                img = sample_clamped(img, *maps)
            name = f"{_ns(seq.t_frame[i])}.png"
            Image.fromarray(np.clip(img, 0, 255).astype(np.uint8), mode="L").save(
                os.path.join(mav0, "cam0", "data", name))
            f.write(f"{_ns(seq.t_frame[i])},{name}\n")
    with open(os.path.join(mav0, "state_groundtruth_estimate0", "data.csv"), "w") as f:
        f.write("#timestamp,p_x,p_y,p_z,q_w,q_x,q_y,q_z\n")
        for i in range(n):
            f.write(f"{_ns(seq.t_frame[i])},"
                    + ",".join(repr(float(v)) for v in seq.p_wb[i]) + ","
                    + ",".join(repr(float(v)) for v in seq.q_wb[i]) + "\n")

    sensor_yaml = os.path.join(root, "sensor.yaml")
    flag = 0 if dist is None else 1
    dist = (0.0, 0.0, 0.0, 0.0) if dist is None else dist
    K = np.asarray(K, np.float64)
    with open(sensor_yaml, "w") as f:
        f.write(f"""%YAML:1.0
imu:
  extrinsic:
    q_bi: [0.0, 0.0, 0.0, 1.0]
    p_bi: [0.0, 0.0, 0.0]
  noise:
    cov_g: {_yaml_list(1e-4 * np.eye(3).ravel())}
    cov_a: {_yaml_list(1e-2 * np.eye(3).ravel())}
    cov_bg: {_yaml_list(1e-8 * np.eye(3).ravel())}
    cov_ba: {_yaml_list(1e-6 * np.eye(3).ravel())}
cam0:
  resolution: [{W}, {H}]
  camera_model: pinhole
  distortion_model: radtan
  intrinsics: {_yaml_list([K[0, 0], K[1, 1], K[0, 2], K[1, 2]])}
  camera_distortion_flag: {flag}
  distortion: {_yaml_list(dist)}
  time_offset: 0.0
  extrinsic:
    q_bc: [0.0, 0.0, 0.0, 1.0]
    p_bc: [0.0, 0.0, 0.0]
  noise: [0.5, 0.0, 0.0, 0.5]
""")
    setting_yaml = os.path.join(root, "setting.yaml")
    with open(setting_yaml, "w") as f:
        f.write("%YAML:1.0\n" + _yaml_block(REFERENCE_SETTINGS if settings is None
                                            else settings))
    return mav0, sensor_yaml, setting_yaml
