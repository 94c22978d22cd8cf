"""EuRoC runner of the PyTorch port — the reference's examples/test_euroc.cpp
equivalent (examples/run_euroc.py runs the JAX package).

Usage:
  python examples/torch_run_euroc.py <mav0_dir> <sensor_yaml> <setting_yaml> [max_frames]
      [--sync] [--device cpu] [--no-warmup]

Streams interleaved IMU + frames through the port's Odometry, threaded
unless --sync is given, on the GPU unless --device cpu is given, and
reports ATE against state_groundtruth_estimate0 plus throughput. Frames are
read by the native C++ loader (libpng decode, prefetch threads) where it
builds, else by PIL (datasets/euroc.run_euroc); the runner prints which.
Before the clock starts it builds the LK kernel (on the GPU) and both native
libraries. --no-warmup is accepted and changes nothing.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402


def build_all(device) -> dict:
    """Build what the run uses before it is timed: the LK kernel (on a CUDA
    device) and the two native libraries. Returns what is available."""
    import torch

    from rd_vio_tpu_torch import native
    from rd_vio_tpu_torch.ops.image import klt

    if torch.device(device).type == "cuda":
        klt.load_kernel()
    return {"native": native.available(), "euroc_loader": native.euroc_available()}


def run(mav0, sensor_yaml, setting_yaml, max_frames=None, device="cuda",
        threaded=True, on_odometry=None) -> dict:
    """The runner's path. Returns a dict: reader ("native" or "PIL"),
    config, odometry (joined; the caller closes it), est_t, est_p (the
    estimates collected after each frame once tracking), gt (ground truth
    or None), frames, wall_s (from the first event to the end of join())."""
    from rd_vio_tpu_torch import native
    from rd_vio_tpu_torch.config import load_config
    from rd_vio_tpu_torch.datasets import euroc
    from rd_vio_tpu_torch.models.image_backend import TorchImageBackend
    from rd_vio_tpu_torch.models.odometry import Odometry

    est_t, est_p = [], []
    n = 0
    t0 = time.perf_counter()
    if native.euroc_available():
        reader = "native"
        cfg = load_config(sensor_yaml, setting_yaml)
        und = euroc.make_undistorter(cfg, device)
        odo = Odometry(cfg, TorchImageBackend(cfg, device), threaded=threaded)
        if on_odometry is not None:
            on_odometry(odo)
        ds = native.NativeEurocDataset(mav0)
        gt_path = os.path.join(mav0, "state_groundtruth_estimate0", "data.csv")
        gt = euroc.EurocDataset._read_gt(gt_path) if os.path.exists(gt_path) else None
        events = sorted([(t, 0, i) for i, t in enumerate(ds.imu_t)]
                        + [(t, 1, i) for i, t in enumerate(ds.frame_t)])
        t0 = time.perf_counter()
        try:
            for t, kind, i in events:
                if kind == 0:
                    odo.add_motion(t, ds.gyro[i], ds.accel[i])
                else:
                    img = ds.load_image(i)
                    if und is not None:
                        img = und(img)
                    odo.add_frame(t, img)
                    n += 1
                    euroc.collect_latest(odo, est_t, est_p)
                    if max_frames and n >= max_frames:
                        break
        finally:
            ds.close()
    else:
        reader = "PIL"
        est_t, est_p, dsv, odo = euroc.run_euroc(
            mav0, sensor_yaml, setting_yaml, max_frames=max_frames, device=device,
            threaded=threaded, on_odometry=on_odometry)
        cfg, gt = odo.config, dsv.ground_truth
        n = min(max_frames or len(dsv.frames["t"]), len(dsv.frames["t"]))
    odo.join()
    return {"reader": reader, "config": cfg, "odometry": odo,
            "est_t": np.asarray(est_t), "est_p": np.asarray(est_p), "gt": gt,
            "frames": n, "wall_s": time.perf_counter() - t0}


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    device = argv[argv.index("--device") + 1] if "--device" in argv else "cuda"
    args = [a for k, a in enumerate(argv)
            if not a.startswith("--") and (k == 0 or argv[k - 1] != "--device")]
    if len(args) < 3:
        print(__doc__)
        return 2
    mav0, sensor_yaml, setting_yaml = args[:3]
    max_frames = int(args[3]) if len(args) > 3 else None

    from rd_vio_tpu_torch.utils.trajectory import associate, ate_rmse

    built = build_all(device)
    print(f"device {device}; native host library {built['native']}, "
          f"native EuRoC loader {built['euroc_loader']}")
    res = run(mav0, sensor_yaml, setting_yaml, max_frames=max_frames, device=device,
              threaded="--sync" not in argv)
    res["odometry"].close()
    n, est_t, est_p, gt, wall = (res[k] for k in ("frames", "est_t", "est_p", "gt",
                                                  "wall_s"))
    print(f"reader: {res['reader']}")
    print(f"frames {n}, tracked {len(est_p)}, wall {wall:.1f}s ({n/wall:.2f} fps)")
    if gt is not None and len(est_p) > 10:
        ie, ig = associate(est_t, gt["t"])
        if len(ie) > 10:
            print(f"ATE (SE3-aligned RMSE): {ate_rmse(est_p[ie], gt['p'][ig]):.4f} m "
                  f"over {len(ie)} poses")
    return 0


if __name__ == "__main__":
    sys.exit(main())
