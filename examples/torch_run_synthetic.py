"""Run the PyTorch port's full VIO pipeline on a synthetic sequence and
report ATE (examples/run_synthetic.py runs the JAX package).

The synthetic analogue of the reference's examples/test_euroc.cpp runner.

Usage: python examples/torch_run_synthetic.py [duration_s] [--images]
           [--klt-pallas] [--threaded] [--device cpu]
  --images      render pixel images and use the real CLAHE/GFTT/LK frontend
                (TorchImageBackend, kp_cap=256, the fused LK kernel: one
                launch per frame pair) instead of the perfect-match backend.
  --klt-pallas  with --images: track through the per-level LK kernel
                (ops/image/klt.lk_level, one launch per pyramid level and
                direction: 8 per frame pair), the counterpart of the JAX
                package's per-level Pallas kernel.
  --threaded    run the two-stage pipeline (feature tracker / optimizer
                worker threads, the reference's THREADING=ON model) instead
                of inline synchronous dispatch.
  --device cpu  run on the CPU (the LK kernels' plain versions) instead of
                the GPU.
"""

import functools
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    duration = float(argv[0]) if argv and not argv[0].startswith("-") else 10.0
    device = argv[argv.index("--device") + 1] if "--device" in argv else "cuda"
    use_images = "--images" in argv

    from rd_vio_tpu_torch.config import Config
    from rd_vio_tpu_torch.datasets import synthetic
    from rd_vio_tpu_torch.datasets.euroc import collect_latest
    from rd_vio_tpu_torch.models.odometry import Odometry
    from rd_vio_tpu_torch.utils.trajectory import ate_rmse

    seq = synthetic.generate(duration=duration, n_landmarks=1200, max_keypoints=150)
    cfg = Config()
    if use_images:
        from rd_vio_tpu_torch.datasets.renderer import SequenceRenderer
        from rd_vio_tpu_torch.models.image_backend import TorchImageBackend
        from rd_vio_tpu_torch.ops.image import klt

        rend = SequenceRenderer(seq, image_size=(320, 240))
        cfg.camera_intrinsic = rend.K
        cfg.camera_resolution = (320, 240)
        cfg.feature_tracker_min_keypoint_distance = 12.0
        lk = klt.lk_track_fwd_rev
        if "--klt-pallas" in argv:
            lk = functools.partial(klt.lk_track_fwd_rev_plain, level=klt.lk_level)
        backend = TorchImageBackend(cfg, device, kp_cap=256, lk=lk)
        image_of = rend.render
    else:
        from rd_vio_tpu_torch.models.feature_tracker import SyntheticBackend

        cfg.camera_intrinsic = seq.K_mat
        backend = SyntheticBackend(seq)
        image_of = lambda i: i  # noqa: E731

    threaded = "--threaded" in argv
    odo = Odometry(cfg, backend, threaded=threaded, device=device)
    events = sorted(
        [(t, 1, i) for i, t in enumerate(seq.t_imu)]
        + [(t, 0, i) for i, t in enumerate(seq.t_frame)]
    )
    est_t, est_p = [], []
    t0 = time.perf_counter()
    for t, kind, i in events:
        if kind == 1:
            odo.add_motion(t, seq.gyro[i], seq.accel[i])
        else:
            odo.add_frame(t, image_of(i))
            collect_latest(odo, est_t, est_p)
    if threaded:
        odo.join()  # drain both pipeline stages before measuring
    wall = time.perf_counter() - t0

    if not est_p:
        odo.close()
        print("never reached tracking")
        return 1
    est_p = np.asarray(est_p)
    gt_by_t = {round(tt, 6): p for tt, p in zip(seq.t_frame, seq.p_wb)}
    gt = np.stack([gt_by_t[round(tt, 6)] for tt in est_t])
    print(f"frames {len(seq.t_frame)}, tracked {len(est_p)}, wall {wall:.1f}s "
          f"({len(seq.t_frame)/wall:.2f} fps)")
    print(f"ATE (SE3-aligned RMSE): {ate_rmse(est_p, gt):.4f} m")
    print(f"landmarks: {len(odo.local_map())}")
    odo.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
