"""Run the PyTorch port on an ADVIO sequence and report the trajectory
(examples/run_advio.py runs the JAX package).

The equivalent of the reference's examples/test_advio runner
(dataset.hpp:633-821 ADVIO class + addAcc/addGyro streaming).

Usage: python examples/torch_run_advio.py <advio_root_or_seq_dir> [seq_id]
           [--setting <setting.yaml>] [--max-frames N] [--no-undistort]
           [--device cpu]

Accepts either the dataset root containing advio-XX/ or a sequence directory
itself. frames.mov is demuxed in-process when MJPEG; for H.264 sequences
extract once with `ffmpeg -i frames.mov -vsync 0 iphone/frames/%06d.png`.
Runs on the GPU unless --device cpu is given.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    valued = ("--setting", "--max-frames", "--device")
    args = [a for k, a in enumerate(argv)
            if not a.startswith("--") and (k == 0 or argv[k - 1] not in valued)]
    if not args:
        print(__doc__)
        return 2
    advio_dir = args[0]
    seq_id = int(args[1]) if len(args) > 1 else 1
    opt = lambda name: argv[argv.index(name) + 1] if name in argv else None  # noqa: E731
    setting = opt("--setting")
    max_frames = int(opt("--max-frames")) if "--max-frames" in argv else None
    device = opt("--device") or "cuda"

    from rd_vio_tpu_torch.datasets.advio import run_advio

    est_t, est_p, ds, odo = run_advio(
        advio_dir, seq_id=seq_id, setting_yaml=setting, max_frames=max_frames,
        undistort="--no-undistort" not in argv, device=device,
    )
    odo.close()
    print(f"frames {len(ds.frames['t'])}, tracked poses {len(est_p)}")
    if len(est_p):
        p = np.asarray(est_p)
        print(f"trajectory extent: {np.ptp(p, axis=0).round(3)} m")
    return 0


if __name__ == "__main__":
    sys.exit(main())
