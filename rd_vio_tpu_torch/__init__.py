"""rd_vio_tpu_torch — the RD-VIO engine in PyTorch, for NVIDIA GPUs.

The port of the JAX package `rd_vio_tpu`, module by module under the same
paths and names. It imports `torch` and never `jax` or `rd_vio_tpu`; the
parity tests are the only code that imports both.

What runs so far: the main path of the real-pixel pipeline, synchronous,
through `models.odometry.Odometry` (`Handler` -> `FeatureTracker` ->
`Frontend` -> `Initializer`, then the `SlidingWindowTracker` and the
estimator programs of `models.builders`), made of:
- the feature-tracking stage:
  `models.handler.Handler` -> `models.feature_tracker.FeatureTracker` ->
  `models.image_backend.TorchImageBackend` -> `ops.frontend_loop.ft_loop_step`.
  Its hand-written kernels are in `csrc/lk_track.cu`: the pyramidal
  Lucas-Kanade track of a frame pair fused into one launch (all levels,
  forward and reverse, the status rules; wrapped by
  `ops.image.klt.lk_track_fwd_rev`, which the tracking stage calls) and one
  level of it (`ops.image.klt.lk_level`), both over one implementation of
  the maths;
- the estimator core: `ops.lie`, `ops.preintegration`, `ops.triangulate`,
  `estimation.state`, `estimation.factors`, the window VI-BA solve
  `estimation.ba.solve_ba` and `estimation.marginalization.marginalize_frame0`,
  in plain PyTorch (XLA in the JAX package), with window problems from
  `datasets.synthetic_problems`;
- the estimator's host side, copied NumPy: the assembly of the solves
  (`models.builders`), the keyframe state machine and the PARSAC judge
  (`models.sliding_window_tracker`, `ops.parsac_np`).

Entry points compute on the GPU unless the caller names another device.
"""

__version__ = "0.1.0"

import torch as _torch

# TF32 off for every f32 matmul and convolution of the port: the f32 window
# solves lose ~3 digits in TF32, and the JAX package's f32 is IEEE.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

from rd_vio_tpu_torch.config import Config, load_config  # noqa: E402,F401
