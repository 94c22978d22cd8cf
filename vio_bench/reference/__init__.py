"""The plain reference that decides `correct`: plain PyTorch and NumPy,
importing nothing of the program (`rd_vio_tpu_torch`) and nothing of JAX.

- `solve`: the sliding-window visual-inertial bundle adjustment written
  out from its equations, solved by a dense Levenberg-Marquardt in float64;
- `marg`: the marginalization of the window's oldest frame, the Schur
  complement of the linearized factors;
- `preint`: IMU preintegration between two frame times from the raw
  samples, with its bias Jacobians and covariance.
"""
