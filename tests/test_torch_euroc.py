"""Port parity of the EuRoC path as a whole: the port's
`datasets.euroc.run_euroc` on the CPU against the JAX package's, over the
same tiny distorted layout.

The layout is bench's synthetic sequence of tests/test_euroc_layout.py,
rendered at 320x240 and distorted with small radtan coefficients
(scripts/euroc_layout.py, the JAX package's camera model, in the test
process), with `camera_distortion_flag: 1`, so both runs read the YAML
files, decode PNGs, undistort every frame and track it. The setting.yaml
holds tests/test_euroc_layout.py's light tracker settings, a short
initializer (4 keyframes, 2 frames apart) and 5 LM iterations per solve, so
that the JAX run tracks from frame 12 and the test stays inside its time
budget. The JAX run happens in the `jax_side` process, which keeps the
persistent compilation cache (without it the JAX run took 114 s instead of
~50 s), and the port's in the module's child (tests/test_torch_image.py),
at once.
"""

import numpy as np

from tests.test_torch_image import child, jax_ref, jax_side  # noqa: F401

SETTINGS = {
    "feature_tracker": {"min_keypoint_distance": 12.0, "max_keypoint_detection": 120},
    "initializer": {"keyframe_num": 4, "keyframe_gap": 2},
    "solver": {"iteration_limit": 5},
}
DIST = (-0.05, 0.01, 0.001, -0.0005)
# the least max_frames at which the JAX run has collected 5 tracked
# estimates (4 at 16 frames)
N_FRAMES = 17
MIN_ESTIMATES = 5


def write_layout(root):
    """The layout, written with the JAX package's camera model (x64, eager
    operations)."""
    import jax.numpy as jnp

    from rd_vio_tpu.datasets import synthetic
    from rd_vio_tpu.datasets.renderer import SequenceRenderer
    from rd_vio_tpu.ops import camera
    from scripts.euroc_layout import write_layout as write

    seq = synthetic.generate(duration=5.0, n_landmarks=1500, max_keypoints=150)
    rend = SequenceRenderer(seq, image_size=(320, 240))
    K, dist = jnp.asarray(rend.K), jnp.asarray(DIST)
    return write(root, seq, [rend.render(k) for k in range(N_FRAMES)], rend.K, DIST,
                 lambda p: np.asarray(camera.undistort_points_pixel(jnp.asarray(p), K, dist)),
                 settings=SETTINGS)


def _result(est_t, est_p, ds, first, ate_rmse, associate):
    ie, ig = associate(np.asarray(est_t), ds.ground_truth["t"])
    return {"est_t": np.asarray(est_t), "est_p": np.asarray(est_p),
            "ate": float(ate_rmse(np.asarray(est_p)[ie], ds.ground_truth["p"][ig])),
            "associated": len(ie), "first_frame": first,
            "distortion_flag": ds.undistort is not None}


def run_jax(paths):
    from rd_vio_tpu.datasets import euroc
    from rd_vio_tpu.utils.trajectory import associate, ate_rmse

    est_t, est_p, ds, _ = euroc.run_euroc(*paths, max_frames=N_FRAMES)
    first = ds.load_image(ds.frames["files"][0])
    return _result(est_t, est_p, ds, first, ate_rmse, associate)


def run_port(paths):
    from rd_vio_tpu_torch.datasets import euroc
    from rd_vio_tpu_torch.ops.image import klt
    from rd_vio_tpu_torch.utils.trajectory import associate, ate_rmse

    klt.fwd_rev_launches = klt.launches = 0
    est_t, est_p, ds, odo = euroc.run_euroc(*paths, max_frames=N_FRAMES, device="cpu")
    assert odo.device.type == "cpu" and ds.undistort.map_y.device.type == "cpu"
    assert odo.state() == 1
    first = ds.load_image(ds.frames["files"][0])
    out = _result(est_t, est_p, ds, first, ate_rmse, associate)
    out["lk_launches"] = klt.fwd_rev_launches + klt.launches  # none on the CPU
    return out


def _layout_files(root):
    """Every file of the layout under `root`, by its path there: bytes."""
    import os

    out = {}
    for d, _, files in os.walk(root):
        for name in files:
            path = os.path.join(d, name)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = fh.read()
    return out


def test_euroc_slice_matches_jax(child, jax_side, tmp_path):
    """The same frames reach preprocess (the first undistorted frame equal
    bit for bit); both runs collect estimates at the same frame times, >= 5;
    every estimate is finite; the port's ATE (SE3-aligned, `associate`
    against the layout's ground truth) within max(2 J, J + 0.01 m) of the
    JAX run's J."""
    child(int, 0)  # the child starts before jax_side sets its environment
    paths = write_layout(str(tmp_path))
    result = jax_ref(jax_side, "euroc", (_layout_files(str(tmp_path)), N_FRAMES), run_jax,
                     paths)
    port = child(run_port, paths)
    jax = result()
    assert port["distortion_flag"] and jax["distortion_flag"]
    assert port["first_frame"].dtype == np.float32
    np.testing.assert_array_equal(port["first_frame"], jax["first_frame"])
    assert len(jax["est_t"]) >= MIN_ESTIMATES
    np.testing.assert_array_equal(port["est_t"], jax["est_t"])
    assert port["associated"] == jax["associated"] == len(jax["est_t"])
    assert np.isfinite(port["est_p"]).all()
    assert port["lk_launches"] == 0
    bound = max(2 * jax["ate"], jax["ate"] + 0.01)
    assert port["ate"] <= bound, (port["ate"], jax["ate"], bound)
