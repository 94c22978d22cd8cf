"""Port parity of the bicubic intensity evaluation (ops/image/intensity):
`evaluate_bicubic` on tests/test_intensity.py's 60x80 image, with query
points inside and past the borders (the clamping), and `evaluate_pyramid`
at every level of a 4-level pyramid. Both packages get the same f32 image
and pyramid (the JAX package's pyramid, so that only the evaluation is
compared). Values and gradients within 1e-4 (f32; intensities 0-255)."""

import numpy as np

from tests.test_torch_image import IN_CHILD, child  # noqa: F401

if IN_CHILD:  # the port loads only where the checks run (test_torch_image)
    import jax.numpy as jnp
    import torch

    from rd_vio_tpu.ops.image import intensity as int_j
    from rd_vio_tpu.ops.image import pyramid as pyr_j
    from rd_vio_tpu_torch.ops.image import intensity as int_t

TOL = 1e-4


def _img(rng, H=60, W=80):
    """tests/test_intensity.py's image: smoothed noise scaled to 0-255."""
    from scipy.ndimage import gaussian_filter

    img = gaussian_filter(rng.standard_normal((H, W)), 2.0)
    return ((img - img.min()) / np.ptp(img) * 255.0).astype(np.float32)


def _close(port, ref, what):
    port, ref = port.numpy(), np.asarray(ref)
    assert port.dtype == np.float32 and port.shape == ref.shape, (what, port.dtype,
                                                                 port.shape, ref.shape)
    err = float(np.abs(port - ref).max())
    assert err <= TOL, f"{what}: max |diff| {err:.3e} > {TOL}"


def _check_intensity():
    rng = np.random.default_rng(648)
    img = _img(rng)
    # inside, on integer coordinates, and past every border
    pts = np.concatenate([
        np.stack([rng.uniform(1, 78, 200), rng.uniform(1, 58, 200)], -1),
        np.stack([rng.integers(2, 77, 20), rng.integers(2, 57, 20)], -1).astype(float),
        np.array([[-3.0, 10.0], [85.0, 30.0], [40.0, -2.5], [20.0, 70.0], [0.2, 0.4],
                  [79.9, 59.9]]),
    ])
    vj, gj = int_j.evaluate_bicubic(jnp.asarray(img), jnp.asarray(pts))
    vt, gt = int_t.evaluate_bicubic(torch.from_numpy(img), torch.from_numpy(pts))
    _close(vt, vj, "evaluate_bicubic value")
    _close(gt, gj, "evaluate_bicubic gradient")
    # an integer image is evaluated in f32, as the JAX package casts it
    vu, _ = int_t.evaluate_bicubic(torch.from_numpy(img.astype(np.uint8)),
                                   torch.from_numpy(pts))
    vju, _ = int_j.evaluate_bicubic(jnp.asarray(img.astype(np.uint8)), jnp.asarray(pts))
    _close(vu, vju, "evaluate_bicubic value, uint8 image")

    big = _img(rng, H=96, W=128)
    pyr = [np.asarray(a) for a in pyr_j.build_pyramid(jnp.asarray(big), 3)]
    q = np.stack([rng.uniform(-4, 132, 150), rng.uniform(-4, 100, 150)], -1)
    for level in range(len(pyr)):
        vj, gj = int_j.evaluate_pyramid([jnp.asarray(a) for a in pyr], q, level)
        vt, gt = int_t.evaluate_pyramid([torch.from_numpy(a) for a in pyr], q, level)
        _close(vt, vj, f"evaluate_pyramid value, level {level}")
        _close(gt, gj, f"evaluate_pyramid gradient, level {level}")


def test_intensity_matches_jax(child):
    child(_check_intensity)
