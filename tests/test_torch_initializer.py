"""Port parity of the bootstrap: `ops/homography`, `epipolar.decompose_essential`,
`ransac.ransac_homography` and `models/initializer.Initializer`.

The ops take seeded NumPy inputs; `ransac_homography` in the port is handed
the Gumbel noise `jax.random.gumbel` drew from the key the JAX call used.
For the Initializer, the JAX package's FeatureTracker (host-mask path,
perfect-match synthetic backend, no estimator behind it) runs in a spawned
process that keeps the persistent compilation cache (`jax_side`,
tests/test_torch_image.py), with a JAX Initializer tried after every frame
as the Frontend tries it, until one succeeds; the child runs the port's
FeatureTracker and Initializer over the same sequence, the port's RANSACs
fed the noise of the JAX Initializer's key chain (one split of its key per
RANSAC, as Initializer._next_key draws).
"""

import numpy as np
import jax
import jax.numpy as jnp

from rd_vio_tpu.config import Config as ConfigJ
from rd_vio_tpu.datasets import synthetic as synth_j
from rd_vio_tpu.models import builders as builders_j
from rd_vio_tpu.models.feature_tracker import FeatureTracker as FeatureTrackerJ
from rd_vio_tpu.models.feature_tracker import SyntheticBackend as SyntheticBackendJ
from rd_vio_tpu.models.handler import Handler as HandlerJ
from rd_vio_tpu.models.initializer import Initializer as InitializerJ
from rd_vio_tpu.ops import epipolar as epi_j
from rd_vio_tpu.ops import homography as homo_j
from rd_vio_tpu.ops import ransac as ransac_j
from tests.test_torch_image import IN_CHILD, child, child2, jax_ref, jax_side  # noqa: F401

if IN_CHILD:  # the port loads only where the checks run (test_torch_image)
    import torch

    from rd_vio_tpu_torch import convert
    from rd_vio_tpu_torch.models import builders as builders_t
    from rd_vio_tpu_torch.models.feature_tracker import FeatureTracker as FeatureTrackerT
    from rd_vio_tpu_torch.models.feature_tracker import SyntheticBackend as SyntheticBackendT
    from rd_vio_tpu_torch.models.handler import Handler as HandlerT
    from rd_vio_tpu_torch.models.initializer import Initializer as InitializerT
    from rd_vio_tpu_torch.ops import epipolar as epi_t
    from rd_vio_tpu_torch.ops import homography as homo_t
    from rd_vio_tpu_torch.ops import ransac as ransac_t

CAPS = dict(W=13, L=256, O=1536, Fi=16, R=128, IMU=64, IMU_KF=384)
DURATION_S = 2.2
N = 96
K_HYP = 128


class JaxKeyNoise:
    """The Gumbel noise of a JAX key chain: one split per draw, as the JAX
    Initializer's _next_key draws a key per RANSAC."""

    def __init__(self, seed):
        self.key = jax.random.PRNGKey(seed)

    def __call__(self, k, n):
        self.key, sub = jax.random.split(self.key)
        return np.array(jax.random.gumbel(sub, (k, n), jnp.float32))


def _plane_scene(seed):
    """Normalized image points of N points on a plane seen from two poses,
    a fifth of them mismatched, some slots invalid (f64)."""
    rng = np.random.default_rng(seed)
    X = np.stack([rng.uniform(-2, 2, N), rng.uniform(-1.5, 1.5, N), np.zeros(N)], -1)
    X = X + np.array([0.0, 0.0, 5.0]) + X[:, :1] * np.array([0.0, 0.0, 0.3])
    from scipy.spatial.transform import Rotation

    R = Rotation.from_rotvec([0.02, 0.08, -0.01]).as_matrix()
    X2 = X @ R.T + np.array([0.4, 0.05, 0.1])
    p1 = X[:, :2] / X[:, 2:]
    p2 = X2[:, :2] / X2[:, 2:] + rng.normal(0, 1e-4, (N, 2))
    bad = rng.uniform(size=N) < 0.2
    p2[bad] += rng.normal(0, 0.05, (bad.sum(), 2))
    valid = rng.uniform(size=N) > 0.1
    return p1, p2, valid


def _check_ops():
    """homography DLT / error / decomposition within 1e-9 (f64), the
    essential decomposition as the same four (R, T) candidates within 1e-9,
    ransac_homography on the same noise: the same inliers, H within 1e-8."""
    p1, p2, valid = _plane_scene(5)
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    sel = np.flatnonzero(valid & (np.arange(N) < 40))

    H_j = np.asarray(homo_j.solve_homography_dlt(jnp.asarray(p1[sel]), jnp.asarray(p2[sel])))
    H_t = homo_t.solve_homography_dlt(t(p1[sel]), t(p2[sel])).numpy()
    np.testing.assert_allclose(H_t, H_j, rtol=0, atol=1e-9)
    e_j = np.asarray(homo_j.homography_geometric_error(jnp.asarray(H_j), jnp.asarray(p1),
                                                       jnp.asarray(p2)))
    e_t = homo_t.homography_geometric_error(t(H_j), t(p1), t(p2)).numpy()
    np.testing.assert_allclose(e_t, e_j, rtol=1e-9, atol=1e-15)
    for H in (H_j, np.diag([1.0, 1.0, 1.0]) + 1e-5):  # general, then pure rotation
        out_j = [np.asarray(x) for x in homo_j.decompose_homography(jnp.asarray(H))]
        out_t = [x.numpy() for x in homo_t.decompose_homography(t(H))]
        for a, b in zip(out_j, out_t):
            np.testing.assert_allclose(b, a, rtol=0, atol=1e-9)

    key = jax.random.PRNGKey(11)
    g = np.array(jax.random.gumbel(key, (K_HYP, N), jnp.float32))
    thr = 0.7 / 460.0
    res_j = ransac_j.ransac_homography(key, jnp.asarray(p1), jnp.asarray(p2),
                                       jnp.asarray(valid), thr, K_HYP)
    res_t = ransac_t.ransac_homography(t(g), t(p1), t(p2), t(valid), thr)
    np.testing.assert_array_equal(res_t.inlier_mask.numpy(), np.asarray(res_j.inlier_mask))
    np.testing.assert_allclose(res_t.model.numpy(), np.asarray(res_j.model), rtol=0, atol=1e-8)

    # essential decomposition: the SVD's signs are free, so compare the sets
    # of candidate poses {(R1, +-T), (R2, +-T)}
    from scipy.spatial.transform import Rotation

    R = Rotation.from_rotvec([0.05, -0.1, 0.02]).as_matrix()
    T = np.array([0.3, -0.1, 0.9])
    E = np.array([[0, -T[2], T[1]], [T[2], 0, -T[0]], [-T[1], T[0], 0]]) @ R
    R1j, R2j, Tj = (np.asarray(x) for x in epi_j.decompose_essential(jnp.asarray(E)))
    R1t, R2t, Tt = (x.numpy() for x in epi_t.decompose_essential(t(E)))

    def cands(R1, R2, T):
        return [np.concatenate([Rr.ravel(), s * T]) for Rr in (R1, R2) for s in (1, -1)]

    cj, ct = cands(R1j, R2j, Tj), cands(R1t, R2t, Tt)
    for c in cj:
        assert min(np.abs(c - d).max() for d in ct) <= 1e-9


class InitProbe:
    """Stands where the Frontend sits behind the feature tracker: tries to
    initialize on every issued frame, as Frontend does, until one succeeds."""

    initializing = True
    latest_optimized = None

    def __init__(self, ft, init):
        self.ft, self.init = ft, init
        self.frames, self.done = 0, None

    def issue_frame(self, frame):
        self.frames += 1
        if self.done is None:
            self.init.mirror_keyframe_map(self.ft.map, frame.id)
            m = self.init.initialize()
            if m is not None:
                self.done = (self.frames, m)


def _track_and_init(ft, handler, init, seq):
    """Feed frames + IMU in event order to the tracker, the probe behind it.
    Returns (the count of issued frames at the first success, its map)."""
    probe = InitProbe(ft, init)
    ft.frontend = probe
    events = sorted([(t, 1, i) for i, t in enumerate(seq.t_imu)]
                    + [(t, 0, i) for i, t in enumerate(seq.t_frame)])
    for t, kind, i in events:
        if probe.done is not None:
            break
        if kind == 1:
            handler.track_motion(t, seq.gyro[i], seq.accel[i])
        else:
            handler.track_camera(t, i)
    return probe.done or (None, None)


def _init_summary(i, m):
    return dict(frame=i, q=np.stack([f.q for f in m.frames]),
                p=np.stack([f.p for f in m.frames]), v=np.stack([f.v for f in m.frames]),
                bg=np.stack([f.bg for f in m.frames]),
                tracks=sum(1 for t in m.tracks.values() if t.tag("valid")))


def _jax_init():
    seq = synth_j.generate(duration=DURATION_S, n_landmarks=1200, max_keypoints=150, seed=648)
    cfg = ConfigJ()
    cfg.camera_intrinsic = seq.K_mat
    cfg.ransac_hypotheses = 128
    caps = builders_j.Caps(**CAPS)
    calib = builders_j.CalibArrays.from_config(cfg)
    ft = FeatureTrackerJ(cfg, calib, caps, SyntheticBackendJ(seq))
    i, m = _track_and_init(ft, HandlerJ(cfg, ft, None), InitializerJ(cfg, calib, caps), seq)
    assert i is not None, "the JAX initializer never succeeded"
    return cfg, _init_summary(i, m)


def _check_initializer(cfg_j, want):
    """The same frame of success; after the init's final f64 VI-BA (whose
    middle-frame solves run in f32), rotations within 1e-5, positions and
    velocities within 1e-5 m (m/s), gyro bias within 1e-6, and the same
    count of valid tracks within 1."""
    seq = synth_j.generate(duration=DURATION_S, n_landmarks=1200, max_keypoints=150, seed=648)
    cfg = convert.config_from(cfg_j)
    caps = builders_t.Caps(**CAPS)
    calib = builders_t.CalibArrays.from_config(cfg, device="cpu")
    ft = FeatureTrackerT(cfg, calib, caps, SyntheticBackendT(seq), device="cpu")
    i, m = _track_and_init(ft, HandlerT(cfg, ft, None),
                           InitializerT(cfg, calib, caps, noise=JaxKeyNoise(cfg.random)), seq)
    assert i == want["frame"], (i, want["frame"])
    got = _init_summary(i, m)
    for k in ("q", "p", "v"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5, err_msg=k)
    np.testing.assert_allclose(got["bg"], want["bg"], rtol=0, atol=1e-6)
    assert abs(got["tracks"] - want["tracks"]) <= 1


def test_initializer_matches_jax(child, child2, jax_side):
    seq = synth_j.generate(duration=DURATION_S, n_landmarks=1200, max_keypoints=150, seed=648)
    cfg = ConfigJ()
    cfg.camera_intrinsic = seq.K_mat
    cfg.ransac_hypotheses = 128
    result = jax_ref(jax_side, "initializer", (seq, cfg, CAPS), _jax_init)
    ops = child2.submit(_check_ops)  # the op checks run at once, in a second process
    cfg, want = result()
    child(_check_initializer, cfg, want)
    ops()
