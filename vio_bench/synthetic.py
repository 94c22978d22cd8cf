"""Frozen copy of the port's synthetic VIO sequence generator
(`rd_vio_tpu_torch/datasets/synthetic.generate`): an analytic smooth
trajectory sampled at the IMU rate (gyro and accel derived from the pose
spline) and at the camera rate (perfect-match keypoint observations of a
landmark cloud, some of it moving where `n_dynamic` says so).

The benchmark's inputs come from this copy, so that the yardstick does not
move when the program's generator does. One change from the original:
`noise_seed`, where given, draws the sensor noise (IMU and pixel) apart
from the scene, which `seed` alone then draws, so that a run can keep one
scene and change only the noise. Pure NumPy.
"""

from __future__ import annotations

import dataclasses

import numpy as np
from scipy.spatial.transform import Rotation

GRAVITY = np.array([0.0, 0.0, -9.80665])


@dataclasses.dataclass
class SyntheticSequence:
    # imu stream
    t_imu: np.ndarray  # (Ni,)
    gyro: np.ndarray  # (Ni, 3) body rates
    accel: np.ndarray  # (Ni, 3) specific force in body frame
    # camera stream
    t_frame: np.ndarray  # (Nf,)
    q_wb: np.ndarray  # (Nf, 4) wxyz ground-truth body-to-world
    p_wb: np.ndarray  # (Nf, 3)
    v_wb: np.ndarray  # (Nf, 3)
    # observations: fixed K slots per frame
    kp_pixel: np.ndarray  # (Nf, K, 2)
    kp_id: np.ndarray  # (Nf, K) landmark id or -1
    landmarks: np.ndarray  # (M, 3)
    K_mat: np.ndarray  # (3, 3)
    bg_true: np.ndarray
    ba_true: np.ndarray
    # ids of landmarks given non-zero world velocity (dynamic objects);
    # empty for static scenes — ground truth for dynamic-label metrics
    dynamic_ids: np.ndarray = None


def _pose_at(t, rng_phase, period=60.0, excitation=0.0):
    """Analytic trajectory: circle + vertical bob; the body/camera z-axis
    points radially outward (at the landmark ring), x tangent. Returns (q_wb
    wxyz, p_wb)."""
    t = np.atleast_1d(np.asarray(t, float))
    r, w = 3.0, 2.0 * np.pi / period
    p = np.stack(
        [
            r * np.cos(w * t),
            r * np.sin(w * t),
            1.2 + 0.3 * np.sin(2.1 * w * t + rng_phase),
        ],
        axis=-1,
    )
    if excitation:
        # higher-frequency translational wobble: visual-inertial scale is
        # only observable under acceleration (the near-constant-velocity
        # base circle has |a| ~ 0.03 m/s^2); real sequences (EuRoC) start
        # with a shake for exactly this reason
        p = p + excitation * np.stack(
            [np.sin(5.0 * t), np.sin(6.3 * t + 0.7), np.cos(4.1 * t)],
            axis=-1,
        )
    c, s = np.cos(w * t), np.sin(w * t)
    zero = np.zeros_like(t)
    one = np.ones_like(t)
    x_b = np.stack([-s, c, zero], axis=-1)  # tangent
    z_b = np.stack([c, s, zero], axis=-1)  # radial outward (view direction)
    y_b = np.stack([zero, zero, one], axis=-1)  # z_b x x_b
    R_base = np.stack([x_b, y_b, z_b], axis=-1)  # columns are body axes
    # small smooth attitude perturbation for excitation on all axes
    pert = np.stack(
        [
            0.08 * np.sin(1.3 * w * t),
            0.06 * np.cos(1.7 * w * t),
            0.05 * np.sin(0.9 * w * t + 1.0),
        ],
        axis=-1,
    )
    R = np.einsum("nij,njk->nik", R_base, Rotation.from_rotvec(pert).as_matrix())
    q = Rotation.from_matrix(R).as_quat()  # xyzw
    q = np.concatenate([q[..., 3:4], q[..., :3]], axis=-1)
    return q, p


def _quat_to_R(q_wxyz):
    q = np.asarray(q_wxyz)
    return Rotation.from_quat(np.concatenate([q[..., 1:], q[..., :1]], axis=-1)).as_matrix()


def generate(
    duration: float = 20.0,
    period: float = 60.0,
    imu_rate: float = 200.0,
    cam_rate: float = 20.0,
    n_landmarks: int = 600,
    max_keypoints: int = 150,
    pixel_noise: float = 0.0,
    gyro_noise: float = 0.0,
    accel_noise: float = 0.0,
    bg=np.zeros(3),
    ba=np.zeros(3),
    K_mat=None,
    image_size=(752, 480),
    seed: int = 648,
    noise_seed: int = None,
    excitation: float = 0.0,
    n_dynamic: int = 0,
    dynamic_velocity: float = 0.5,
    dynamic_mode: str = "random",  # "random" per-point | "rigid" shared motion
) -> SyntheticSequence:
    rng = np.random.default_rng(seed)
    # the sensor noise: from the scene's generator, or apart from it
    nrng = rng if noise_seed is None else np.random.default_rng(noise_seed)
    phase = 0.0
    if K_mat is None:
        K_mat = np.array([[458.654, 0, 367.215], [0, 457.296, 248.375], [0, 0, 1.0]])
    W_img, H_img = image_size

    # --- IMU stream from numeric differentiation of the analytic pose ---
    t_imu = np.arange(0.0, duration, 1.0 / imu_rate)
    h = 1e-4
    q0, p0 = _pose_at(t_imu, phase, period, excitation)
    _, p_plus = _pose_at(t_imu + h, phase, period, excitation)
    _, p_minus = _pose_at(t_imu - h, phase, period, excitation)
    v = (p_plus - p_minus) / (2 * h)
    a_world = (p_plus - 2 * p0 + p_minus) / (h * h)
    R0 = _quat_to_R(q0)
    qp, _ = _pose_at(t_imu + h, phase, period, excitation)
    # body rates: logmap(q(t)^-1 q(t+h)) / h
    R_rel = np.einsum("nij,nik->njk", R0, _quat_to_R(qp))  # R0^T R(t+h)
    w_body = Rotation.from_matrix(R_rel).as_rotvec() / h
    a_body = np.einsum("nij,ni->nj", R0, a_world - GRAVITY)  # R^T (a - g)
    gyro = w_body + bg + gyro_noise * nrng.standard_normal(w_body.shape)
    accel = a_body + ba + accel_noise * nrng.standard_normal(a_body.shape)

    # --- landmark cloud: ring around the trajectory + some above/below ---
    ang = rng.uniform(0, 2 * np.pi, n_landmarks)
    rad = rng.uniform(5.0, 9.0, n_landmarks)
    lm = np.stack(
        [rad * np.cos(ang), rad * np.sin(ang), rng.uniform(-1.0, 3.5, n_landmarks)],
        axis=-1,
    )

    # --- camera frames ---
    t_frame = np.arange(0.0, duration, 1.0 / cam_rate)
    q_wb, p_wb = _pose_at(t_frame, phase, period, excitation)
    _, pf_plus = _pose_at(t_frame + h, phase, period, excitation)
    _, pf_minus = _pose_at(t_frame - h, phase, period, excitation)
    v_wb = (pf_plus - pf_minus) / (2 * h)
    R_wb = _quat_to_R(q_wb)

    Nf = len(t_frame)
    kp_pixel = np.zeros((Nf, max_keypoints, 2))
    kp_id = np.full((Nf, max_keypoints), -1, dtype=np.int64)
    fx, fy, cx, cy = K_mat[0, 0], K_mat[1, 1], K_mat[0, 2], K_mat[1, 2]

    if n_dynamic and dynamic_mode == "rigid":
        # a rigid cluster (e.g. a vehicle): spatially adjacent landmarks share
        # one velocity — tracks stay coherent and triangulable, the scenario
        # IMU-PARSAC is built for
        order = np.argsort(ang)
        dyn_ids = order[:n_dynamic]
        v_dir = rng.standard_normal(3)
        v_dir[2] *= 0.2
        v_dir /= np.linalg.norm(v_dir)
        dyn_vel = np.tile(dynamic_velocity * v_dir, (n_dynamic, 1))
    else:
        dyn_ids = rng.choice(n_landmarks, size=n_dynamic, replace=False) if n_dynamic else np.array([], int)
        dyn_vel = dynamic_velocity * rng.standard_normal((n_dynamic, 3))

    for f in range(Nf):
        lm_f = lm.copy()
        if n_dynamic:
            lm_f[dyn_ids] += dyn_vel * t_frame[f]
        x_cam = (lm_f - p_wb[f]) @ R_wb[f]  # R^T (x - p), camera == body here
        vis = x_cam[:, 2] > 0.3
        u = fx * x_cam[:, 0] / np.maximum(x_cam[:, 2], 1e-9) + cx
        v_pix = fy * x_cam[:, 1] / np.maximum(x_cam[:, 2], 1e-9) + cy
        vis &= (u > 10) & (u < W_img - 10) & (v_pix > 10) & (v_pix < H_img - 10)
        ids = np.flatnonzero(vis)
        # deterministic subset: prefer lowest ids for track continuity
        ids = ids[:max_keypoints]
        n = len(ids)
        kp_id[f, :n] = ids
        kp_pixel[f, :n, 0] = u[ids] + pixel_noise * nrng.standard_normal(n)
        kp_pixel[f, :n, 1] = v_pix[ids] + pixel_noise * nrng.standard_normal(n)

    return SyntheticSequence(
        t_imu=t_imu, gyro=gyro, accel=accel,
        t_frame=t_frame, q_wb=q_wb, p_wb=p_wb, v_wb=v_wb,
        kp_pixel=kp_pixel, kp_id=kp_id, landmarks=lm, K_mat=K_mat,
        bg_true=np.asarray(bg, float), ba_true=np.asarray(ba, float),
        dynamic_ids=np.asarray(dyn_ids, np.int64),
    )
