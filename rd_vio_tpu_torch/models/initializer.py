"""Bootstrap initialization: SfM from an 8-keyframe map + linear IMU init.

Behavioral reference: initializer.cpp — mirror_keyframe_map (20-74),
init_sfm (139-365: homography + essential hypothesis bank, two-view
triangulation scoring, middle-frame PnP solves, visual BA, pruning),
init_imu (367-499: gyro-bias Gauss-Newton, linear gravity/scale/velocity LS,
S2-tangent gravity refinement), apply_init (517-553), then full VI-BA and
handoff to the sliding-window tracker.

Port of the JAX package's models/initializer.py: the RANSAC hypothesis
banks, the 8-way triangulation scoring and every BA solve run on the
calibration's device; the tiny linear systems (3x3 gyro bias, the
(N-1)*6 x (3N+4) gravity LS) and, with `initializer_use_5pt`, the 5-point
essential RANSAC (ops/essential5.py) run in host NumPy. The device RANSACs
take their Gumbel noise from `noise` (a callable (K, N) -> (K, N) f32
tensor; by default a seeded generator on the device), where the JAX package
draws it from its PRNG key chain; the 5-point RANSAC draws from host seeds
(config.random, n), as the port's other NumPy RANSACs do.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch
from torch.func import vmap

from rd_vio_tpu_torch.estimation import ba
from rd_vio_tpu_torch.models import builders
from rd_vio_tpu_torch.models.map import (
    FT_FIX_POSE, FT_KEYFRAME, Frame, Map, TT_TRIANGULATED, TT_VALID,
)
from rd_vio_tpu_torch.models.quat_np import (
    R_to_q, q_from_two_vectors, qconj, qmul, qrot,
)
from rd_vio_tpu_torch.ops import epipolar, homography, ransac
from rd_vio_tpu_torch.ops.essential5 import ransac_essential_5pt
from rd_vio_tpu_torch.ops.lie import matrix_to_quat, s2_tangential_basis
from rd_vio_tpu_torch.ops.triangulate import triangulate_two_view
from rd_vio_tpu_torch.utils.host import asnp, fetch, to_device

GRAVITY_NOMINAL = 9.80665


def _hypothesis_triangulation(Rs, Ts, p1, p2, valid):
    """Triangulate all matches under each (R, T) hypothesis and score
    (reference initializer.cpp:206-263). Returns (points (H,N,3),
    status (H,N), counts (H,), scores (H,))."""

    def homog_bearing(p):
        v = torch.cat([p, torch.ones_like(p[..., :1])], dim=-1)
        return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)

    b1 = homog_bearing(p1)
    b2 = homog_bearing(p2)
    q_id = torch.tensor([1.0, 0, 0, 0], dtype=p1.dtype).to(p1.device)
    p_id = torch.zeros(3, dtype=p1.dtype, device=p1.device)

    def per_hyp(R, T):
        q2 = matrix_to_quat(R)
        pts, ok = triangulate_two_view(b1, b2, q_id, p_id, q2, T)
        z1 = pts[..., 2]
        x2 = torch.einsum("ij,nj->ni", R, pts) + T
        z2 = x2[..., 2]
        good = ok & (z1 > 0) & (z2 > 0) & (z1 < 100) & (z2 < 100) & valid
        e1 = ((pts[..., :2] / pts[..., 2:3] - p1) ** 2).sum(dim=-1)
        e2 = ((x2[..., :2] / x2[..., 2:3] - p2) ** 2).sum(dim=-1)
        score = torch.where(good, 0.5 * (e1 + e2), 0.0).sum()
        return pts, good, good.sum(), score

    return vmap(per_hyp)(Rs, Ts)


class Initializer:
    def __init__(self, config, calib: builders.CalibArrays, caps: builders.Caps,
                 noise: Optional[Callable[[int, int], torch.Tensor]] = None):
        """noise: callable (K, N) -> (K, N) Gumbel noise of one RANSAC's
        hypotheses (default: a GumbelSource seeded with config.random on
        the calibration's device)."""
        self.config = config
        self.calib = calib
        self.caps = caps
        self.device = torch.device(calib.device)
        # same small-solve profile as the tracker
        self.caps_fast = dataclasses.replace(
            caps, W=config.sliding_window_subframe_size + 6,
            O=256, L=64, P=768, Fi=12, Fp=2, R=caps.R,
        )
        self._fast_dtype = np.dtype(config.fast_solver_dtype)
        self.map: Optional[Map] = None
        if noise is None:
            src = ransac.GumbelSource(config.random, self.device)
            noise = lambda k, n: src.draw((k, n))  # noqa: E731
        self._noise = noise
        self._host_seed_ctr = 0
        # imu-init scratch
        self.bg = np.zeros(3)
        self.ba = np.zeros(3)
        self.gravity = np.zeros(3)
        self.scale = 1.0
        self.velocities = None
        self._deltas = None

    def _next_seed(self) -> tuple:
        """Host seed material of the n-th 5-point RANSAC: (config.random, n)."""
        self._host_seed_ctr += 1
        return (self.config.random, self._host_seed_ctr)

    def _gumbel(self, k: int, n: int) -> torch.Tensor:
        g = self._noise(k, n)
        if isinstance(g, torch.Tensor):
            return g.to(self.device)
        return to_device(np.asarray(g, np.float32), self.device)

    # ------------------------------------------------------------------
    def mirror_keyframe_map(self, ft_map: Map, init_frame_id: int) -> None:
        """Pick keyframe_num frames spaced keyframe_gap apart ending at
        init_frame_id; clone + relink + concatenate IMU
        (reference initializer.cpp:20-74)."""
        cfg = self.config
        idx_last = ft_map.frame_index_by_id(init_frame_id)
        gap = cfg.initializer_keyframe_gap
        dist = gap * (cfg.initializer_keyframe_num - 1)
        if idx_last is None or idx_last < dist:
            self.map = None
            return
        indices = [idx_last - dist + i * gap for i in range(cfg.initializer_keyframe_num)]

        m = Map()
        for i in indices:
            m.attach_frame(ft_map.get_frame(i).clone())
        for j in range(1, m.frame_num):
            old_i = ft_map.get_frame(indices[j - 1])
            old_j = ft_map.get_frame(indices[j])
            new_i = m.get_frame(j - 1)
            new_j = m.get_frame(j)
            for ki in range(old_i.keypoint_num):
                tr = ft_map.get_track(old_i, ki)
                if tr is None:
                    continue
                kj = tr.obs.get(old_j.id)
                if kj is None:
                    continue
                ntr = m.get_track(new_i, ki, create=True)
                m.add_keypoint(ntr, new_j, kj)
            # concatenated IMU over the gap
            dts, ws, accs = [], [], []
            for f in range(indices[j - 1], indices[j]):
                fr = ft_map.get_frame(f + 1)
                dts.append(fr.imu_dt)
                ws.append(fr.imu_w)
                accs.append(fr.imu_a)
            new_j.imu_dt = np.concatenate(dts) if dts else np.zeros(0)
            new_j.imu_w = np.concatenate(ws) if ws else np.zeros((0, 3))
            new_j.imu_a = np.concatenate(accs) if accs else np.zeros((0, 3))
        self.map = m

    # ------------------------------------------------------------------
    def initialize(self):
        """Returns a ready Map (keyframes tagged, states initialized) or None
        (reference initializer.cpp:76-137)."""
        if self.map is None:
            return None
        if not self.init_sfm():
            return None
        if not self.init_imu():
            return None

        m = self.map
        # full VI-BA over the init window
        m.get_frame(0).set_tag(FT_FIX_POSE, True)
        frames = m.frames
        fid_list = [fr.id for fr in frames]
        tracks = [t for t in m.tracks.values() if t.tag(TT_VALID)]
        reproj = []
        for f in frames:
            for k in range(f.keypoint_num):
                t = m.get_track(f, k)
                if t is None or not t.all_tagged(TT_VALID, TT_TRIANGULATED):
                    continue
                if t.first_frame_id() == f.id or t.first_frame_id() not in fid_list:
                    continue
                reproj.append((f, frames[fid_list.index(t.first_frame_id())], t, False))
        imu = []
        for j in range(1, m.frame_num):
            fi, fj = frames[j - 1], frames[j]
            imu.append((fi, fj, (fj.imu_dt, fj.imu_w, fj.imu_a), fi.bg.copy(), fi.ba.copy(), False))
        spec = builders.BASpec(
            frames=frames,
            fix_pose=[f.tag(FT_FIX_POSE) for f in frames],
            fix_motion=[False] * len(frames),
            opt_tracks=[t for t in tracks if t.tag(TT_TRIANGULATED)],
            reproj=reproj, imu=imu, rot=[],
        )
        self._solve(spec, self.caps, None)
        m.get_frame(0).set_tag(FT_FIX_POSE, False)

        for f in m.frames:
            f.set_tag(FT_KEYFRAME, True)
        return m

    def _solve(self, spec, caps, dtype):
        states, invd, pb, lm_slot = builders.build_problem(spec, self.calib, caps, dtype=dtype)
        res = builders._count("initializer.solve", ba.solve_ba, states, invd, pb,
                              max_iterations=self.config.solver_iteration_limit)
        builders.apply_result(res, spec, lm_slot)

    # ------------------------------------------------------------------
    def init_sfm(self) -> bool:
        cfg = self.config
        m = self.map
        Km = self.calib.K
        dev = self.device
        fi = m.get_frame(0)
        fj = m.get_frame(m.frame_num - 1)

        matches = []  # (ki, kj)
        for ki in range(fi.keypoint_num):
            tr = m.get_track(fi, ki)
            if tr is None:
                continue
            kj = tr.obs.get(fj.id)
            if kj is None:
                continue
            matches.append((ki, kj))
        if len(matches) < cfg.initializer_min_matches:
            return False

        p1 = np.stack([fi.bearings[ki][:2] / fi.bearings[ki][2] for ki, _ in matches])
        p2 = np.stack([fj.bearings[kj][:2] / fj.bearings[kj][2] for _, kj in matches])
        pix1 = p1 * [Km[0, 0], Km[1, 1]] + [Km[0, 2], Km[1, 2]]
        pix2 = p2 * [Km[0, 0], Km[1, 1]] + [Km[0, 2], Km[1, 2]]
        parallax = np.linalg.norm(pix1 - pix2, axis=-1).mean()
        if parallax < cfg.initializer_min_parallax:
            return False

        N = len(matches)
        Ncap = 512
        if N > Ncap:
            matches = matches[:Ncap]
            p1, p2 = p1[:Ncap], p2[:Ncap]
            N = Ncap
        valid = np.zeros(Ncap, bool)
        valid[:N] = True
        p1p = np.zeros((Ncap, 2))
        p2p = np.zeros((Ncap, 2))
        p1p[:N], p2p[:N] = p1, p2
        p1t, p2t, vt = (to_device(a, dev) for a in (p1p, p2p, valid))

        thr = 0.7 / Km[0, 0]
        resH = ransac.ransac_homography(self._gumbel(512, Ncap), p1t, p2t, vt, thr)
        RH1, RH2, TH1, TH2, n1, n2, pure = homography.decompose_homography(resH.model)
        if bool(pure):
            return False  # pure rotation (reference initializer.cpp:188-191)
        if cfg.initializer_use_5pt:
            # Nistér 5-point minimal solver (reference essential.cpp:9-218)
            # on the host: it runs once per bootstrap attempt
            E5, _ = ransac_essential_5pt(np.random.default_rng(self._next_seed()), p1p,
                                         p2p, valid, thr, num_samples=128)
            if E5 is None:
                return False
            RE1, RE2, TE = epipolar.decompose_essential(to_device(E5, dev))
        else:
            resE = ransac.ransac_essential(self._gumbel(512, Ncap), p1t, p2t, vt, thr)
            RE1, RE2, TE = epipolar.decompose_essential(resE.model)

        def unit(v):
            return v / torch.clamp(torch.linalg.vector_norm(v), min=1e-12)

        Rs = torch.stack([RH1, RH1, RH2, RH2, RE1, RE1, RE2, RE2])
        Ts = torch.stack([unit(TH1), -unit(TH1), unit(TH2), -unit(TH2),
                          unit(TE), -unit(TE), unit(TE), -unit(TE)])
        pts, good, counts, scores = _hypothesis_triangulation(Rs, Ts, p1t, p2t, vt)
        counts, scores = asnp(counts), asnp(scores)
        # best: prefer count above min_triangulation with lowest score
        # (reference initializer.cpp:249-256)
        best = 0
        for i in range(8):
            if counts[i] > cfg.initializer_min_triangulation and scores[i] < scores[best]:
                best = i
            elif counts[i] > counts[best]:
                best = i
        if counts[best] < cfg.initializer_min_triangulation:
            return False

        R, T, points, status = fetch((Rs[best], Ts[best], pts[best], good[best]))

        # [2.1] endpoint camera poses: cam_i at identity, cam_j = inv(R, T)
        q_bc = self.calib.q_bc_h
        p_bc = self.calib.p_bc_h
        fi.set_pose(q_bc, p_bc, np.array([1.0, 0, 0, 0]), np.zeros(3))
        fj.set_pose(q_bc, p_bc, R_to_q(R.T), -(R.T @ T))

        frames_by_id = {f.id: f for f in m.all_frames()}
        for k, (ki, kj) in enumerate(matches):
            if not status[k]:
                continue
            tr = m.get_track(fi, ki)
            builders.set_landmark_point(tr, points[k], frames_by_id, self.calib)
            tr.set_tag(TT_VALID, True)
            tr.set_tag(TT_TRIANGULATED, True)

        # [2.2] middle frames via reprojection-prior solves (fixed anchors)
        for j in range(1, m.frame_num - 1):
            prev = m.get_frame(j - 1)
            fr = m.get_frame(j)
            fr.q, fr.p = prev.q.copy(), prev.p.copy()
            reproj_prior = []
            for k in range(fr.keypoint_num):
                t = m.get_track(fr, k)
                if t is None:
                    continue
                if fi.id not in t.obs:
                    continue
                if t.all_tagged(TT_VALID, TT_TRIANGULATED):
                    reproj_prior.append((fr, fi, t))
            if len(reproj_prior) < 6:
                continue
            spec = builders.BASpec(
                frames=[fr],
                fix_pose=[False], fix_motion=[True],
                opt_tracks=[], reproj=[], imu=[], rot=[],
                reproj_prior=reproj_prior,
            )
            self._solve(spec, self.caps_fast, self._fast_dtype)

        # [2.3] triangulate remaining tracks
        pending = [t for t in m.tracks.values() if not t.tag(TT_VALID)]
        pts2, ok2 = builders.triangulate_tracks(pending, frames_by_id, self.calib, self.caps)
        for t, x, ok in zip(pending, pts2, ok2):
            if ok:
                builders.set_landmark_point(t, x, frames_by_id, self.calib)
                t.set_tag(TT_VALID, True)
                t.set_tag(TT_TRIANGULATED, True)

        # [3.1] visual-only BA (motion fixed)
        frames = m.frames
        fid_list = [f.id for f in frames]
        reproj = []
        opt_tracks = [t for t in m.tracks.values() if t.all_tagged(TT_VALID, TT_TRIANGULATED)]
        for f in frames:
            for k in range(f.keypoint_num):
                t = m.get_track(f, k)
                if t is None or not t.all_tagged(TT_VALID, TT_TRIANGULATED):
                    continue
                if t.first_frame_id() == f.id or t.first_frame_id() not in fid_list:
                    continue
                reproj.append((f, frames[fid_list.index(t.first_frame_id())], t, False))
        spec = builders.BASpec(
            frames=frames,
            fix_pose=[i == 0 for i in range(len(frames))],
            fix_motion=[True] * len(frames),
            opt_tracks=opt_tracks, reproj=reproj, imu=[], rot=[],
        )
        self._solve(spec, self.caps, None)

        # [3.2] prune high-error tracks (reprojection error > 3 px)
        self._update_reprojection_errors()
        m.prune_tracks(
            lambda t: (not t.tag(TT_VALID)) or t.reprojection_error > 3.0
        )
        return True

    def _update_reprojection_errors(self):
        m = self.map
        Km = self.calib.K
        frames_by_id = {f.id: f for f in m.all_frames()}
        q_bc = self.calib.q_bc_h
        p_bc = self.calib.p_bc_h
        for t in m.tracks.values():
            if not t.all_tagged(TT_VALID, TT_TRIANGULATED):
                continue
            x = builders.get_landmark_point(t, frames_by_id, self.calib)
            errs = []
            for fid, k in t.obs.items():
                f = frames_by_id.get(fid)
                if f is None:
                    continue
                qc, pc = f.get_pose(q_bc, p_bc)
                y = qrot(qconj(qc), x - pc)
                if y[2] < 1e-6:
                    errs.append(1e9)
                    continue
                z = f.bearings[k]
                pred = np.array([y[0] / y[2] * Km[0, 0], y[1] / y[2] * Km[1, 1]])
                obs = np.array([z[0] / z[2] * Km[0, 0], z[1] / z[2] * Km[1, 1]])
                errs.append(np.linalg.norm(pred - obs))
            t.reprojection_error = float(np.mean(errs)) if errs else float("inf")

    # ------------------------------------------------------------------
    def init_imu(self) -> bool:
        cfg = self.config
        self.bg = np.zeros(3)
        self.ba = np.zeros(3)
        self.gravity = np.zeros(3)
        self.scale = 1.0
        self.velocities = [np.zeros(3) for _ in range(self.map.frame_num)]
        self.solve_gyro_bias()
        self.solve_gravity_scale_velocity()
        if self.scale < 0.001 or self.scale > 1.0:
            return False
        if cfg.initializer_refine_imu:
            self.refine_scale_velocity_via_gravity()
            if self.scale < 0.001 or self.scale > 1.0:
                return False
        return self.apply_init()

    def _preintegrate(self):
        """Re-integrate every interval at the current (bg, ba)."""
        m = self.map
        imu_list = [
            (m.get_frame(j).imu_dt, m.get_frame(j).imu_w, m.get_frame(j).imu_a)
            for j in range(1, m.frame_num)
        ]
        n = len(imu_list)
        deltas, _ = builders.integrate_frames(
            imu_list, np.tile(self.bg, (n, 1)), np.tile(self.ba, (n, 1)),
            self.calib, self.caps.IMU_KF,
        )
        self._deltas = fetch(deltas)

    def _imu_pose(self, f: Frame):
        return f.get_pose(self.calib.q_bi_h, self.calib.p_bi_h)

    def _cam_pose(self, f: Frame):
        return f.get_pose(self.calib.q_bc_h, self.calib.p_bc_h)

    def solve_gyro_bias(self):
        """3x3 Gauss-Newton normal equations on preintegrated rotation error
        (reference initializer.cpp:382-406), host math."""
        from scipy.spatial.transform import Rotation

        def logmap(q_wxyz):
            return Rotation.from_quat(np.r_[q_wxyz[1:], q_wxyz[0]]).as_rotvec()

        self._preintegrate()
        m = self.map
        A = np.zeros((3, 3))
        b = np.zeros(3)
        for j in range(1, m.frame_num):
            qi, _ = self._imu_pose(m.get_frame(j - 1))
            qj, _ = self._imu_pose(m.get_frame(j))
            dq = self._deltas.q[j - 1]
            dq_dbg = self._deltas.dq_dbg[j - 1]
            e = logmap(qmul(qconj(qmul(qi, dq)), qj))
            A += dq_dbg.T @ dq_dbg
            b += dq_dbg.T @ e
        self.bg = np.linalg.lstsq(A, b, rcond=None)[0]

    def solve_gravity_scale_velocity(self):
        """Linear LS over [g, s, v_0..N] (reference initializer.cpp:408-447)."""
        self._preintegrate()
        m = self.map
        N = m.frame_num
        A = np.zeros(((N - 1) * 6, 3 + 1 + 3 * N))
        b = np.zeros((N - 1) * 6)
        p_bc = self.calib.p_bc_h
        for j in range(1, N):
            i = j - 1
            fi, fj = m.get_frame(i), m.get_frame(j)
            dt = float(self._deltas.t[i])
            dp = self._deltas.p[i]
            dv = self._deltas.v[i]
            _, pci = self._cam_pose(fi)
            _, pcj = self._cam_pose(fj)
            A[i * 6 : i * 6 + 3, 0:3] = -0.5 * dt * dt * np.eye(3)
            A[i * 6 : i * 6 + 3, 3] = pcj - pci
            A[i * 6 : i * 6 + 3, 4 + i * 3 : 7 + i * 3] = -dt * np.eye(3)
            b[i * 6 : i * 6 + 3] = qrot(fi.q, dp) + (qrot(fj.q, p_bc) - qrot(fi.q, p_bc))
            A[i * 6 + 3 : i * 6 + 6, 0:3] = -dt * np.eye(3)
            A[i * 6 + 3 : i * 6 + 6, 4 + i * 3 : 7 + i * 3] = -np.eye(3)
            A[i * 6 + 3 : i * 6 + 6, 4 + j * 3 : 7 + j * 3] = np.eye(3)
            b[i * 6 + 3 : i * 6 + 6] = qrot(fi.q, dv)
        x = np.linalg.lstsq(A, b, rcond=None)[0]
        g = x[0:3]
        self.gravity = g / max(np.linalg.norm(g), 1e-12) * GRAVITY_NOMINAL
        self.scale = float(x[3])
        self.velocities = [x[4 + i * 3 : 7 + i * 3] for i in range(N)]

    def refine_scale_velocity_via_gravity(self):
        """One damped iteration with gravity on the S2 tangent
        (reference initializer.cpp:449-499)."""
        damp = 0.1
        self._preintegrate()
        m = self.map
        N = m.frame_num
        A = np.zeros(((N - 1) * 6, 2 + 1 + 3 * N))
        b = np.zeros((N - 1) * 6)
        p_bc = self.calib.p_bc_h
        g_dir = self.gravity / np.linalg.norm(self.gravity)
        Tg = s2_tangential_basis(torch.from_numpy(g_dir)).numpy()
        for j in range(1, N):
            i = j - 1
            fi, fj = m.get_frame(i), m.get_frame(j)
            dt = float(self._deltas.t[i])
            dp = self._deltas.p[i]
            dv = self._deltas.v[i]
            _, pci = self._cam_pose(fi)
            _, pcj = self._cam_pose(fj)
            A[i * 6 : i * 6 + 3, 0:2] = -0.5 * dt * dt * Tg
            A[i * 6 : i * 6 + 3, 2] = pcj - pci
            A[i * 6 : i * 6 + 3, 3 + i * 3 : 6 + i * 3] = -dt * np.eye(3)
            b[i * 6 : i * 6 + 3] = (
                0.5 * dt * dt * self.gravity + qrot(fi.q, dp)
                + (qrot(fj.q, p_bc) - qrot(fi.q, p_bc))
            )
            A[i * 6 + 3 : i * 6 + 6, 0:2] = -dt * Tg
            A[i * 6 + 3 : i * 6 + 6, 3 + i * 3 : 6 + i * 3] = -np.eye(3)
            A[i * 6 + 3 : i * 6 + 6, 3 + j * 3 : 6 + j * 3] = np.eye(3)
            b[i * 6 + 3 : i * 6 + 6] = dt * self.gravity + qrot(fi.q, dv)
        x = np.linalg.lstsq(A, b, rcond=None)[0]
        g = self.gravity + damp * (Tg @ x[0:2])
        self.gravity = g / max(np.linalg.norm(g), 1e-12) * GRAVITY_NOMINAL
        self.scale = float(x[2])
        self.velocities = [x[3 + i * 3 : 6 + i * 3] for i in range(N)]

    def apply_init(self, apply_ba=False, apply_velocity=True) -> bool:
        """Gravity-align the world, apply scale, set motion states, and
        re-triangulate everything (reference initializer.cpp:517-553)."""
        m = self.map
        gravity_nominal = np.array([0.0, 0.0, -GRAVITY_NOMINAL])
        q = q_from_two_vectors(self.gravity, gravity_nominal)
        q_bi = self.calib.q_bi_h
        p_bi = self.calib.p_bi_h
        for i, f in enumerate(m.frames):
            qi, pi = f.get_pose(q_bi, p_bi)
            qi = qmul(q, qi)
            pi = self.scale * qrot(q, pi)
            f.set_pose(q_bi, p_bi, qi, pi)
            f.v = qrot(q, self.velocities[i]) if apply_velocity else np.zeros(3)
            f.bg = self.bg.copy()
            f.ba = self.ba.copy() if apply_ba else np.zeros(3)

        frames_by_id = {f.id: f for f in m.all_frames()}
        tracks = list(m.tracks.values())
        pts, ok = builders.triangulate_tracks(tracks, frames_by_id, self.calib, self.caps)
        n_ok = 0
        for t, x, o in zip(tracks, pts, ok):
            if o:
                builders.set_landmark_point(t, x, frames_by_id, self.calib)
                t.set_tag(TT_VALID, True)
                t.set_tag(TT_TRIANGULATED, True)
                t.life = 1
                n_ok += 1
            else:
                t.set_tag(TT_VALID, False)
        return n_ok >= self.config.initializer_min_landmarks
