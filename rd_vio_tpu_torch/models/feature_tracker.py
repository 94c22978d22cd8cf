"""Feature tracker: per-frame keypoint tracking/detection over the raw-frame
map, with the pure-rotation detector and track-length-priority Poisson
re-filtering.

Behavioral reference: feature_tracker.cpp (run :26-111) and frame.cpp
(detect_keypoints :55-72, track_keypoints :74-172 — IMU-predicted initial
flow, essential-RANSAC mask, 2-pt rotation RANSAC + 70th-percentile
misalignment => FT_NO_TRANSLATION, Poisson-disk re-filter by track length).

The counterpart of the JAX package's models/feature_tracker.py, two paths:

- the device loop (a backend with `supports_device_loop`, such as
  TorchImageBackend, and `feature_tracker_device_loop` on): each frame pair
  is one `ops.frontend_loop.ft_loop_step` on the backend's device, its
  results are copied back asynchronously and finalized
  `feature_tracker_pipeline_depth` frames later;
- the host-mask path (`_track_keypoints`, any other backend, such as the
  perfect-match `SyntheticBackend`): the backend tracks, the mask RANSAC
  runs on the host (`ops.frontend_step_np.ft_step_np`, host seeds) or, with
  `feature_tracker_host_masks` off, as the device program
  `ops.frontend_step.ft_step` (Gumbel noise from `noise`, one fetch), the
  Poisson re-filter on the host, and each frame is issued at once.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional

import numpy as np
import torch

from rd_vio_tpu_torch.models import builders
from rd_vio_tpu_torch.models.map import FT_NO_TRANSLATION, Frame, Map, TT_TRASH
from rd_vio_tpu_torch.models.quat_np import q_to_R, qconj, qmul
from rd_vio_tpu_torch.ops import frontend_loop as fl
from rd_vio_tpu_torch.ops import frontend_step as fs
from rd_vio_tpu_torch.ops import poisson_disk
from rd_vio_tpu_torch.ops import preintegration_np as pre_np
from rd_vio_tpu_torch.ops.frontend_step_np import ft_step_np
from rd_vio_tpu_torch.ops.ransac import GumbelSource
from rd_vio_tpu_torch.utils.host import fetch, fetch_async, to_device
from rd_vio_tpu_torch.utils.metrics import GLOBAL_TIMER as T


class SyntheticBackend:
    """Perfect-match backend over a SyntheticSequence; image handle = frame
    index into the sequence (the reference's abstract Image seam,
    types.h:153-177). Host NumPy only."""

    def __init__(self, seq):
        self.seq = seq

    def _frame_kps(self, fidx):
        ids = self.seq.kp_id[fidx]
        pix = self.seq.kp_pixel[fidx]
        m = ids >= 0
        return pix[m], ids[m]

    def detect(self, image, existing_pix, max_points, min_dist):
        pix, ids = self._frame_kps(image)
        # exclude already-tracked synthetic landmarks by pixel proximity
        if len(existing_pix):
            d = np.linalg.norm(pix[:, None] - existing_pix[None], axis=-1)
            keep = d.min(axis=1) > min_dist * 0.5
            pix = pix[keep]
        return pix[: max(0, max_points - len(existing_pix))]

    def track(self, prev_image, next_image, prev_pix, pred_pix):
        pix_p, ids_p = self._frame_kps(prev_image)
        pix_n, ids_n = self._frame_kps(next_image)
        out = np.zeros_like(prev_pix)
        status = np.zeros(len(prev_pix), bool)
        if len(pix_p) == 0 or len(prev_pix) == 0:
            return out, status
        # exact-pixel association: bearings are pixel-exact in this backend,
        # so anything farther than numerical noise is a different landmark
        d = np.linalg.norm(prev_pix[:, None] - pix_p[None], axis=-1)  # (N, M)
        j = np.argmin(d, axis=1)
        hit = d[np.arange(len(prev_pix)), j] <= 1e-5
        lid = ids_p[j]  # landmark id per prev keypoint
        next_pos = np.full(int(ids_n.max()) + 2, -1, dtype=np.int64)
        next_pos[ids_n] = np.arange(len(ids_n))
        k = next_pos[np.clip(lid, 0, len(next_pos) - 1)]
        ok = hit & (k >= 0)
        out[ok] = pix_n[k[ok]]
        status[ok] = True
        return out, status


class FeatureTracker:
    KP_CAP = 384  # fixed per-frame tracking capacity

    def __init__(self, config, calib: builders.CalibArrays, caps: builders.Caps,
                 backend, device=None,
                 noise: Optional[Callable[[int, int], tuple]] = None):
        """backend: an image backend; with `supports_device_loop` (e.g.
        models.image_backend.TorchImageBackend) and
        feature_tracker_device_loop on, the device loop runs, else the
        host-mask path. device: where the loop state (or the device mask
        program) lives (default: the backend's device). noise (device loop,
        or feature_tracker_host_masks off): callable
        (num_hypotheses, n) -> (gumbel_essential, gumbel_rotation), each
        (num_hypotheses, n); default a GumbelSource seeded with
        config.random + 1."""
        self.device_loop = bool(
            getattr(config, "feature_tracker_device_loop", True)
            and getattr(backend, "supports_device_loop", False)
        )
        self.config = config
        self.calib = calib
        self.caps = caps
        self.backend = backend
        if device is None:
            device = getattr(backend, "device", "cuda")
        self.device = torch.device(device)
        self.map = Map()
        self.frontend = None  # set by models.odometry.Odometry
        self._noise = noise
        if (self.device_loop or not config.feature_tracker_host_masks) and noise is None:
            self._noise = GumbelSource(config.random + 1, self.device)
        self._host_seed_ctr = 0
        self._frame_counter = 0
        self.latest_state = None  # (t, q, p, v, bg, ba)
        # optional utils.metrics.DeviceStageTimer: times ft.step (the whole
        # ft_loop_step) and its stages
        self.device_timer = None
        self._dl_state = None  # fl.FTLoopState (device)
        # FIFO of in-flight (fetch, frame, last) triples; a pair is finalized
        # once `depth` pairs are in flight (config.feature_tracker_pipeline_depth)
        self._dl_pending = []
        self._dl_depth = int(getattr(config,
                                     "feature_tracker_pipeline_depth", 2))
        self._dl_slot_kp = np.full(self.KP_CAP, -1, np.int32)
        self._dl_drop = np.zeros(self.KP_CAP, bool)
        self._K_dev = (to_device(np.asarray(calib.K, np.float32), self.device)
                       if self.device_loop else None)

    def _next_seed(self) -> tuple:
        """Host seed material for the NumPy mask path (the same
        (seed, counter) stream as the JAX package's)."""
        self._host_seed_ctr += 1
        return (self.config.random + 1, self._host_seed_ctr)

    # -- helpers -------------------------------------------------------
    def _pix_from_bearings(self, frame: Frame) -> np.ndarray:
        Km = self.calib.K
        b = frame.bearings
        if len(b) == 0:
            return np.zeros((0, 2))
        return np.stack(
            [
                b[:, 0] / b[:, 2] * Km[0, 0] + Km[0, 2],
                b[:, 1] / b[:, 2] * Km[1, 1] + Km[1, 2],
            ],
            axis=-1,
        )

    def _bearing_from_pix(self, pix: np.ndarray) -> np.ndarray:
        Km = self.calib.K
        x = (pix[:, 0] - Km[0, 2]) / Km[0, 0]
        y = (pix[:, 1] - Km[1, 2]) / Km[1, 1]
        b = np.stack([x, y, np.ones_like(x)], axis=-1)
        return b / np.linalg.norm(b, axis=-1, keepdims=True)

    # -- main per-frame entry (reference feature_tracker.cpp:26-111) ---
    def track_frame(self, frame: Frame):
        if self.device_loop:
            return self._track_frame_device_loop(frame)
        self._frame_counter += 1

        # re-anchor poses from the frontend's latest optimized state
        with self.map.lock:
            self._repropagate_from_optimized()
            last = self.map.get_frame(self.map.frame_num - 1) if self.map.frame_num else None

        if last is not None:
            with T.time("ft.track"):
                self._track_keypoints(last, frame)
            self.latest_state = (frame.t, frame.q.copy(), frame.p.copy(),
                                 frame.v.copy(), frame.bg.copy(), frame.ba.copy())

        if (self._frame_counter % max(self.config.sliding_window_tracker_frequent, 1)) == 0:
            self._detect_keypoints(frame)

        with self.map.lock:
            self.map.attach_frame(frame)
            self._trim_map()
        if self.frontend is not None:
            self.frontend.issue_frame(frame)

    def _track_frame_device_loop(self, frame: Frame):
        """Pipelined per-frame entry: finalize the OLDEST in-flight pair once
        the FIFO is full, dispatch this pair's step (device-to-device state
        dependency, no host round trip), and only then issue the finalized
        frame downstream."""
        self._frame_counter += 1
        with self.map.lock:
            self._repropagate_from_optimized()
            last = (self.map.get_frame(self.map.frame_num - 1)
                    if self.map.frame_num else None)

        done = None
        if len(self._dl_pending) >= self._dl_depth:
            with T.time("ft.finalize"):
                done = self._dl_finalize()

        if last is not None:
            with T.time("ft.dispatch"):
                self._dl_dispatch(last, frame)
            with self.map.lock:
                builders.predict_frame(last, frame, self.calib, self.caps.IMU)
            self.latest_state = (frame.t, frame.q.copy(), frame.p.copy(),
                                 frame.v.copy(), frame.bg.copy(),
                                 frame.ba.copy())

        with self.map.lock:
            self.map.attach_frame(frame)
            self._trim_map()
        if done is not None and self.frontend is not None:
            self.frontend.issue_frame(done)

    def _dl_dispatch(self, last: Frame, frame: Frame):
        cfg = self.config
        dev = self.device
        if self._dl_state is None:
            self._dl_state = fl.init_state(self.KP_CAP, dev)

        R_pred = np.eye(3)
        delta_q = self._interval_rotation(frame)
        if cfg.feature_tracker_predict_keypoints and delta_q is not None:
            q_bc = self.calib.q_bc_h
            q_bi = self.calib.q_bi_h
            dkq = qconj(qmul(qmul(qmul(qmul(qconj(q_bc), q_bi), delta_q),
                                  qconj(q_bi)), q_bc))
            R_pred = q_to_R(dkq)

        detect_due = (
            self._frame_counter
            % max(cfg.sliding_window_tracker_frequent, 1)
        ) == 0
        noise = self._mask_noise()
        timer = self.device_timer
        with timer.time("ft.step") if timer is not None else contextlib.nullcontext():
            state, fetch = fl.ft_loop_step(
                self._dl_state, last.image.pyramid, frame.image.pyramid,
                to_device(np.asarray(R_pred, np.float32), dev), noise,
                to_device(self._dl_drop, dev), self._K_dev,
                float(np.float32(np.radians(cfg.rotation_ransac_threshold))),
                detect=detect_due,
                max_points=int(cfg.feature_tracker_max_keypoint_detection),
                min_dist=float(cfg.feature_tracker_min_keypoint_distance),
                lk=self.backend.lk,
                timer=timer,
            )
        self._dl_state = state
        # start the device->host copy now; it is consumed pipeline-depth
        # frames later by _dl_finalize
        self._dl_pending.append((fetch_async(fetch), frame, last))

    def _mask_noise(self):
        """This frame's (essential, rotation) Gumbel noise on the device."""
        return tuple(
            g if isinstance(g, torch.Tensor) else to_device(g, self.device, torch.float32)
            for g in self._noise(int(self.config.ransac_hypotheses), self.KP_CAP)
        )

    def _dl_finalize(self) -> Optional[Frame]:
        """Fetch + host bookkeeping for the OLDEST in-flight pair: append
        keypoints to the pair's new frame, extend track links, set the
        pure-rotation tag, and compute the retired-slot mask for the next
        dispatch."""
        fetch, frame, last = self._dl_pending.pop(0)
        out = fetch.wait()
        cfg = self.config

        if float(out["misalign"]) < cfg.rotation_misalignment_threshold:
            frame.set_tag(FT_NO_TRANSLATION, True)

        valid = out["valid"]
        cont = out["cont"]
        pix = out["pix"]
        idxs = np.flatnonzero(valid)
        slot_kp_new = np.full(self.KP_CAP, -1, np.int32)
        drop = np.zeros(self.KP_CAP, bool)
        with self.map.lock:
            if len(idxs):
                bearings = self._bearing_from_pix(pix[idxs])
                k0 = frame.append_keypoints(bearings)
                slot_kp_new[idxs] = k0 + np.arange(len(idxs), dtype=np.int32)
            for s in np.flatnonzero(cont):
                k_old = int(self._dl_slot_kp[s])
                if k_old < 0:
                    continue
                t = self.map.get_track(last, k_old, create=True)
                if t.tag(TT_TRASH):
                    # retire the slot WITHOUT extending the trashed track;
                    # its slot keeps its Poisson cell until the drop mask
                    # reaches the device
                    drop[s] = True
                    continue
                self.map.add_keypoint(t, frame, int(slot_kp_new[s]))
        self._dl_slot_kp = slot_kp_new
        self._dl_drop = drop
        return frame

    def flush(self):
        """Finalize + issue ALL in-flight pairs in order (sequence end or
        pipeline drain); nothing is in flight on the host-mask path."""
        while self._dl_pending:
            done = self._dl_finalize()
            if done is not None and self.frontend is not None:
                self.frontend.issue_frame(done)

    def refresh_from_optimized(self):
        """Called by the frontend right after it publishes a new optimized
        state: re-anchor the raw-frame chain and refresh latest_state."""
        with self.map.lock:
            self._repropagate_from_optimized()
            if self.map.frame_num > 0:
                f = self.map.get_frame(self.map.frame_num - 1)
                self.latest_state = (f.t, f.q.copy(), f.p.copy(), f.v.copy(),
                                     f.bg.copy(), f.ba.copy())

    def _repropagate_from_optimized(self):
        """Pull the frontend's latest optimized state and re-propagate all
        later frames (reference feature_tracker.cpp:36-69)."""
        fe = self.frontend
        if fe is None or fe.latest_optimized is None:
            return
        t, fid, q, p, v, bg, ba_ = fe.latest_optimized
        idx = self.map.frame_index_by_id(fid)
        if idx is None:
            return
        f = self.map.get_frame(idx)
        f.q, f.p, f.v, f.bg, f.ba = q.copy(), p.copy(), v.copy(), bg.copy(), ba_.copy()
        chain = [self.map.get_frame(i) for i in range(idx + 1, self.map.frame_num)]
        if chain:
            builders.propagate_chain(chain, f, self.calib, self.caps.IMU)

    # -- host-mask path --------------------------------------------------
    def _track_keypoints(self, last: Frame, frame: Frame):
        cfg = self.config
        Km = self.calib.K
        n = min(last.keypoint_num, self.KP_CAP)
        if n == 0:
            with self.map.lock:
                builders.predict_frame(last, frame, self.calib, self.caps.IMU)
            return
        curr_pix = self._pix_from_bearings(last)[:n]

        # IMU-predicted initial flow (reference frame.cpp:82-93)
        pred_pix = curr_pix
        delta_q = self._interval_rotation(frame)
        if cfg.feature_tracker_predict_keypoints and delta_q is not None:
            q_bc = self.calib.q_bc_h
            q_bi = self.calib.q_bi_h
            dkq = qconj(
                qmul(qmul(qmul(qmul(qconj(q_bc), q_bi), delta_q), qconj(q_bi)), q_bc)
            )
            pb = last.bearings[:n] @ q_to_R(dkq).T
            pred_pix = np.stack(
                [
                    pb[:, 0] / np.maximum(pb[:, 2], 1e-6) * Km[0, 0] + Km[0, 2],
                    pb[:, 1] / np.maximum(pb[:, 2], 1e-6) * Km[1, 1] + Km[1, 2],
                ],
                axis=-1,
            )

        next_pix_raw, status = self.backend.track(last.image, frame.image, curr_pix, pred_pix)
        next_bearings = self._bearing_from_pix(
            np.where(status[:, None], next_pix_raw, curr_pix)
        )

        # priority bookkeeping for the Poisson re-filter
        cap = self.KP_CAP
        lengths = np.zeros(n)
        trash = np.zeros(cap, bool)
        with self.map.lock:
            for i in range(n):
                t = self.map.get_track(last, i)
                if t is not None:
                    lengths[i] = len(t.obs)
                    trash[i] = t.tag(TT_TRASH)
        order = np.zeros(cap, np.int32)
        order[:n] = np.argsort(-lengths, kind="stable")
        order[n:] = np.arange(n, cap)

        b1 = np.zeros((cap, 3), np.float32)
        b2 = np.tile(np.array([0.0, 0.0, 1.0], np.float32), (cap, 1))
        val = np.zeros(cap, bool)
        npix = np.zeros((cap, 2), np.float32)
        b1[:n] = last.bearings[:n]
        b2[:n] = next_bearings
        val[:n] = status
        npix[:n] = next_pix_raw

        W_img, H_img = self.config.camera_resolution
        rot_thr = np.float32(np.radians(cfg.rotation_ransac_threshold))
        pending = None
        if not cfg.feature_tracker_host_masks:
            # the device mask program runs while the host predicts
            dev = self.device
            pending = fs.ft_step(to_device(b1, dev), to_device(b2, dev),
                                 to_device(val, dev), self._mask_noise(), float(rot_thr))
        # predicted state, under map.lock: the frontend worker rewrites
        # last's state concurrently (_repropagate_from_optimized)
        with self.map.lock:
            builders.predict_frame(last, frame, self.calib, self.caps.IMU)
        if pending is None:
            out = ft_step_np(b1, b2, val, self._next_seed(), rot_thr,
                             num_hypotheses=cfg.ransac_hypotheses)
        else:
            out = fetch(pending)

        # pure-rotation detector (reference frame.cpp:115-131)
        if float(out["misalign"]) < cfg.rotation_misalignment_threshold:
            frame.set_tag(FT_NO_TRANSLATION, True)

        # track-length-priority Poisson re-filter (reference frame.cpp:134-161)
        status_m = np.asarray(out["mask"])
        pd_val = status_m[order] & ~trash[order]
        acc = poisson_disk.poisson_disk_filter_np(
            npix[order], pd_val,
            min_distance=float(cfg.feature_tracker_min_keypoint_distance),
            width=float(W_img), height=float(H_img),
        )
        keep = np.zeros_like(status_m)
        keep[order] = acc
        final = (status_m & keep & ~trash)[:n]
        survivors = np.flatnonzero(final)
        with self.map.lock:
            k_new = frame.append_keypoints(next_bearings[survivors])
            for off, i in enumerate(survivors):
                t = self.map.get_track(last, i, create=True)
                self.map.add_keypoint(t, frame, k_new + off)

    def _detect_keypoints(self, frame: Frame):
        cfg = self.config
        existing = self._pix_from_bearings(frame)
        new_pix = self.backend.detect(
            frame.image, existing,
            cfg.feature_tracker_max_keypoint_detection,
            cfg.feature_tracker_min_keypoint_distance,
        )
        if len(new_pix) == 0:
            return
        for b in self._bearing_from_pix(np.asarray(new_pix)):
            frame.append_keypoint(b)

    def _interval_rotation(self, frame: Frame):
        """Integrate the frame's gyro samples into a delta rotation quat."""
        if len(frame.imu_dt) == 0:
            return None
        return pre_np.interval_rotation_mean(
            frame.imu_dt, frame.imu_w, frame.imu_a, np.zeros(3), np.zeros(3)
        )

    def _trim_map(self):
        limit = self.config.feature_tracker_max_init_frames
        if self.frontend is not None and not self.frontend.initializing:
            limit = self.config.feature_tracker_max_frames
        while self.map.frame_num > limit:
            self.map.erase_frame(0)
        # release pixel buffers of frames that can no longer be tracked from
        # (reference opencv_image.cpp:200-208 release_image_buffer)
        for f in self.map.frames[:-2]:
            if f.image is not None and hasattr(f.image, "release"):
                f.image.release()
