"""Sliding-window tracker variant for the batched lockstep runtime.

Port of the JAX package's batch/swt.py. Per sequence the behaviour is the
single-sequence SlidingWindowTracker's; only the execution of the two
steady-state device programs changes:

- the per-frame localize + subwindow chain is submitted to the shared
  BatchDispatcher instead of run directly; the device-resident chain states
  live as this sequence's row of the dispatcher's batched chain (`BATCHED`
  in `_dev_sub`), and the deferred-result FIFO holds RowFutures (slices of
  the one batched fetch);
- the fused keyframe step is assembled on the host as usual
  (builders.assemble_keyframe_fused) and submitted; its fetch-and-apply
  tail (window states, track outcomes, slide_window, publish) runs as a
  continuation when the runtime flushes the tick;
- the marginalization prior is a row of the dispatcher's batched prior tree
  (`PRIOR_REF`); the rare host path that needs a standalone prior (a double
  marginalization) takes the row, runs the single-sequence code and writes
  the row back.
"""

from __future__ import annotations

import numpy as np

from rd_vio_tpu_torch.models import builders
from rd_vio_tpu_torch.models.map import TB_TRIANGULATED
from rd_vio_tpu_torch.models.sliding_window_tracker import SlidingWindowTracker
from rd_vio_tpu_torch.utils.metrics import GLOBAL_TIMER as T


class _BatchedChain:
    """Sentinel tag for `_dev_sub` when the chain states live in the
    dispatcher's batched tree."""


BATCHED = _BatchedChain()


class BatchedPriorRef:
    """Stands for a device PriorFactor stored as this sequence's row of the
    dispatcher's batched prior tree; truthy, so `prior is None` checks see a
    prior."""


PRIOR_REF = BatchedPriorRef()


class BatchSWT(SlidingWindowTracker):
    def __init__(self, *args, dispatcher=None, seq_index: int = 0, **kw):
        super().__init__(*args, **kw)
        if dispatcher is None:
            raise ValueError("BatchSWT needs its BatchDispatcher")
        self.disp = dispatcher
        self.i = int(seq_index)
        self._publish_cb = None
        self._kf_deferred = False

    # -- frontend hook: publish after the keyframe continuation ------------
    def defer_publish_hook(self, cb) -> bool:
        if self._kf_deferred:
            self._publish_cb = cb
            return True
        return False

    # -- per-frame subframe path -------------------------------------------
    def _solve_subwindow(self, spec, spec_loc, j_slot):
        if spec_loc is None:
            # the non-fused path: the single-sequence solve; the batched
            # chain restarts at -1 maps
            self._dev_sub = None
            return super()._solve_subwindow(spec, spec_loc, j_slot)
        with T.time("bld.sub.assemble"):
            pa_loc, _ = builders._assemble(spec_loc, self.caps_fast, self.calib)
            pa_sub, lm_slot = builders._assemble(spec, self.caps_fast, self.calib)
            pa_loc = builders._cast_pa(pa_loc, self._fast_dtype)
            pa_sub = builders._cast_pa(pa_sub, self._fast_dtype)
        loc_ip_prev = -1
        sub_prev = np.full(self.caps_fast.W, -1, np.int32)
        if isinstance(self._dev_sub, tuple) and self._dev_sub[0] is BATCHED:
            slot_of = self._dev_sub[1]
            anchor_i = spec_loc.imu_prior[0][0]
            loc_ip_prev = slot_of.get(anchor_i.id, -1)
            for si, f in enumerate(spec.frames[: self.caps_fast.W]):
                sub_prev[si] = slot_of.get(f.id, -1)
        fut = self.disp.submit_sub(self.i, pa_loc, pa_sub, j_slot, loc_ip_prev, sub_prev)
        self._dev_sub = (BATCHED, {f.id: k for k, f in enumerate(spec.frames)})
        self._pending_subs.append(
            (fut, lambda tree: builders.apply_result_np(tree, spec, lm_slot), False))

    # -- keyframe path -------------------------------------------------------
    def _keyframe_fused(self, spec_loc, frame_j):
        """Assemble what the base method assembles, then submit it to the
        dispatcher; the fetch-and-apply tail becomes a continuation run at
        the runtime's flush. Returns True (deferred)."""
        m = self.map
        st = m.store
        frames = list(m.frames)
        frames_by_id = {f.id: f for f in m.all_frames()}
        newframe = frames[-1]

        pending = self._select_pending(newframe)
        pending_ids = {t.id for t in pending}
        spec_w = self._window_spec(frames, frames_by_id, pending=pending)
        all_tids = np.fromiter(m.tracks, np.int64, len(m.tracks))
        all_rows = st.rows_of(all_tids)
        tri_sel = (st.flags[all_rows] & TB_TRIANGULATED) != 0
        tracks_v = [m.tracks[int(tid)] for tid in all_tids[tri_sel]]
        tracks_v += pending
        spec_m = self._marg_spec(
            frames, frames_by_id, require_valid=False, pending_ids=pending_ids)

        with builders._stats_lock:
            builders.KF_FUSED_COUNT.n += 1
        arrays, lm_w = builders.assemble_keyframe_fused(
            spec_loc, pending, spec_w, tracks_v, spec_m, frames_by_id,
            self.calib, self.caps, caps_loc=self.caps_fast,
            dtype=self._window_dtype, loc_dtype=self._fast_dtype,
        )
        # prior-row transition: the first batched keyframe moves this
        # sequence's device prior into the dispatcher's batched tree
        if not isinstance(self.prior, BatchedPriorRef):
            self.disp.put_prior_row(self.i, self.prior)
            self.prior = PRIOR_REF

        spec_w_frames = list(spec_w.frames)
        fut_holder = []
        fut = self.disp.submit_kf(
            self.i, arrays,
            continuation=lambda: self._kf_apply(
                fut_holder[0], lm_w, pending, pending_ids, tracks_v,
                spec_w_frames, frame_j),
        )
        fut_holder.append(fut)
        self._kf_deferred = True
        return True

    def _kf_apply(self, fut, lm_w, pending, pending_ids, tracks_v, spec_w_frames,
                  frame_j):
        """Continuation: the base _keyframe_fused's fetch-and-apply tail and
        the keyframe branch's epilogue (slide_window, chain reset, publish)."""
        (q, p, v, bg, ba_, invd_h, lq, lp, lv, lbg, lba,
         valid_h, ok_h, tri_h) = fut.wait()
        frame_j.q, frame_j.p, frame_j.v = lq[0], lp[0], lv[0]
        frame_j.bg, frame_j.ba = lbg[0], lba[0]
        for i, f in enumerate(spec_w_frames):
            f.q, f.p, f.v, f.bg, f.ba = q[i], p[i], v[i], bg[i], ba_[i]
        self._apply_kf_track_results(
            lm_w, invd_h, pending, pending_ids, ok_h, tri_h, tracks_v, valid_h)
        self._pending_prior = PRIOR_REF  # the row was updated by the program
        self._kf_deferred = False
        self._finish_keyframe()
        cb, self._publish_cb = self._publish_cb, None
        if cb is not None:
            cb()

    # -- the rare host path that needs a standalone prior ----------------------
    def _marginalize_frame0(self):
        if isinstance(self.prior, BatchedPriorRef):
            self.prior = self.disp.get_prior_row(self.i)
            super()._marginalize_frame0()
            self.disp.put_prior_row(self.i, self.prior)
            self.prior = PRIOR_REF
        else:
            super()._marginalize_frame0()
