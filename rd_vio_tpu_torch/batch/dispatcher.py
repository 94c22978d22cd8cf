"""Coalescing dispatcher for the batched multi-sequence runtime.

Port of the JAX package's batch/dispatcher.py. Per lockstep tick, every
sequence's host pipeline assembles its solve (NumPy, per sequence) and
submits it here; `flush()` stacks the N problem trees along a new leading
axis on the host, uploads each leaf once (`utils/host.to_device`) and runs
ONE batched program per stage: the per-frame localize + subwindow chain
(`batched_sub`) and the fused keyframe step (`batched_kf`, then the
chained marginalization `batched_marg`). The device-resident state that is
per sequence in the single-sequence pipeline (the subwindow chain states,
the marginalization priors) lives here as batched (N, ...) trees; per-row
updates are masked, so sequences on different branches (keyframe against
subframe tick) stay independent. A sequence that did not submit this tick
rides as a dummy copy of its last submission, and its rows come out
unchanged.

The JAX package vmaps whole programs, `lax.while_loop` included. Here the
programs are `models.builders`' with rows=True: each stage around the LM
solves under `torch.func.vmap`, the solves `estimation.ba.solve_ba_rows`
(one host sync per LM iteration for the whole batch). vmap's per-row
fallback (a Python loop over the rows, for an op without a batching rule)
is switched off while the programs run, so such an op raises instead of
quietly turning one batched dispatch into N.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, List, Optional

import numpy as np
import torch
from torch.func import vmap

from rd_vio_tpu_torch.estimation import factors as F
from rd_vio_tpu_torch.estimation.state import FrameStates
from rd_vio_tpu_torch.models import builders
from rd_vio_tpu_torch.utils.host import fetch, fetch_async
from rd_vio_tpu_torch.utils.metrics import GLOBAL_TIMER as T

# while CAPTURE_BATCH is set, the first batched keyframe flush keeps its
# inputs and outputs here (see BatchDispatcher._flush_kf), for a caller that
# replays it row by row or on another device
CAPTURE_BATCH = False
CAPTURED_BATCH = None


def _stack_trees(trees):
    """Stack same-structure NumPy trees (arrays, dicts, NamedTuples) along a
    new axis 0. Leaves whose leading lengths differ (the triangulation
    batch, padded per sequence to TRI_PAD, L or its count) are edge-padded
    to the longest; the padded rows are never read."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack_trees([t[k] for t in trees]) for k in first}
    if isinstance(first, tuple) and hasattr(first, "_fields"):
        return type(first)(*(_stack_trees(list(x)) for x in zip(*trees)))
    arrs = [np.asarray(t) for t in trees]
    if arrs[0].ndim and len({a.shape for a in arrs}) > 1:
        n = max(a.shape[0] for a in arrs)
        arrs = [np.pad(a, [(0, n - a.shape[0])] + [(0, 0)] * (a.ndim - 1), mode="edge")
                for a in arrs]
    return np.stack(arrs)


def _mask_rows(mask, new, old):
    """`new` (cast to old's dtype) on the rows where `mask`, else `old`."""
    return builders._rows_where(mask, new.to(old.dtype), old)


@contextlib.contextmanager
def strict_vmap():
    """vmap's per-row fallback off: an op without a batching rule raises."""
    prev = torch._C._functorch._is_vmap_fallback_enabled()
    torch._C._functorch._set_vmap_fallback_enabled(False)
    try:
        yield
    finally:
        torch._C._functorch._set_vmap_fallback_enabled(prev)


def batched_sub(pa_loc, pa_sub, j_slots, chain, lip, sp, active, calib, max_iterations):
    """N per-frame localize + subwindow chains as one batched program
    (JAX `_batched_sub_jit`). Returns the updated batched chain states
    (inactive rows keep theirs) and the transfer tuple apply_result_np
    consumes, with a leading sequence axis."""
    res = builders.fused_localize_subwindow_chain(
        pa_loc, pa_sub, j_slots, chain, lip, sp, calib, max_iterations, rows=True)
    new_chain = FrameStates(*(_mask_rows(active, n, o) for n, o in zip(res.states, chain)))
    s = res.states
    return new_chain, (s.q, s.p, s.v, s.bg, s.ba, res.inv_depth)


def batched_kf(a, priors, calib, max_iterations):
    """N fused keyframe steps as one batched program (JAX `_batched_kf_jit`).
    The marginalizations are the separate `batched_marg`, as in the
    single-sequence split: the host's fetch of these results never waits
    on them."""
    res, res_loc, valid_out, tri_ok, tri_invd = builders.fused_keyframe(
        a["pa_loc"], a["b"], a["qcw"], a["pcw"], a["m_tri"], a["us"],
        a["tri_aqc"], a["tri_apc"], a["pa_w"], a["j_w"], a["wlm_tri"],
        priors, a["va"], calib, max_iterations, rows=True)
    s, sl = res.states, res_loc.states
    transfer = (s.q, s.p, s.v, s.bg, s.ba, res.inv_depth,
                sl.q, sl.p, sl.v, sl.bg, sl.ba, valid_out, tri_ok, tri_invd)
    return res, res_loc, valid_out, tri_ok, tri_invd, transfer


def batched_marg(res_states, res_invd, valid_out, tri_ok, tri_invd, a, priors,
                 kf_mask, calib):
    """N chained slot-0 marginalizations (vmap of builders.marginalize_tail,
    JAX `_batched_marg_jit`); the batched prior tree changes only on the
    rows whose sequence keyframed this tick."""
    new = vmap(lambda s, iv, v, ok, ti, pa_m, vti, fw, mt, prior: builders.marginalize_tail(
        s, iv, v, ti, ok, pa_m, vti, fw, mt, prior, calib))(
            res_states, res_invd, valid_out, tri_ok, tri_invd, a["pa_m"],
            a["mlm_vti"], a["mlm_from_w"], a["mlm_tri"], priors)
    return F.PriorFactor(*(_mask_rows(kf_mask, n, o) for n, o in zip(new, priors)))


class _SharedFetch:
    """One batched device->host transfer shared by N RowFutures."""

    def __init__(self):
        self._af = None
        self._host = None
        self._lock = threading.Lock()

    def bind_async(self, af):
        self._af = af

    def bind_host(self, tree):
        self._host = tree

    def result(self):
        with self._lock:
            if self._host is None:
                if self._af is None:
                    raise RuntimeError(
                        "batched result consumed before the dispatcher flushed "
                        "its tick: call BatchDispatcher.flush()")
                self._host = self._af.wait()
            return self._host


class RowFuture:
    """Row view of a _SharedFetch: wait() gives this sequence's slice of the
    batched transfer (the tuple apply_result_np consumes)."""

    __slots__ = ("_shared", "_row")

    def __init__(self, shared: _SharedFetch, row: int):
        self._shared = shared
        self._row = row

    def wait(self):
        return tuple(a[self._row] for a in self._shared.result())


class BatchDispatcher:
    """Per-tick coalescer for N lockstep sequences (see the module docstring).

    Protocol per tick: each sequence's host pipeline calls submit_sub() or
    submit_kf() at most once, then the runtime calls flush() once. flush()
    runs at most three batched programs: the keyframe step, then its
    chained marginalization (which the host never waits on), then the
    subwindow chain. It fetches the keyframe results synchronously (their
    host application gates the next tick's host state), runs the
    registered keyframe continuations, and leaves the subwindow fetch
    asynchronous: its RowFutures resolve in the next tick's drain, as the
    single-sequence FIFO's fetches do."""

    def __init__(self, n: int, calib: builders.CalibArrays, max_iterations: int):
        self.n = n
        self.calib = calib
        self.max_iterations = int(max_iterations)
        self.device = torch.device(calib.device)
        # submissions may arrive from the runtime's host worker pool
        self._submit_lock = threading.Lock()
        # per-tick submissions
        self._sub: Dict[int, tuple] = {}
        self._kf: Dict[int, tuple] = {}
        self._kf_continuations: List = []
        # dummy-row caches (last submission per sequence)
        self._sub_cache: List[Optional[tuple]] = [None] * n
        self._kf_cache: List[Optional[dict]] = [None] * n
        # batched device state
        self._chain: Optional[FrameStates] = None  # (N, Wf, ...) states
        self._priors: Optional[F.PriorFactor] = None  # (N, ...) leaves
        self._prior_writes: Dict[int, F.PriorFactor] = {}  # row -> device prior
        # steady-state markers: batched keyframe flushes run, and the
        # sequences that ever submitted a batched keyframe step
        self.n_kf_flushes = 0
        self.ever_submitted = set()

    # -- prior rows (BatchSWT's transition and rare host paths) ------------
    def put_prior_row(self, i: int, prior: F.PriorFactor):
        """Queue sequence i's device prior for its row of the batched tree;
        written at the next flush (before the keyframe program) or read."""
        self._prior_writes[i] = prior

    def get_prior_row(self, i: int) -> Optional[F.PriorFactor]:
        """Sequence i's prior as a standalone device tree (a copy of its
        row), for the host paths that need one (double marginalization)."""
        self._apply_prior_writes()
        if self._priors is None:
            return None
        return F.PriorFactor(*(t[i].clone() for t in self._priors))

    def _apply_prior_writes(self):
        for i, prior in self._prior_writes.items():
            if self._priors is None:
                self._priors = F.PriorFactor(*(
                    torch.zeros((self.n,) + tuple(r.shape), dtype=r.dtype, device=r.device)
                    for r in prior))
            row = torch.arange(self.n, device=self.device) == i
            self._priors = F.PriorFactor(*(
                _mask_rows(row, r[None], t) for t, r in zip(self._priors, prior)))
        self._prior_writes.clear()

    # -- submissions -----------------------------------------------------------
    def submit_sub(self, i: int, pa_loc, pa_sub, j_slot: int, loc_ip_prev: int,
                   sub_prev: np.ndarray) -> RowFuture:
        shared = _SharedFetch()
        with self._submit_lock:
            self._sub[i] = (pa_loc, pa_sub, np.int32(j_slot), np.int32(loc_ip_prev),
                            np.asarray(sub_prev, np.int32), shared)
        return RowFuture(shared, i)

    def submit_kf(self, i: int, arrays: dict, continuation) -> RowFuture:
        shared = _SharedFetch()
        with self._submit_lock:
            self._kf[i] = (arrays, shared)
            self._kf_continuations.append(continuation)
        return RowFuture(shared, i)

    # -- the tick barrier --------------------------------------------------------
    def flush(self):
        with strict_vmap():
            if self._kf:
                with T.time("batch.kf"):
                    self._flush_kf()
            if self._sub:
                with T.time("batch.sub"):
                    self._flush_sub()

    def _flush_kf(self):
        global CAPTURED_BATCH
        self._apply_prior_writes()
        rows = []
        mask = np.zeros(self.n, bool)
        shareds = {}
        for i in range(self.n):
            if i in self._kf:
                arrays, shared = self._kf[i]
                self._kf_cache[i] = arrays
                shareds[i] = shared
                mask[i] = True
            else:
                arrays = self._kf_cache[i]
                if arrays is None:
                    # never keyframed yet: any live submission's arrays, as a
                    # well-conditioned dummy problem
                    arrays = next(iter(self._kf.values()))[0]
            rows.append(arrays)
        host_in = _stack_trees(rows)
        dev = self.device
        stacked = builders._up(host_in, dev)
        kf_mask = builders._up(mask, dev)
        ct = self.calib.tree
        priors_in = self._priors
        res, res_loc, valid_out, tri_ok, tri_invd, transfer = builders._count(
            "batched_kf", batched_kf, stacked, priors_in, ct, self.max_iterations)
        # the marginalizations chain as a second program the host never
        # waits on
        self._priors = builders._count(
            "batched_marg", batched_marg, res.states, res.inv_depth, valid_out, tri_ok,
            tri_invd, stacked, priors_in, kf_mask, ct)
        if CAPTURE_BATCH and CAPTURED_BATCH is None:
            CAPTURED_BATCH = {
                "arrays": host_in, "mask": mask, "priors": priors_in, "calib": ct,
                "max_iterations": self.max_iterations,
                "out": (res, res_loc, valid_out, tri_ok, tri_invd, self._priors)}
        # synchronous fetch: the keyframe results gate host bookkeeping
        # before the next tick's problems are assembled; one batched copy
        host = fetch(transfer)
        for shared in shareds.values():
            shared.bind_host(host)
        self.n_kf_flushes += 1
        self.ever_submitted.update(shareds)
        self._kf.clear()
        conts, self._kf_continuations = self._kf_continuations, []
        for c in conts:
            c()

    def _flush_sub(self):
        any_sub = next(iter(self._sub.values()))
        if self._chain is None:
            pa_sub = any_sub[1]
            Wf = pa_sub.q.shape[0]
            dt = torch.from_numpy(pa_sub.q[:0]).dtype
            q = torch.zeros((self.n, Wf, 4), dtype=dt, device=self.device)
            q[..., 0] = 1.0
            z = lambda: torch.zeros((self.n, Wf, 3), dtype=dt, device=self.device)  # noqa: E731
            self._chain = FrameStates(q=q, p=z(), v=z(), bg=z(), ba=z())
        pa_locs, pa_subs, j_slots, lips, sps = [], [], [], [], []
        mask = np.zeros(self.n, bool)
        shareds = {}
        for i in range(self.n):
            if i in self._sub:
                pa_loc, pa_sub, js, lip, sp, shared = self._sub[i]
                self._sub_cache[i] = (pa_loc, pa_sub, js)
                shareds[i] = shared
                mask[i] = True
            else:
                cached = self._sub_cache[i] or any_sub[:3]
                pa_loc, pa_sub, js = cached
                lip = np.int32(-1)
                sp = np.full(len(any_sub[4]), -1, np.int32)
            pa_locs.append(pa_loc)
            pa_subs.append(pa_sub)
            j_slots.append(js)
            lips.append(lip)
            sps.append(sp)
        dev = self.device
        up = lambda t: builders._up(t, dev)  # noqa: E731
        self._chain, transfer = builders._count(
            "batched_sub", batched_sub, up(_stack_trees(pa_locs)),
            up(_stack_trees(pa_subs)), up(np.stack(j_slots)), self._chain,
            up(np.stack(lips)), up(np.stack(sps)), up(mask),
            self.calib.tree, self.max_iterations)
        af = fetch_async(transfer)
        for shared in shareds.values():
            shared.bind_async(af)
        self._sub.clear()
