"""Distributed sliding-window BA: landmark blocks sharded across ranks, the
Schur reduction summed by all_reduce, the dense camera solve replicated.

Port of the JAX package's parallel/dist_ba.py. There one process drives a
device mesh under `shard_map` and every `psum` is a collective over the
mesh; here each shard is a process of its own (a rank of a
torch.distributed group, with a card of its own under NCCL, or several
ranks on one card or on the CPU under gloo) and every `psum` is an
`all_reduce(SUM)`. The design is the JAX package's: per-shard landmark-block
reduction -> one summed (W*15)^2 camera Hessian / gradient and Schur
correction -> dense Cholesky -> local landmark back-substitution.

Sharding layout (`relayout_for_sharding` guarantees it):
- reprojection factor arrays: sharded over the observation axis, with all
  observations of a landmark placed in the same shard;
- landmark arrays (inv_depth, opt_lm): sharded over L, indices shard-local;
- frame states, IMU factors, rotation priors, marginalization prior:
  replicated (the window is tiny).

Only rank 0 holds the problem (and, in the tracker, runs the pipeline): it
scatters each rank's shard (`shard_problem`), every rank runs
`solve_ba_sharded`, and rank 0 gathers the landmark shards back
(`gather_landmarks`). The other ranks wait in `serve` for the next problem
until rank 0 stops them (`solve_on_group` / `stop_serving`).

Every rank must take the same LM decisions, or one leaves the loop while the
others wait in a collective: rank 0 alone solves the camera system and
broadcasts its step, and the cost is summed by all_reduce (whose result is
the same on every rank), so the accept / stop flags derive from values that
are bit for bit equal on every rank. Every collective has the group's
finite timeout: a rank that dies or stops answering makes the others raise.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import socket
import subprocess
import sys
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.func import vmap
from torch.utils._pytree import tree_map

from rd_vio_tpu_torch.estimation import ba
from rd_vio_tpu_torch.estimation import factors as F
from rd_vio_tpu_torch.estimation.state import ES_SIZE, FrameStates, retract
from rd_vio_tpu_torch.utils.host import asnp, fetch, to_device

BACKENDS = ("nccl", "gloo")


@dataclasses.dataclass
class ShardGroup:
    """This process's place in the group (the counterpart of the JAX
    package's mesh). `stats` counts the collectives since the group was
    made (calls, bytes and ms of each kind); `last_solve` holds the last
    solve's iterations and its share of them (see `solve_ba_sharded`)."""

    rank: int
    world_size: int
    backend: str
    device: torch.device
    timeout_s: float
    stats: dict = dataclasses.field(default_factory=dict)
    last_solve: dict = dataclasses.field(default_factory=dict)
    _events: list = dataclasses.field(default_factory=list, repr=False)

    @property
    def staged(self) -> bool:
        """gloo with tensors on a card: every collective goes through host
        buffers (pinned), copied explicitly, so that one path serves all of
        them whichever of gloo's collectives take device tensors."""
        return self.backend == "gloo" and self.device.type == "cuda"


def make_group(rank: int, world_size: int, backend: str, init_method: str,
               device="cuda", timeout_s: float = 60.0) -> ShardGroup:
    """Join the default process group as `rank` of `world_size` and return
    its handle. The caller names the backend: "nccl" where each rank has a
    card of its own, "gloo" otherwise (several ranks on one card, or the
    CPU); there is no fallback from one to the other. `init_method` is
    e.g. "tcp://localhost:<port>"; `timeout_s` bounds every collective.
    One all_reduce runs before the return, so a group that cannot
    communicate fails here."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: one of {BACKENDS}")
    device = torch.device(device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
    elif backend == "nccl":
        raise ValueError("nccl needs a CUDA device")
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout_s))
    group = ShardGroup(rank, world_size, backend, device, timeout_s)
    probe = _all_reduce(group, torch.ones(1, device=device))
    if float(probe[0]) != world_size:
        raise RuntimeError(f"group probe summed to {float(probe[0])}, not {world_size}")
    return group


def close_group():
    """Leave the default process group (if this process is in one)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def local_init_method() -> str:
    """tcp://localhost:<a free port>, for a group whose ranks share a host."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return f"tcp://localhost:{s.getsockname()[1]}"


# ---------------------------------------------------------------------------
# collectives (staged through host buffers for gloo on a card) and their cost
# ---------------------------------------------------------------------------


def _host_copy(t: torch.Tensor) -> torch.Tensor:
    buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    buf.copy_(t)
    return buf


class _Timed:
    """Records one collective's bytes and time into group.stats: CUDA events
    on the current stream for NCCL (the collective runs on its own stream,
    which the current one waits on), the host's clock otherwise (gloo runs
    its collectives synchronously; on a card the stream is drained first,
    so the time is the staging and the collective, not earlier work)."""

    def __init__(self, group: ShardGroup, kind: str, nbytes: int):
        self.group, self.kind, self.nbytes = group, kind, nbytes

    def __enter__(self):
        g = self.group
        if g.backend == "nccl":
            self.ev = (torch.cuda.Event(enable_timing=True),
                       torch.cuda.Event(enable_timing=True))
            self.ev[0].record()
        else:
            if g.device.type == "cuda":
                torch.cuda.current_stream().synchronize()
            self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        g = self.group
        st = g.stats
        st[f"{self.kind}_calls"] = st.get(f"{self.kind}_calls", 0) + 1
        st[f"{self.kind}_bytes"] = st.get(f"{self.kind}_bytes", 0) + self.nbytes
        if g.backend == "nccl":
            self.ev[1].record()
            g._events.append(self.ev)
        else:
            st["collective_ms"] = st.get("collective_ms", 0.0) + 1e3 * (
                time.perf_counter() - self.t0)


def _collective_totals(group: ShardGroup) -> dict:
    """group.stats with NCCL's recorded events folded into collective_ms
    (waits for them)."""
    st = group.stats
    for a, b in group._events:
        b.synchronize()
        st["collective_ms"] = st.get("collective_ms", 0.0) + a.elapsed_time(b)
    group._events.clear()
    return dict(st)


def _all_reduce(group: ShardGroup, t: torch.Tensor) -> torch.Tensor:
    with _Timed(group, "all_reduce", t.numel() * t.element_size()):
        if group.staged:
            h = _host_copy(t)
            dist.all_reduce(h)
            return h.to(group.device, non_blocking=True)
        t = t.clone()
        dist.all_reduce(t)
        return t


def _broadcast(group: ShardGroup, t: torch.Tensor) -> torch.Tensor:
    """Rank 0's t on every rank (t's shape and dtype on every rank)."""
    with _Timed(group, "broadcast", t.numel() * t.element_size()):
        if group.staged:
            h = _host_copy(t)
            dist.broadcast(h, src=0)
            return h.to(group.device, non_blocking=True)
        t = t.clone()
        dist.broadcast(t, src=0)
        return t


def _command(group: ShardGroup, cmd=None):
    """Rank 0's command (a small picklable object) on every rank."""
    box = [cmd]
    dist.broadcast_object_list(box, src=0,
                               device=group.device if group.backend == "nccl" else None)
    return box[0]


# ---------------------------------------------------------------------------
# layout and distribution
# ---------------------------------------------------------------------------


def relayout_for_sharding(invd, pb: ba.BAProblem, n_shards: int):
    """Host-side re-layout so shard k owns landmark slots [k*L/n, (k+1)*L/n)
    and exactly the observation rows referencing them (padded per shard).

    Returns (invd, pb, new_slot) with permuted landmark slots and observation
    rows, on the input's device (invd in its dtype); new_slot[old_slot]
    gives the relocated landmark slot so callers can map results back. The
    JAX package's function, step for step: the same new_slot and row order.
    """
    dev = invd.device
    L = int(invd.shape[0])
    O = int(pb.reproj.tgt.shape[0])
    assert L % n_shards == 0 and O % n_shards == 0
    L_loc, O_loc = L // n_shards, O // n_shards

    lm = asnp(pb.reproj.lm)
    valid = asnp(pb.reproj.valid)
    opt_lm = asnp(pb.opt_lm)
    invd_h = asnp(invd)

    # observation count per landmark (vectorized: this runs per solve when a
    # group is set, so no per-observation Python loops)
    counts = np.bincount(lm[valid], minlength=L)
    active = np.flatnonzero(counts > 0)
    order = active[np.argsort(-counts[active], kind="stable")]

    # greedy balanced assignment, biggest landmarks first (loop over <=L
    # active landmarks only; each step picks the least-loaded feasible shard)
    shard_of_lm = np.full(L, -1, np.int64)
    shard_obs = np.zeros(n_shards, np.int64)
    shard_nlm = np.zeros(n_shards, np.int64)
    for l in order:
        c = counts[l]
        feasible = (shard_nlm < L_loc) & (shard_obs + c <= O_loc)
        k = int(np.argmin(np.where(feasible, shard_obs, np.iinfo(np.int64).max)))
        shard_of_lm[l] = k
        shard_obs[k] += c
        shard_nlm[k] += 1

    # landmark permutation: new slot = shard*L_loc + position-within-shard;
    # inactive landmark slots fill the remaining positions in order
    new_slot = np.full(L, -1, np.int64)
    by_shard = np.argsort(shard_of_lm[order], kind="stable")
    placed = order[by_shard]  # active lms grouped by shard
    sh = shard_of_lm[placed]
    pos_in_shard = np.arange(len(placed)) - np.searchsorted(sh, sh)
    new_slot[placed] = sh * L_loc + pos_in_shard
    taken = np.zeros(L, bool)
    taken[new_slot[placed]] = True
    inactive = np.flatnonzero(shard_of_lm < 0)
    new_slot[inactive] = np.flatnonzero(~taken)[: len(inactive)]

    invd_new = np.ones(L, invd_h.dtype)
    opt_new = np.zeros(L, bool)
    invd_new[new_slot] = invd_h
    opt_new[new_slot] = opt_lm

    # observation rows: each shard's rows contiguous from shard*O_loc
    vrows = np.flatnonzero(valid)
    rsh = shard_of_lm[lm[vrows]]
    r_order = np.argsort(rsh, kind="stable")
    vrows = vrows[r_order]
    rsh = rsh[r_order]
    rpos = np.arange(len(vrows)) - np.searchsorted(rsh, rsh)
    dest = rsh * O_loc + rpos
    perm_rows = np.zeros(O, dtype=np.int64)
    row_valid = np.zeros(O, bool)
    perm_rows[dest] = vrows
    row_valid[dest] = True

    def take(a):
        return asnp(a)[perm_rows]

    up = lambda a: to_device(a, dev)  # noqa: E731
    rf = pb.reproj
    reproj = rf._replace(
        tgt=up(take(rf.tgt)), ref=up(take(rf.ref)),
        lm=up(new_slot[take(rf.lm)].astype(np.int32)),
        z_ref=up(take(rf.z_ref)), z_tgt=up(take(rf.z_tgt)),
        valid=up(row_valid & take(rf.valid)),
    )
    return up(invd_new), pb._replace(reproj=reproj, opt_lm=up(opt_new)), new_slot


def shard_problem(group: ShardGroup, states: Optional[FrameStates] = None,
                  invd=None, pb: Optional[ba.BAProblem] = None):
    """Scatter the relaid problem from rank 0 (which passes it; the others
    pass nothing): rank k receives observation rows [k*O/n, (k+1)*O/n) and
    landmark slots [k*L/n, (k+1)*L/n), and every rank the replicated parts
    (states, IMU and rotation factors, the prior, the extrinsics, the pose
    and motion masks). Returns (states, invd_local, pb_local) on this rank's
    device; landmark indices stay global (solve_ba_sharded localizes them)."""
    n = group.world_size
    payloads = None
    if group.rank == 0:
        states_h, invd_h, pb_h = fetch((states, invd, pb))
        O_loc = pb_h.reproj.tgt.shape[0] // n
        L_loc = invd_h.shape[0] // n
        payloads = []
        for k in range(n):
            o = slice(k * O_loc, (k + 1) * O_loc)
            lk = slice(k * L_loc, (k + 1) * L_loc)
            rf = type(pb_h.reproj)(*(a[o] for a in pb_h.reproj))
            payloads.append((states_h, invd_h[lk],
                             pb_h._replace(reproj=rf, opt_lm=pb_h.opt_lm[lk])))
    out = [None]
    with _Timed(group, "scatter", 0):
        dist.scatter_object_list(out, payloads, src=0)
    return tree_map(lambda a: to_device(a, group.device), out[0])


def gather_landmarks(group: ShardGroup, invd_local: torch.Tensor):
    """Every rank's landmark shard, concatenated in rank order on rank 0
    (None elsewhere), beside the LM iterations each rank ran (a (n,) int64
    array on rank 0)."""
    its = float(group.last_solve.get("iterations", -1))
    t = torch.cat([invd_local.to(torch.float64),
                   torch.full((1,), its, dtype=torch.float64, device=invd_local.device)])
    src = _host_copy(t) if group.staged else t
    parts = [torch.empty_like(src) for _ in range(group.world_size)] \
        if group.rank == 0 else None
    with _Timed(group, "gather", src.numel() * src.element_size()):
        dist.gather(src, parts, dst=0)
    if group.rank != 0:
        return None, None
    full = torch.cat([p[:-1] for p in parts]).to(group.device, invd_local.dtype)
    return full, np.array([int(p[-1]) for p in parts], np.int64)


# ---------------------------------------------------------------------------
# the sharded solve
# ---------------------------------------------------------------------------


def _novis_problem(pb_local):
    """Replicated-rows-only view of the problem: the reprojection arrays are
    collapsed to a 2-row masked dummy. Passing the full local arrays with
    valid=False would still LINEARIZE every vision row a second time per
    iteration — in the JAX package, measured as ~half the per-device
    operations."""
    rf = pb_local.reproj
    dummy = type(rf)(
        tgt=rf.tgt[:2], ref=rf.ref[:2], lm=rf.lm[:2] * 0,
        z_ref=rf.z_ref[:2], z_tgt=rf.z_tgt[:2],
        valid=torch.zeros((2,), dtype=torch.bool, device=rf.valid.device),
    )
    return pb_local._replace(reproj=dummy)


def _local_vision_system(states, invd_local, pb_local, L_local):
    """Shard-local vision rows -> (Hv, gv, Hll, Hcl, bl, cost_v); landmark
    indices in pb_local.reproj.lm are shard-local."""
    W = states.q.shape[0]
    D = W * ES_SIZE
    dtype = states.q.dtype
    r_v, Jc_v, Jl_v = ba.linearize_reprojection(states, invd_local, pb_local)
    s_v = torch.sum(r_v * r_v, dim=-1)
    valid = pb_local.reproj.valid
    cost_v = torch.sum(torch.where(valid, torch.log1p(s_v), 0.0))
    w_v = torch.where(valid, 1.0 / (1.0 + s_v), 0.0)
    sw = torch.sqrt(w_v)[:, None]
    lm = pb_local.reproj.lm.long()
    Jl_v = Jl_v * pb_local.opt_lm[lm].to(dtype)[:, None]
    rv = (r_v * sw).reshape(-1)
    Jv = (Jc_v * sw[..., None]).reshape(-1, D)
    Jlv = (Jl_v * sw).reshape(-1)
    rows = lm[:, None].expand(-1, 2).reshape(-1)  # jnp.repeat(lm, 2)
    Hv = Jv.mT @ Jv
    gv = Jv.mT @ rv
    Hll = ba.segment_sum(Jlv * Jlv, rows, L_local)
    bl = ba.segment_sum(Jlv * rv, rows, L_local)
    Hcl = ba.segment_sum(Jlv[:, None] * Jv, rows, L_local)
    return Hv, gv, Hll, Hcl, bl, cost_v


def _local_vision_cost(s, idl, pb_local):
    rf = pb_local.reproj
    tgt, ref = rf.tgt.long(), rf.ref.long()
    r_v = vmap(lambda a, b, c, d, e, f, g: F.reprojection_residual(
        a, b, c, d, e, f, g, pb_local.ext, pb_local.sqrt_inv_cov2))(
        s.q[tgt], s.p[tgt], s.q[ref], s.p[ref],
        torch.clamp(idl[rf.lm.long()], min=1e-12), rf.z_ref, rf.z_tgt)
    s_v = torch.sum(r_v * r_v, dim=-1)
    return torch.sum(torch.where(rf.valid, torch.log1p(s_v), 0.0))


def solve_ba_sharded(states: FrameStates, invd_local, pb_local: ba.BAProblem,
                     group: ShardGroup, max_iterations: int = 10):
    """LM solve with the vision/landmark work sharded over the group; every
    rank calls it with its shard (from `shard_problem`).

    Returns (states, invd_local, cost), as the JAX package's: numerically
    equivalent to ba.solve_ba up to reduction order. Per LM iteration: one
    packed all_reduce of the camera Hessian, gradient and Schur corrections,
    one broadcast of rank 0's camera step, one all_reduce of the cost, and
    one host sync (the stop flag). group.last_solve then holds the
    iterations, the accepted steps and the calls, bytes and ms of the
    solve's collectives."""
    W = states.q.shape[0]
    D = W * ES_SIZE
    dtype = states.q.dtype
    dev = states.q.device
    root = group.rank == 0
    L_local = invd_local.shape[0]
    before = _collective_totals(group)
    # landmark indices arrive global; each rank owns a contiguous chunk, so
    # the local slot is simply (global mod L_local)
    pb_local = pb_local._replace(
        reproj=pb_local.reproj._replace(lm=pb_local.reproj.lm % L_local))
    cmask = ba._col_mask(pb_local, W, dtype)
    cmask2 = cmask[:, None] * cmask[None, :]
    novis = _novis_problem(pb_local)
    opt_lm = pb_local.opt_lm.to(dtype)
    zero = torch.zeros((), dtype=dtype, device=dev)

    def eval_cost(s, idl):
        # the replicated parts: rank 0's single-device cost of the collapsed
        # no-vision problem (2 dummy reproj rows, not O/n masked rows), summed
        # with the shards' vision costs in the same all_reduce
        c_rest = ba.compute_cost(s, idl, novis) * 2.0 if root else zero  # 0.5 undone below
        c = _all_reduce(group, torch.stack([_local_vision_cost(s, idl, pb_local), c_rest]))
        return 0.5 * c[0] + 0.5 * c[1]

    fi = torch.finfo(dtype)
    s, idl = states, invd_local
    cost = eval_cost(s, idl)
    lam = torch.full((), 1e-4, dtype=dtype, device=dev)
    n_acc = torch.zeros((), dtype=torch.int32, device=dev)
    it = 0
    while it < max_iterations:
        # shard-local vision normal equations, masked columns
        Hv, gv, Hll, Hcl, bl, _ = _local_vision_system(s, idl, pb_local, L_local)
        Hv = Hv * cmask2
        gv = gv * cmask
        Hcl = Hcl * cmask[None, :]
        # damped Schur: local landmark reduction; its camera correction is
        # known before any sum, so it goes out with H and g in one all_reduce
        Hll_d = Hll * (1.0 + lam) + 1e-12
        lm_on = pb_local.opt_lm & (Hll > 1e-12)
        inv_Hll = torch.where(lm_on, 1.0 / Hll_d, 0.0)
        corrH = Hcl.mT @ (Hcl * inv_Hll[:, None])
        corrg = Hcl.mT @ (bl * inv_Hll)
        summed = _all_reduce(group, torch.cat(
            [Hv.reshape(-1), gv, corrH.reshape(-1), corrg]))
        if root:
            Hv_s, gv_s = summed[: D * D].reshape(D, D), summed[D * D: D * D + D]
            corrH_s = summed[D * D + D: 2 * D * D + D].reshape(D, D)
            corrg_s = summed[2 * D * D + D:]
            # replicated rows (imu + rot + prior): collapsed no-vision problem
            # — a masked full-size problem would re-linearize all O/n vision
            # rows here
            H_r, g_r, _, _, _, _ = ba.build_normal_system(s, idl, novis)
            H = Hv_s + H_r
            g = gv_s + g_r
            Hd = H + lam * torch.diag(torch.diagonal(H)) + 1e-12 * torch.eye(
                D, dtype=dtype, device=dev)
            Hred = Hd - corrH_s
            gred = g - corrg_s
            Hred = Hred * cmask2 + torch.diag(1.0 - cmask)
            gred = gred * cmask
            # as ba.solve_normal_system: symmetrized input, no sync, a zero
            # step where the factorization fails
            Lc, info = torch.linalg.cholesky_ex(0.5 * (Hred + Hred.mT))
            y = torch.linalg.solve_triangular(Lc, -gred[:, None], upper=False)
            dc = torch.linalg.solve_triangular(Lc.mT, y, upper=True)[:, 0]
            dc = torch.where(torch.isfinite(dc) & (info == 0), dc, 0.0) * cmask
        else:
            dc = torch.empty(D, dtype=dtype, device=dev)
        dc = _broadcast(group, dc)
        dl = -(bl + Hcl @ dc) * inv_Hll  # local landmarks

        s_new = retract(s, dc.reshape(W, ES_SIZE))
        idl_new = idl + dl * opt_lm
        cost_new = eval_cost(s_new, idl_new)
        accept = (cost_new < cost) & torch.isfinite(cost_new)
        # the JAX package's early-termination tests (Ceres defaults:
        # function_tolerance 1e-6 on an accepted step's relative decrease,
        # parameter_tolerance 1e-8 on the step size); the cost is all-reduced
        # and dc broadcast, so every rank takes the same decision
        rel_decrease = (cost - cost_new) / torch.clamp(cost, min=fi.tiny)
        step_small = torch.max(torch.abs(dc)) < 1e-8
        done = (accept & (rel_decrease < 1e-6)) | step_small
        s = FrameStates(*(torch.where(accept, b, a) for a, b in zip(s, s_new)))
        idl = torch.where(accept, idl_new, idl)
        cost = torch.where(accept, cost_new, cost)
        lam = torch.where(accept, torch.clamp(lam / 3.0, min=1e-9),
                          torch.clamp(lam * 4.0, max=1e8))
        n_acc = n_acc + accept.to(torch.int32)
        it += 1
        if bool(done):  # the loop's one host sync per iteration
            break
    after = _collective_totals(group)
    group.last_solve = {k: after[k] - before.get(k, 0) for k in after}
    group.last_solve.update(iterations=it, accepted=int(n_acc))
    return s, idl, cost


# ---------------------------------------------------------------------------
# rank 0 and the serving ranks
# ---------------------------------------------------------------------------


def solve_on_group(group: ShardGroup, states: FrameStates, invd, pb: ba.BAProblem,
                   max_iterations: int = 10):
    """Rank 0: solve the relaid problem (from relayout_for_sharding) with
    every rank of the group. Returns (states, invd, cost), invd over all L
    slots of the relaid layout; group.last_solve["rank_iterations"] holds
    the LM iterations of each rank (equal by construction; checked here)."""
    assert group.rank == 0
    _command(group, ("solve", int(max_iterations)))
    st, idl, pbl = shard_problem(group, states, invd, pb)
    s, idl, cost = solve_ba_sharded(st, idl, pbl, group, max_iterations)
    invd_full, its = gather_landmarks(group, idl)
    group.last_solve["rank_iterations"] = its.tolist()
    if (its != its[0]).any():
        raise RuntimeError(f"ranks ran different LM iterations: {its.tolist()}")
    return s, invd_full, cost


def serve(group: ShardGroup) -> int:
    """Ranks other than 0: join every solve rank 0 starts, until it stops
    the group. Returns the count of solves joined."""
    assert group.rank != 0
    n = 0
    while True:
        cmd = _command(group)
        if cmd[0] == "stop":
            return n
        st, idl, pbl = shard_problem(group)
        _, idl, _ = solve_ba_sharded(st, idl, pbl, group, cmd[1])
        gather_landmarks(group, idl)
        n += 1


def stop_serving(group: ShardGroup):
    """Rank 0: end the other ranks' `serve` loops."""
    assert group.rank == 0
    _command(group, ("stop",))


class RankProcesses:
    """Ranks 1..world_size-1, each a process of its own that joins the group
    and serves (`python -m rd_vio_tpu_torch.parallel.dist_ba`); the caller is
    rank 0. `threads` sets each process's torch intra-op threads."""

    def __init__(self, world_size: int, backend: str, init_method: str, device="cuda",
                 timeout_s: float = 60.0, threads: Optional[int] = None):
        root = Path(__file__).resolve().parents[2]
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join([str(root)] + [
            p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
        extra = ["--threads", str(threads)] if threads else []
        self.procs = [
            subprocess.Popen(
                [sys.executable, "-m", "rd_vio_tpu_torch.parallel.dist_ba", str(r),
                 str(world_size), backend, init_method, "--device", str(device),
                 "--timeout", str(timeout_s)] + extra,
                cwd=root, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)
            for r in range(1, world_size)]

    def wait(self, timeout_s: float):
        """Each process's (exit code, output); a process still running after
        `timeout_s` (in all) is killed and reports its kill."""
        end = time.perf_counter() + timeout_s
        out = []
        for p in self.procs:
            try:
                text, _ = p.communicate(timeout=max(end - time.perf_counter(), 0.1))
            except subprocess.TimeoutExpired:
                p.kill()
                text, _ = p.communicate()
            out.append((p.returncode, text))
        return out


def main(argv=None) -> int:
    """A serving rank: `python -m rd_vio_tpu_torch.parallel.dist_ba RANK
    WORLD_SIZE BACKEND INIT_METHOD [--device D] [--timeout S] [--threads N]`
    joins the group and joins rank 0's solves until rank 0 stops it."""
    import argparse

    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("rank", type=int)
    ap.add_argument("world_size", type=int)
    ap.add_argument("backend", choices=BACKENDS)
    ap.add_argument("init_method")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--timeout", type=float, default=60.0)
    ap.add_argument("--threads", type=int, default=0)
    a = ap.parse_args(argv)
    if a.threads:
        torch.set_num_threads(a.threads)
    group = make_group(a.rank, a.world_size, a.backend, a.init_method,
                       device=a.device, timeout_s=a.timeout)
    try:
        n = serve(group)
    finally:
        close_group()
    print(f"rank {a.rank}: {n} solves joined", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
