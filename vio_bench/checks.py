"""The comparison that decides `correct`, over what the timed path produced
in the window (vio_bench.capture samples it, with the run's seed):

- solves: each row of each sampled batched LM solve, judged by the plain
  reference (vio_bench.reference.solve) in float64 on the same problem.
  `solve_cost0_gap` is the widest gap between the program's cost at its
  starting states and the reference's, over (the reference's + 1): both
  must read the same problem. `solve_shortfall` is the widest share of
  the decrease a solve had to make that it left undone: the excess of
  the cost at the states the program returned over the minimum the
  reference reaches from them, over the starting cost's excess over that
  minimum (at least 1% of the minimum). A solve that returns its start,
  leaves rows out or moves states off reads near 1 or above; one that
  stops a few per mille short of the minimum after a descent by 100x, as
  the program's keyframe solves sometimes do, reads a few 1e-4.
- marginalizations: each keyframing row of each sampled batched
  marginalization, the prior it returned against the reference's
  (vio_bench.reference.marg) in float64, from the solved states and the
  factors the program marginalized (`marg_prior_gap`).
- preintegration: each preintegration factor and prior of each sampled
  problem assembly against the reference's integration
  (vio_bench.reference.preint) of the generator's own IMU samples between
  the two frames' times, at the factor's bias point (`preint_gap`).
- trajectory: `unpublished_frames`, the sequence-frames of the window
  whose pose never came.

Each `*_rows` function also gives the control's readings (`control=True`):
the reference itself put in the program's place, in the precision below
the one the configuration states, judged by the same numbers.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from vio_bench.capture import as_plain
from vio_bench.reference import marg as ref_marg
from vio_bench.reference import preint as ref_preint
from vio_bench.reference import solve as ref

F64 = torch.float64


def _row(tree, r, dtype, device):
    if isinstance(tree, dict):
        return {k: _row(v, r, dtype, device) for k, v in tree.items()}
    t = tree[r].to(device)
    return t.to(dtype) if t.is_floating_point() else t


def _cast(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    return tree.to(dtype) if tree.is_floating_point() else tree


# --------------------------------------------------------------------------
# solves
# --------------------------------------------------------------------------


def solve_rows(rec, control: bool = False) -> List[dict]:
    """Each row of one sampled solve, judged by the reference in float64:
    the cost at the program's starting states against the program's own
    initial cost (`cost0_gap`), and the cost at the states the program
    returned against the minimum the reference reaches from them
    (`shortfall`; `cost_gap` the same excess over the minimum). The
    control solves each row again by the reference in
    float32 with TF32 matrix products (the precision below the float32
    with TF32 off that the configuration states), from the same starting
    states."""
    st, pb = as_plain(rec["states"]), as_plain(rec["pb"])
    res = rec["result"]
    device = rec["inv_depth"].device
    prev = torch.backends.cuda.matmul.allow_tf32
    rows = []
    try:
        for r in range(rec["inv_depth"].shape[0]):
            pb_r = _row(pb, r, F64, device)
            c0 = float(ref.cost(_row(st, r, F64, device),
                                _row(rec["inv_depth"], r, F64, device), pb_r))
            if control:
                torch.backends.cuda.matmul.allow_tf32 = True
                low = ref.solve(_row(st, r, torch.float32, device),
                                _row(rec["inv_depth"], r, torch.float32, device),
                                _row(pb, r, torch.float32, device))
                torch.backends.cuda.matmul.allow_tf32 = prev
                out_states, out_invd = _cast(low.states, F64), low.inv_depth.double()
                initial, its = low.initial_cost, low.iterations
            else:
                out_states = _row(as_plain(res.states), r, F64, device)
                out_invd = _row(res.inv_depth, r, F64, device)
                initial, its = float(res.initial_cost[r]), int(res.iterations[r])
            c_out = float(ref.cost(out_states, out_invd, pb_r))
            sol = ref.solve(out_states, out_invd, pb_r)
            rows.append({
                "program": rec["program"], "row": r,
                "shortfall": (c_out - sol.cost) / max(c0 - sol.cost, 0.01 * max(sol.cost, 1.0)),
                "cost_gap": (c_out - sol.cost) / max(sol.cost, 1.0),
                "cost0_gap": abs(initial - c0) / (c0 + 1.0),
                "initial_cost": c0, "cost": c_out, "minimum": sol.cost,
                "iterations": its, "max_iterations": rec["max_iterations"],
            })
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    return rows


# --------------------------------------------------------------------------
# marginalizations
# --------------------------------------------------------------------------


def _marg_problem(rec, r, dtype, device):
    """Row r's marginalization problem for the reference: the factors of
    the assembled marginalization problem, at the solved window's states,
    each landmark at its solved (else freshly triangulated, else
    assembled) inverse depth, its observations counted only where the
    landmark was validated with a positive depth, and the prior the
    keyframe step solved with."""
    pa = _row(as_plain(rec["pa_m"]), r, F64, device)
    invd_w = _row(rec["inv_depth"], r, F64, device)
    tri = _row(rec["tri_invd"], r, F64, device)
    valid_out = _row(rec["valid_out"], r, F64, device)
    from_w, vti, mtri = (_row(rec[k], r, F64, device).long()
                         for k in ("mlm_from_w", "mlm_vti", "mlm_tri"))
    invd = pa["invd"]
    invd = torch.where(mtri >= 0, tri[mtri.clamp(min=0)], invd)
    invd = torch.where(from_w >= 0, invd_w[from_w.clamp(min=0)], invd)
    lm_ok = (vti >= 0) & valid_out[vti.clamp(min=0)].bool() & (invd > 0)
    d = pa["fi_delta"]
    eye = torch.eye(15, dtype=F64, device=device)
    calib = as_plain(rec["calib"])
    pb = {
        "reproj": {"tgt": pa["o_tgt"], "ref": pa["o_ref"], "lm": pa["o_lm"], "z_ref": pa["o_zr"],
                   "z_tgt": pa["o_zt"], "valid": pa["o_val"].bool() & lm_ok[pa["o_lm"].long()]},
        "imu": {"i": pa["fi_i"], "j": pa["fi_j"],
                "delta": {k: v for k, v in d.items() if k != "sqrt_inv_cov"},
                "sqrt_inv_cov": torch.where(pa["fi_val"].bool()[:, None, None],
                                            d["sqrt_inv_cov"], eye),
                "bg0": pa["fi_bg0"], "ba0": pa["fi_ba0"], "valid": pa["fi_val"].bool()},
        "prior": _row(as_plain(rec["priors"]), r, F64, device),
        "ext": _cast({k: v.to(device) for k, v in calib["ext"].items()}, F64),
        "sqrt_inv_cov2": calib["sqrt_inv_cov2"].to(device, F64),
    }
    states = _row(as_plain(rec["states"]), r, F64, device)
    return _cast(states, dtype), invd.to(dtype), _cast(pb, dtype)


def marg_rows(rec, control: bool = False) -> List[dict]:
    """Each keyframing row of one sampled marginalization: the prior the
    program returned against the reference's marginalization in float64
    (`gap`, vio_bench.reference.marg.gap, with the error of the prior's
    linearization point). The control marginalizes by the reference in
    float32 (the marginalization is float64 in the configuration)."""
    device = rec["inv_depth"].device
    rows = []
    mask = rec["kf_mask"].bool().cpu()
    for r in np.flatnonzero(mask.numpy()):
        states, invd, pb = _marg_problem(rec, int(r), F64, device)
        H, b = ref_marg.marginalize(states, invd, pb)
        if control:
            Hp, bp = ref_marg.marginalize(*_marg_problem(rec, int(r), torch.float32, device))
            lin = 0.0
        else:
            out = _row(as_plain(rec["out"]), int(r), F64, device)
            S, iv = out["sqrt_inv_cov"], out["infovec"]
            Hp, bp = S.T @ S, S.T @ iv
            lin = max(float((out[f"{k}_lin"][:-1] - states[k][1:]).abs().max())
                      for k in ("q", "p", "v", "bg", "ba"))
        rows.append({"row": int(r), "gap": max(ref_marg.gap(Hp, bp, H, b), lin),
                     "lin_gap": lin})
    return rows


# --------------------------------------------------------------------------
# preintegration
# --------------------------------------------------------------------------


def _sequence(f, seqs):
    """The sequence whose IMU samples the factor integrated: every gyro
    sample it read is one of that sequence's over the factor's interval.
    None where no sequence's are."""
    got = {tuple(w) for w in f["w"]}
    for i, s in enumerate(seqs):
        _, _, (lo, hi) = ref_preint.segments(s.t_imu, f["t_i"], f["t_j"])
        if got <= {tuple(w) for w in s.gyro[lo:hi + 1]}:
            return i
    return None


def noise(config: dict) -> Dict[str, np.ndarray]:
    """The IMU noise covariances the configuration gives the program."""
    st = config["settings"]
    return {k: np.asarray(st[name], float) for k, name in (
        ("cov_w", "gyroscope_noise_cov"), ("cov_a", "accelerometer_noise_cov"),
        ("cov_bg", "gyroscope_bias_noise_cov"), ("cov_ba", "accelerometer_bias_noise_cov"))}


def preint_rows(rec, seqs, cov: Dict[str, np.ndarray], control: bool = False) -> List[dict]:
    """Each preintegration factor of one sampled assembly against the
    reference's integration in float64 of its sequence's samples over the
    factor's interval (`gap`: the largest of vio_bench.reference.preint
    .gap's numbers). A factor whose samples are no sequence's reads None.
    The control integrates by the reference in float32 (the program's
    preintegration is float64)."""
    rows = []
    for f in rec["factors"]:
        i = _sequence(f, seqs)
        if i is None:
            rows.append({"gap": None, "t_i": f["t_i"], "t_j": f["t_j"]})
            continue
        s = seqs[i]
        dt, idx, _ = ref_preint.segments(s.t_imu, f["t_i"], f["t_j"])

        def integrate(dtype):
            T = lambda x: torch.as_tensor(np.asarray(x, float), dtype=dtype)  # noqa: E731
            return ref_preint.integrate(T(dt), T(s.gyro[idx]), T(s.accel[idx]), T(f["bg"]),
                                        T(f["ba"]), *(T(cov[k]) for k in
                                                      ("cov_w", "cov_a", "cov_bg", "cov_ba")))

        ref_d = integrate(F64)
        prog = integrate(torch.float32) if control else f["delta"]
        g = ref_preint.gap(prog, ref_d)
        rows.append({"gap": max(g.values()), **g, "sequence": i, "t_i": f["t_i"],
                     "t_j": f["t_j"], "samples": len(dt)})
    return rows


# --------------------------------------------------------------------------
# trajectory
# --------------------------------------------------------------------------


def unpublished_frames(published, seqs, window_frames) -> int:
    """The sequence-frames of the window whose pose never came."""
    missing = 0
    for pubs, seq in zip(published, seqs):
        have = {round(t, 6) for t, _, _ in pubs}
        missing += sum(round(float(seq.t_frame[k]), 6) not in have for k in window_frames)
    return missing


def numbers(samples, published, seqs, window_frames, config, control=False) -> dict:
    """Every number compared, and how many readings each stands on. A
    number with nothing to read is None (and fails)."""
    out = {"unpublished_frames": unpublished_frames(published, seqs, window_frames)}
    rows = {"solve": [], "marg": [], "preint": []}
    for kind in ("sub", "kf"):
        for rec in samples.get(kind, []):
            rows["solve"] += solve_rows(rec, control)
    for rec in samples.get("marg", []):
        rows["marg"] += marg_rows(rec, control)
    cov = noise(config)
    for rec in samples.get("preint", []):
        rows["preint"] += preint_rows(rec, seqs, cov, control)

    def worst(rs, key):
        vals = [r[key] for r in rs]
        return None if not vals or any(v is None for v in vals) else max(vals)

    out["solve_shortfall"] = worst(rows["solve"], "shortfall")
    out["solve_cost0_gap"] = worst(rows["solve"], "cost0_gap")
    out["marg_prior_gap"] = worst(rows["marg"], "gap")
    out["preint_gap"] = worst(rows["preint"], "gap")
    out["compared"] = {k: len(v) for k, v in rows.items()}
    return out, rows
