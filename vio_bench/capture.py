"""What the benchmark records of the timed path for the comparison with the
reference, by wrapping the program's own entry points while the window
runs: a seeded sample of the batched LM solves (their problems, starting
states and results), of the batched marginalizations (their inputs and
the priors they return) and of the host's problem assemblies (each
preintegration factor's frame times, bias point and delta). The wrapped
call is the program's, unchanged; its inputs and outputs are held by
reference (the programs make new tensors and never write the old ones),
so the window pays for a few list appends.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, List

import numpy as np

_tls = threading.local()


def as_plain(tree):
    """NamedTuples and dicts of tensors -> nested dicts (for the
    reference, which knows no program type)."""
    if hasattr(tree, "_asdict"):
        return {k: as_plain(v) for k, v in tree._asdict().items()}
    if isinstance(tree, dict):
        return {k: as_plain(v) for k, v in tree.items()}
    return tree


class Sampler:
    """Reservoir samples, drawn with `rng`, of what the window offers:
    `keep[kind]` records of each kind ("sub": the per-frame localize and
    subwindow chain's solves; "kf": the keyframe step's; "marg": the
    batched marginalizations; "preint": the problem assemblies). Offered
    from the host's worker threads too."""

    def __init__(self, rng: np.random.Generator, keep: Dict[str, int]):
        self.rng = rng
        self.keep = dict(keep)
        self.seen = {k: 0 for k in keep}
        self.samples: Dict[str, List[dict]] = {k: [] for k in keep}
        self.on = False
        self._lock = threading.Lock()

    def offer(self, kind, rec):
        if not self.on or kind not in self.keep:
            return
        with self._lock:
            self.seen[kind] += 1
            n = self.seen[kind]
            bucket = self.samples[kind]
            if len(bucket) < self.keep[kind]:
                bucket.append(rec)
            else:
                j = int(self.rng.integers(0, n))
                if j < self.keep[kind]:
                    bucket[j] = rec


@contextlib.contextmanager
def program_label(name):
    prev = getattr(_tls, "program", None)
    _tls.program = name
    try:
        yield
    finally:
        _tls.program = prev


def _imu_rows(spec, caps):
    """The preintegration factors and priors an assembly writes, in its
    row order: (frame i, frame j, samples, bias point)."""
    ids = {f.id for f in spec.frames[:caps.W]}
    fi = [(e[0], e[1], e[2], e[3], e[4]) for e in spec.imu
          if e[0].id in ids and e[1].id in ids][:caps.Fi]
    ip = [(e[0], e[1], e[2], e[0].bg, e[0].ba) for e in spec.imu_prior
          if e[1].id in ids][:caps.Fp]
    return fi, ip


def _rows(delta: dict, n: int):
    return [{k: np.array(v[r]) for k, v in delta.items()} for r in range(n)]


def install(vio, sampler: Sampler, faults: dict = None):
    """Wrap the program's batched solve, its batched programs and its
    problem assembly; returns a function that takes the wrappers out.
    `faults` (the tests' planted faults, in the window only): "solve"
    replaces a batched solve's result, "marg" a batched marginalization's
    priors, "preint" an assembly's problem arrays, each where it is
    produced."""
    from rd_vio_tpu_torch.batch import dispatcher
    from rd_vio_tpu_torch.estimation import ba
    from rd_vio_tpu_torch.models import builders

    faults = faults or {}
    orig_rows = ba.solve_ba_rows
    orig_kf, orig_sub, orig_marg = (dispatcher.batched_kf, dispatcher.batched_sub,
                                    dispatcher.batched_marg)
    orig_asm = builders._assemble

    def solve_ba_rows(states, inv_depth, pb, max_iterations=10):
        res = orig_rows(states, inv_depth, pb, max_iterations=max_iterations)
        if "solve" in faults and sampler.on:
            res = faults["solve"](states, inv_depth, pb, res)
        sampler.offer(getattr(_tls, "program", None), {
            "program": getattr(_tls, "program", None), "states": states,
            "inv_depth": inv_depth, "pb": pb, "max_iterations": max_iterations,
            "result": res})
        return res

    def batched_kf(*a, **kw):
        with program_label("kf"):
            return orig_kf(*a, **kw)

    def batched_sub(*a, **kw):
        with program_label("sub"):
            return orig_sub(*a, **kw)

    def batched_marg(res_states, res_invd, valid_out, tri_ok, tri_invd, a, priors, kf_mask,
                     calib):
        out = orig_marg(res_states, res_invd, valid_out, tri_ok, tri_invd, a, priors,
                        kf_mask, calib)
        if "marg" in faults and sampler.on:
            out = faults["marg"](kf_mask, out)
        sampler.offer("marg", {
            "states": res_states, "inv_depth": res_invd, "valid_out": valid_out,
            "tri_ok": tri_ok, "tri_invd": tri_invd, "pa_m": a["pa_m"],
            "mlm_vti": a["mlm_vti"], "mlm_from_w": a["mlm_from_w"], "mlm_tri": a["mlm_tri"],
            "priors": priors, "kf_mask": kf_mask, "calib": calib, "out": out})
        return out

    def assemble(spec, caps, calib):
        pa, lm_slot = orig_asm(spec, caps, calib)
        if not sampler.on:
            return pa, lm_slot
        if "preint" in faults:
            pa = faults["preint"](pa)
        fi, ip = _imu_rows(spec, caps)
        rows = []
        for entries, delta in ((fi, pa.fi_delta), (ip, pa.ip_delta)):
            for (f_i, f_j, samples, bg, ba_), d in zip(entries, _rows(delta, len(entries))):
                rows.append({"t_i": float(f_i.t), "t_j": float(f_j.t), "bg": np.array(bg, float),
                             "ba": np.array(ba_, float), "w": np.array(samples[1], float),
                             "delta": d})
        if rows:
            sampler.offer("preint", {"factors": rows})
        return pa, lm_slot

    ba.solve_ba_rows = solve_ba_rows
    dispatcher.batched_kf, dispatcher.batched_sub = batched_kf, batched_sub
    dispatcher.batched_marg = batched_marg
    builders._assemble = assemble

    def remove():
        ba.solve_ba_rows = orig_rows
        dispatcher.batched_kf, dispatcher.batched_sub = orig_kf, orig_sub
        dispatcher.batched_marg = orig_marg
        builders._assemble = orig_asm

    return remove
