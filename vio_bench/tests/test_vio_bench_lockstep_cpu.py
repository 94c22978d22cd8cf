"""A tiny run of the benchmark's lockstep loop on the CPU, through
`run.run_cell` with everything but the look for a card: 2 sequences, a
window of 4 keyframes, short sequences, the cell's own limits. A sound run
comes out correct. The control, put in the program's place, comes out not
correct. The same run with the timed path broken underneath, in the
window only, comes out not correct, once for each fault the lockstep cells
can have:

- a step that returns its state unchanged: every batched solve returns its
  starting states;
- half of the batch left out: the second half of each batched solve's rows
  returns its starting states;
- an answer altered where it is produced: the batched solves' positions
  moved by 5 cm; the marginalization's prior scaled by 1.01; the
  preintegrated position deltas moved by a millimetre.

(The exchange between chips does not exist in a one-chip cell.) Each run
takes a few minutes on the CPU."""

import pytest
import torch

from vio_bench import manifest, run

LIMITS = manifest.load_data("cells", "euroc_mav.lockstep2")["limits"]


SECONDS = 45.0


def tiny():
    config = manifest.load_data("configs", "euroc_mav")
    config["settings"]["sliding_window_size"] = 4
    config["settings"]["sliding_window_subframe_size"] = 3
    config["caps"].update(W=13, L=256, O=1536)
    traffic = dict(manifest.load_data("traffic", "lockstep2"), sequences=2, duration_s=6.0,
                   window_margin_ticks=2)
    cell = {"profile_ticks": 2, "samples": {"sub": 1, "kf": 1, "marg": 1, "preint": 2},
            "limits": LIMITS, "per_layer": []}
    return config, traffic, cell


def unchanged_rows(rows):
    def fault(states, inv_depth, pb, res):
        n = states.q.shape[0]
        sel = torch.zeros(n, dtype=torch.bool, device=states.q.device)
        sel[rows(n)] = True
        keep = lambda new, old: torch.where(  # noqa: E731
            sel.reshape((-1,) + (1,) * (old.ndim - 1)), old.to(new.dtype), new)
        st = type(res.states)(*(keep(a, b) for a, b in zip(res.states, states)))
        return res._replace(states=st, inv_depth=keep(res.inv_depth, inv_depth))
    return fault


def moved(states, inv_depth, pb, res):
    return res._replace(states=res.states._replace(p=res.states.p + 0.05))


def prior_scaled(kf_mask, priors):
    return priors._replace(sqrt_inv_cov=priors.sqrt_inv_cov * 1.01)


def preint_moved(pa):
    d = dict(pa.fi_delta, p=pa.fi_delta["p"] + 1e-3)
    return pa._replace(fi_delta=d)


FAULTS = {
    "state_unchanged": {"solve": unchanged_rows(lambda n: slice(0, n))},
    "half_the_batch": {"solve": unchanged_rows(lambda n: slice(n // 2, n))},
    "positions_altered": {"solve": moved},
    "prior_altered": {"marg": prior_scaled},
    "preintegration_altered": {"preint": preint_moved},
}


def go(faults=None, control=False):
    torch.set_num_threads(2)
    config, traffic, cell = tiny()
    rec = run.run_cell(config, traffic, cell, 987654321012, SECONDS, False, "cpu",
                       faults=faults, control=control, log=lambda *a, **k: None)
    return rec, run.judge(rec["numbers"], LIMITS)


def test_sound_run_is_correct_and_reports_its_metrics():
    rec, (ok, shown) = go()
    assert ok, shown
    n = rec["numbers"]["compared"]
    assert n["solve"] >= 2 and n["marg"] >= 1 and n["preint"] >= 1, n
    m = rec["metrics"]
    assert set(m) == {"agg_frames_per_s", "setup_s"}
    assert m["agg_frames_per_s"]["value"] > 0 and m["setup_s"]["value"] > 0


def test_the_control_is_not_correct():
    rec, (ok, shown) = go(control=True)
    assert not ok, shown
    ok_prog, shown_prog = run.judge(rec["program_numbers"], LIMITS)
    assert ok_prog, shown_prog


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_timed_path_is_not_correct(fault):
    rec, (ok, shown) = go(FAULTS[fault])
    assert not ok, shown
