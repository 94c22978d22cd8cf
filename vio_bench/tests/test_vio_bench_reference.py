"""The plain references against the port on the CPU, at a small size: the
window solve (the same cost at the same states, so both read a problem
alike, and the same minimum), the slot-0 marginalization and the
preintegration. The port is imported here only to make the problem and to
be compared; the reference itself imports nothing of it."""

import numpy as np
import pytest
import torch

from vio_bench import synthetic
from vio_bench.capture import as_plain
from vio_bench.reference import marg as ref_marg
from vio_bench.reference import preint as ref_preint
from vio_bench.reference import solve as ref


@pytest.fixture(scope="module")
def problem():
    from rd_vio_tpu_torch.datasets.synthetic_problems import build_window_problem, perturbed_start

    seq = synthetic.generate(duration=3.0, n_landmarks=400, max_keypoints=80,
                             pixel_noise=0.5, seed=5)
    states, invd, pb, _, _ = build_window_problem(seq, 10, 6, L_max=96, O_max=512,
                                                  device="cpu")
    return perturbed_start(states, invd, pb, seed=3)


def test_reference_cost_equals_the_ports(problem):
    from rd_vio_tpu_torch.estimation import ba

    s0, d0, pb = problem
    c_port = float(ba.compute_cost(s0, d0, pb))
    c_ref = float(ref.cost(as_plain(s0), d0, as_plain(pb)))
    assert c_ref == pytest.approx(c_port, rel=1e-10)


def test_reference_minimum_equals_the_ports(problem):
    from rd_vio_tpu_torch.estimation import ba

    s0, d0, pb = problem
    port = ba.solve_ba(s0, d0, pb, max_iterations=60)
    sol = ref.solve(as_plain(s0), d0, as_plain(pb))
    assert sol.cost < sol.initial_cost
    assert sol.cost == pytest.approx(float(port.cost), rel=1e-6)
    gap = float((sol.states["p"] - port.states.p).abs().max())
    assert gap < 1e-6, gap


def test_a_state_left_unchanged_reads_far_from_the_minimum(problem):
    """The fault of a solve that returns its start: the gap the benchmark
    compares is then the whole correction (here centimetres)."""
    s0, d0, pb = problem
    sol = ref.solve(as_plain(s0), d0, as_plain(pb))
    assert float((sol.states["p"] - s0.p).abs().max()) > 1e-2


def test_reference_marginalization_equals_the_ports(problem):
    """The port's slot-0 marginalization and the reference's Schur
    complement give the same prior at the solved states, and the
    reference's own float32 reads far from it (the control)."""
    from rd_vio_tpu_torch.estimation import ba, marginalization

    s0, d0, pb = problem
    sol = ba.solve_ba(s0, d0, pb, max_iterations=20)
    s, d = sol.states, sol.inv_depth
    prior = marginalization.marginalize_frame0(s, d, pb)
    H, b = ref_marg.marginalize(as_plain(s), d, as_plain(pb))
    S, iv = prior.sqrt_inv_cov, prior.infovec
    assert ref_marg.gap(S.T @ S, S.T @ iv, H, b) < 1e-9
    f32 = lambda t: ({k: f32(v) for k, v in t.items()} if isinstance(t, dict)  # noqa: E731
                     else t.float() if t.is_floating_point() else t)
    Hc, bc = ref_marg.marginalize(f32(as_plain(s)), d.float(), f32(as_plain(pb)))
    assert ref_marg.gap(Hc, bc, H, b) > 1e-4


@pytest.mark.parametrize("t_i, t_j", [(0.35, 0.65), (0.35, 2.25)])
def test_reference_preintegration_equals_the_ports(t_i, t_j):
    """The port's host preintegration of an interval's samples, as its
    handler cuts them (the sample at or before t_i held from t_i, then
    each sample of (t_i, t_j]), against the reference's integration of the
    same stream; and the reference's float32 far from both."""
    from rd_vio_tpu_torch.ops import preintegration_np as pre_np

    rng = np.random.default_rng(0)
    t_imu = np.arange(0, 3, 0.005)
    gyro = rng.normal(size=(len(t_imu), 3))
    acc = rng.normal(size=(len(t_imu), 3)) + [0, 0, 9.8]
    bg, ba_ = np.array([0.01, -0.02, 0.005]), np.array([0.1, 0.0, -0.05])
    cov = [1e-4 * np.eye(3), 1e-2 * np.eye(3), 1e-8 * np.eye(3), 1e-6 * np.eye(3)]
    dt, idx, _ = ref_preint.segments(t_imu, t_i, t_j)
    sel = [k for k in range(len(t_imu)) if t_i + 1e-12 < t_imu[k] <= t_j + 1e-12]
    times = np.array([t_i] + [t_imu[k] for k in sel])
    dts = np.append(np.diff(times), max(t_j - times[-1], 0.0))
    w = gyro[[idx[0]] + sel]
    a = acc[[idx[0]] + sel]
    out = pre_np.integrate_full_batch(dts[None], w[None], a[None], bg[None], ba_[None], *cov)
    port = {k: v[0] for k, v in out.items()}

    def integrate(dtype):
        T = lambda x: torch.as_tensor(np.asarray(x, float), dtype=dtype)  # noqa: E731
        return ref_preint.integrate(T(dt), T(gyro[idx]), T(acc[idx]), T(bg), T(ba_),
                                    *(T(c) for c in cov))

    ref64 = integrate(torch.float64)
    assert max(ref_preint.gap(port, ref64).values()) < 1e-10
    assert max(ref_preint.gap(integrate(torch.float32), ref64).values()) > 1e-6
