"""The port's host spans (rd_vio_tpu_torch/utils/metrics.StageTimer): each
span's record (name, thread, start and end on time.time_ns(), the clock
torch.profiler stamps its records on), nesting on one thread and across
two, the log's bound, `samples` read from the log, the thread switch
`suppressed()`; and the spans the program opens: `prog.<name>` around
every program `builders._count` counts, `ba.rows.lm` around the batched LM
loop, `handler.host_step` around a synchronous frame's host step.

The `cuda` test lays spans over a torch.profiler trace on the card: the
runtime record of a launch made inside a span lies inside it on the shared
clock, and vio_bench.attribution joins its kernel, and every kernel of a
CUDA graph replayed inside a span on a second thread, to that span. This
file imports no JAX at the top, so on a machine without JAX it runs as

    python -m pytest --noconftest tests/test_torch_tracing.py -q -m cuda
"""

import multiprocessing
import shutil

import pytest

IN_CHILD = multiprocessing.parent_process() is not None
if IN_CHILD:  # the checks' process: one torch thread, JAX on the CPU
    import tests.test_torch_image  # noqa: F401


@pytest.fixture(scope="module")
def child():
    """The spawned child of tests/test_torch_image.py (its `child`), taken
    here so that this module loads without JAX where only its card test
    runs."""
    from tests.test_torch_image import _CHILD, _shared

    return _shared(_CHILD)


def _check_span_records():
    import threading
    import time

    from rd_vio_tpu_torch.utils.metrics import StageTimer

    timer = StageTimer(bound=100)
    t_before = time.time_ns()
    with timer.time("outer"):
        with timer.time("inner"):
            pass
    barrier = threading.Barrier(2, timeout=30)
    idents = {}

    def work(name):
        idents[name] = threading.get_ident()
        with timer.time(name):
            barrier.wait()  # both spans are open at once

    threads = [threading.Thread(target=work, args=(n,)) for n in ("a", "b")]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=30)
    assert not any(th.is_alive() for th in threads)
    t_after = time.time_ns()
    log = timer.spans()
    assert [r[0] for r in log[:2]] == ["inner", "outer"]  # in the order they closed
    assert sorted(r[0] for r in log[2:]) == ["a", "b"]
    me = threading.get_ident()
    for name, thread, t0, t1 in log:
        assert isinstance(t0, int) and t_before <= t0 <= t1 <= t_after
        assert thread == (idents[name] if name in idents else me)
    by = {r[0]: r for r in log}
    assert by["outer"][2] <= by["inner"][2] <= by["inner"][3] <= by["outer"][3]
    assert by["a"][1] != by["b"][1]
    assert max(by["a"][2], by["b"][2]) <= min(by["a"][3], by["b"][3])  # they overlap

    # samples: every logged call's seconds by name, read from the log
    assert timer.samples == {n: [(t1 - t0) * 1e-9] for n, _, t0, t1 in log}
    assert timer.stats()["outer"]["n"] == 1
    with StageTimer.suppressed():
        with timer.time("off"):
            pass
    assert "off" not in timer.samples
    timer.reset()
    assert timer.spans() == [] and timer.samples == {}


def test_span_records(child):
    child(_check_span_records)


def _check_the_bound():
    from rd_vio_tpu_torch.utils.metrics import GLOBAL_TIMER, StageTimer

    timer = StageTimer(bound=5)
    for i in range(8):
        with timer.time(f"s{i % 2}"):
            pass
    log = timer.spans()
    assert len(log) == 5 and [r[0] for r in log] == ["s1", "s0", "s1", "s0", "s1"]
    assert {k: len(v) for k, v in timer.samples.items()} == {"s0": 2, "s1": 3}
    assert sum(len(v) for v in timer.samples.values()) == timer.bound
    # the program's timer holds a traced run's profiled ticks many times over
    assert GLOBAL_TIMER.bound >= 1 << 16


def test_the_log_is_bounded(child):
    child(_check_the_bound)


def _check_program_spans():
    import time

    import torch
    from torch.utils._pytree import tree_map

    from rd_vio_tpu_torch.datasets import synthetic
    from rd_vio_tpu_torch.datasets.synthetic_problems import (
        build_window_problem, perturbed_start)
    from rd_vio_tpu_torch.estimation import ba
    from rd_vio_tpu_torch.models import builders
    from rd_vio_tpu_torch.models.handler import Handler
    from rd_vio_tpu_torch.utils.metrics import GLOBAL_TIMER

    def spans(name):
        return [r for r in GLOBAL_TIMER.spans() if r[0] == name]

    # builders._count: the program's span and its counts, in one place
    GLOBAL_TIMER.reset()
    builders.PROGRAM_STATS.pop("probe", None)
    seen = []
    out = builders._count("probe", lambda x: seen.append(time.time_ns()) or x + 1, 1)
    assert out == 2 and builders.PROGRAM_STATS.pop("probe")["calls"] == 1
    (span,) = spans("prog.probe")
    assert span[2] <= seen[0] <= span[3]

    # ba.solve_ba_rows: one ba.rows.lm span around every LM iteration
    seq = synthetic.generate(duration=1.0, n_landmarks=200, max_keypoints=40, seed=3)
    probs = [perturbed_start(*build_window_problem(seq, f0, 4, L_max=24, O_max=96,
                                                   device="cpu")[:3], seed=s)
             for f0, s in ((2, 7), (5, 8))]
    S, I, P = (tree_map(lambda *x: torch.stack(x), *[p[k] for p in probs]) for k in range(3))
    steps = []
    step = ba._row_step

    def timed_step(c, pb):
        steps.append(time.time_ns())
        return step(c, pb)

    GLOBAL_TIMER.reset()
    ba._row_step = timed_step
    try:
        t0 = time.time_ns()
        ba.solve_ba_rows(S, I, P, max_iterations=3)
    finally:
        ba._row_step = step
    (lm,) = spans("ba.rows.lm")
    assert 1 <= len(steps) <= 3 and ba.ROW_ITERATIONS[-1] and max(ba.ROW_ITERATIONS[-1]) \
        == len(steps)
    assert t0 <= lm[2] <= steps[0] and steps[-1] <= lm[3]

    # the synchronous handler: handler.host_step around a frame's host step
    class Tracker:
        tracked = []

        def track_frame(self, frame):
            self.tracked.append((frame.t, time.time_ns()))

    GLOBAL_TIMER.reset()
    h = Handler(None, Tracker(), None)
    h.track_camera(0.05, None)
    for t in (0.0, 0.04, 0.06):
        h.track_motion(t, [0.0, 0.0, 0.0], [0.0, 0.0, 9.8])
    ((t_frame, t_step),) = Tracker.tracked
    (host,) = spans("handler.host_step")
    assert t_frame == 0.05 and host[2] <= t_step <= host[3]


def test_program_spans(child):
    child(_check_program_spans)


@pytest.fixture
def dev():
    if shutil.which("nvidia-smi") is None:
        pytest.skip("needs a CUDA device (no nvidia-smi here)")
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_spans_and_launches_share_the_clock_on_the_card(dev):
    """A span around a torch.cuda._sleep launch holds that launch's runtime
    record (within 50 us on either side), and the join puts its kernel in
    the span; a CUDA graph replayed inside a span from a second thread has
    every kernel in that span; nothing is left unattributed."""
    import threading
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile

    from rd_vio_tpu_torch.utils.metrics import StageTimer
    from vio_bench import attribution

    static = torch.randn(1 << 16, device=dev)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            (static * 2 + 1).sin()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        (static * 2 + 1).sin()
    torch.cuda._sleep(1000)
    torch.cuda.synchronize()

    timer = StageTimer()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        w0 = time.time_ns()
        with timer.time("prog.sleep"):
            torch.cuda._sleep(2_000_000)

        def replay():
            with timer.time("prog.graph"):
                graph.replay()

        th = threading.Thread(target=replay)
        th.start()
        th.join(timeout=60)
        torch.cuda.synchronize()
        w1 = time.time_ns()
    assert not th.is_alive()
    events = list(prof.profiler.kineto_results.events())
    spans = {r[0]: r for r in timer.spans()}
    cuda = torch.autograd.DeviceType.CUDA
    spin = [e for e in events if e.device_type() == cuda and "spin_kernel" in e.name()]
    assert len(spin) == 1
    (launch,) = [e for e in events if e.device_type() != cuda and e.name().startswith("cu")
                 and e.correlation_id() == spin[0].correlation_id()]
    _, thread, s0, s1 = spans["prog.sleep"]
    assert s0 - 50_000 <= launch.start_ns() <= launch.start_ns() + launch.duration_ns() \
        <= s1 + 50_000
    assert attribution.thread_key(launch.device_resource_id()) == attribution.thread_key(thread)

    rec = attribution.records(events)
    att = attribution.attribute(rec, timer.spans(), w0, w1)
    kernels = [e for e in events if e.device_type() == cuda]
    graph_corr = {e.correlation_id() for e in kernels} - {spin[0].correlation_id()}
    assert len(graph_corr) == 1  # the three kernels carry the cudaGraphLaunch's id
    graph_kernels = [e for e in kernels if e.correlation_id() in graph_corr]
    assert len(graph_kernels) == 3
    assert att["device_ns"]["prog.sleep"] == spin[0].duration_ns()
    assert att["device_ns"]["prog.graph"] == sum(e.duration_ns() for e in graph_kernels)
    assert att["device_ns"][attribution.UNATTRIBUTED] == 0
    assert sum(att["device_ns"].values()) == att["busy_ns"]
