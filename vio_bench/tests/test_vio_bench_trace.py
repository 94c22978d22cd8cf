"""vio_bench.attribution on synthetic records (CPU): the launch join (graph
launches, other threads, launches outside any program span, activities with
no launch), the busy time's split by span, device idle inside the flush and
host-step spans, the idle gaps' labels, the five readings and their None
where the spans are absent; the interval arithmetic against a per-instant
count; and the records read from kineto's event objects."""

import types

import numpy as np
import pytest

from vio_bench import attribution as A
from vio_bench import manifest
from vio_bench.stats import gaps, union_length

TA, TB = 0x7F32805AB300, 0x7F2EED1FF6C0  # two pthread ids
W0, W1 = 100, 1000
SPANS = [
    # (name, thread, start_ns, end_ns), in the order they close
    ("ba.rows.lm", TA, 150, 280),
    ("prog.batched_sub", TB, 120, 200),  # another thread's program
    ("prog.batched_kf", TA, 110, 300),
    ("prog.batched_marg", TA, 300, 350),
    ("batch.kf", TA, 100, 400),
    ("prog.batched_sub", TA, 410, 590),
    ("batch.sub", TA, 400, 600),
    ("prog.integrate_batch", TA, 700, 720),
    ("handler.host_step", TA, 650, 900),
]
LAUNCHES = [  # (correlation, thread, time)
    (1, TA, 120),  # prog.batched_kf
    (2, TA, 160),  # a graph launch in ba.rows.lm inside prog.batched_kf
    (3, TA, 310),  # prog.batched_marg
    (4, TA, 420),  # prog.batched_sub
    (5, TA, 660),  # in the host step, in no program span
    (6, TB, 150),  # thread B's prog.batched_sub
    (7, TA, 705),  # prog.integrate_batch
]
ACTIVITIES = [  # (start, end, correlation)
    (130, 170, 1),
    (170, 200, 2), (200, 230, 2), (235, 260, 2),  # the graph's kernels
    (320, 380, 3),
    (430, 500, 4),
    (700, 750, 5),
    (240, 250, 6),  # inside a kernel of corr 2 (another stream): counted there
    (720, 760, 7),  # overlaps corr 5's, which started first
    (800, 820, 99),  # no launch record
    (50, 90, 1),  # before the window
]
TICKS = 2


def _records(activities=ACTIVITIES, launches=LAUNCHES):
    a = lambda x: np.asarray(x, np.int64)  # noqa: E731
    return A.Records(a([x[0] for x in activities]), a([x[1] for x in activities]),
                     a([x[2] for x in activities]), a([x[0] for x in launches]),
                     a([A.thread_key(x[1]) for x in launches]), a([x[2] for x in launches]))


@pytest.fixture(scope="module")
def att():
    return A.attribute(_records(), SPANS, W0, W1)


def test_launches_join_the_innermost_program_span_of_their_thread(att):
    assert att["device_ns"] == {
        "prog.batched_kf": 40 + 30 + 30 + 25,  # graph kernels included, and corr 6's instant
        "prog.batched_sub": 70,  # corr 4; corr 6 lies inside a kernel that started first
        "prog.batched_marg": 60,
        "prog.integrate_batch": 10,  # [750, 760): corr 5 started first
        A.UNATTRIBUTED: 50 + 20,  # corr 5 (no program span), corr 99 (no launch)
    }
    spans = [s for s in SPANS if s[0].startswith("prog.")] + [("other", TA, 0, 10 ** 6)]
    got = A.innermost_at(spans, np.array([A.thread_key(TA), A.thread_key(TB), 12345]),
                         np.array([160, 160, 160]))
    assert [spans[i][0] if i >= 0 else None for i in got] == [
        "prog.batched_kf", "prog.batched_sub", None]


def test_the_parts_sum_to_the_busy_time(att):
    iv = [(max(a, W0), min(b, W1)) for a, b, _ in ACTIVITIES]
    assert att["busy_ns"] == union_length(iv) == 335
    assert sum(att["device_ns"].values()) == att["busy_ns"]
    assert abs(sum(att["device_ns"].values()) * 1e-9 - union_length(iv) * 1e-9) <= 1e-9


def test_idle_inside_the_flushes_and_the_host_steps(att):
    ph = att["phases"]
    # flushes [100, 600): busy 100 + 25 + 60 + 70 of 500
    assert ph["flush"] == {"host_ns": 500, "idle_ns": 245}
    # host step [650, 900), no flush there: busy 60 + 20 of 250
    assert ph["host_step"] == {"host_ns": 250, "idle_ns": 170}
    # the flush's parts: the LM loop [150, 280) (busy 80 + 25); the programs
    # outside it [110, 150) + [280, 350) + [410, 590) (busy 20 + 30 + 70); the
    # rest [100, 110) + [350, 410) + [590, 600) (busy 30)
    assert ph["flush.lm"] == {"host_ns": 130, "idle_ns": 25}
    assert ph["flush.programs"] == {"host_ns": 290, "idle_ns": 170}
    assert ph["flush.other"] == {"host_ns": 80, "idle_ns": 50}
    parts = [ph[k] for k in ("flush.lm", "flush.programs", "flush.other")]
    assert [sum(p[k] for p in parts) for k in ("host_ns", "idle_ns")] == [500, 245]


def test_gaps_are_named_by_the_innermost_program_span(att):
    named = A.idle_gaps(att, SPANS, W0, W1, fallback=lambda ns: "harness phase")
    assert [[label, round(s * 1e9)] for label, s in named] == [
        ["harness phase", 200], ["harness phase", 180], ["prog.batched_kf", 60],
        ["batch.sub", 50], ["handler.host_step", 40], ["prog.batched_kf", 30],
        ["ba.rows.lm", 5]]
    iv = [(max(a, W0), min(b, W1)) for a, b, _ in ACTIVITIES]
    assert sorted(b - a for a, b in gaps(iv, W0, W1)) == sorted(
        round(s * 1e9) for _, s in named)
    assert A.idle_gaps(att, [], W0, W1)[0][0] == "no program span"


def test_the_five_readings(att):
    assert set(A.READINGS) == {"sub_device_ms_per_tick", "kf_device_ms_per_tick",
                               "marg_device_ms_per_tick", "flush_idle_ms_per_tick",
                               "host_step_idle_ms_per_tick"}
    got = A.readings(att, TICKS)
    ns = {"sub_device_ms_per_tick": 70, "kf_device_ms_per_tick": 125,
          "marg_device_ms_per_tick": 60, "flush_idle_ms_per_tick": 245,
          "host_step_idle_ms_per_tick": 170}
    assert got == pytest.approx({k: 1e-6 * v / TICKS for k, v in ns.items()}, rel=1e-12)
    for name in A.READINGS:  # a later benchmark can declare them as they are
        assert manifest.valid_name(name) and manifest.valid_unit("ms")


@pytest.mark.parametrize("drop, missing", [
    (("prog.batched_marg",), {"marg_device_ms_per_tick"}),
    (("handler.host_step",), {"host_step_idle_ms_per_tick"}),
    (("batch.kf", "batch.sub"), {"flush_idle_ms_per_tick"}),
    (("prog.batched_sub",), {"sub_device_ms_per_tick"}),
    (tuple({s[0] for s in SPANS}), set(A.READINGS)),  # a program without the spans
])
def test_a_reading_is_none_where_its_spans_are_absent(drop, missing):
    spans = [s for s in SPANS if s[0] not in drop]
    got = A.readings(A.attribute(_records(), spans, W0, W1), TICKS)
    assert {k for k, v in got.items() if v is None} == missing


def test_a_program_span_that_launched_nothing_reads_zero():
    acts = [x for x in ACTIVITIES if x[2] != 3]
    got = A.readings(A.attribute(_records(acts), SPANS, W0, W1), TICKS)
    assert got["marg_device_ms_per_tick"] == 0.0


def test_interval_arithmetic_against_a_count_per_instant():
    rng = np.random.default_rng(5)
    for _ in range(50):
        def ivs(n):
            s = rng.integers(0, 200, n)
            return s, s + rng.integers(0, 40, n)

        a_s, a_e = ivs(int(rng.integers(0, 12)))
        b_s, b_e = ivs(int(rng.integers(0, 12)))
        cover = lambda s, e: {t for x, y in zip(s, e) for t in range(x, y)}  # noqa: E731
        ms, me = A.merge(a_s, a_e)
        assert cover(ms, me) == cover(a_s, a_e)
        assert all(me[:-1] < ms[1:]) and all(me > ms)
        ns, ne = A.merge(b_s, b_e)
        ds, de = A.subtract(ms, me, ns, ne)
        assert cover(ds, de) == cover(a_s, a_e) - cover(b_s, b_e)
        lo, hi = ivs(6)
        assert list(A.covered(ms, me, lo, hi)) == [
            len(cover(ms, me) & set(range(x, y))) for x, y in zip(lo, hi)]
        lab = rng.integers(-1, 3, len(a_s))
        parts = A.busy_parts(a_s, a_e, lab, 20, 180, 3)
        assert parts.sum() == len({t for t in cover(a_s, a_e) if 20 <= t < 180})


def test_records_from_kineto_events():
    import torch

    def ev(kind, name, start, dur, corr, resource=0):
        return types.SimpleNamespace(
            device_type=lambda: kind, name=lambda: name, start_ns=lambda: start,
            duration_ns=lambda: dur, correlation_id=lambda: corr,
            device_resource_id=lambda: resource)

    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    tid = -2141539584  # kineto's int32 of the pthread id 0x7f32805ab300
    rec = A.records([
        ev(cpu, "cudaLaunchKernel", 10, 5, 2, tid),
        ev(cpu, "Lazy Function Loading", 11, 1, 2, 0),  # shares the launch's id
        ev(cuda, "spin_kernel", 20, 7, 2),
        ev(cpu, "cudaGraphLaunch", 30, 4, 3, tid),
        ev(cuda, "Memcpy HtoD (Pinned -> Device)", 40, 3, 3),
    ])
    assert rec.dev_start.tolist() == [20, 40] and rec.dev_end.tolist() == [27, 43]
    assert rec.dev_corr.tolist() == [2, 3] and rec.launch_corr.tolist() == [2, 3]
    assert rec.launch_t.tolist() == [10, 30]
    assert rec.launch_thread.tolist() == [A.thread_key(TA)] * 2


def test_the_traced_run_with_the_join_needs_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the run itself is the check")
    assert A.main(["--workload", "euroc_mav.lockstep2", "--seed", "1", "--seconds", "1"]) == 1
