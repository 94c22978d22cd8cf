"""Run one cell of BENCHMARK.json once.

    python -m vio_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The cell names a configuration
(`vio_bench/configs/<config>.json`: the sensors, the solver profile, the
capacities and the scene) and a traffic mix (`vio_bench/traffic/<mix>.json`:
how many sequences run in lockstep, how long they are, where the window
opens); `vio_bench/cells/<cell>.json` holds the cell's own numbers (the
ticks a traced run profiles, how much of the window's work it samples for
the comparison, the limit of each number compared).

The run makes the sequences from --seed with the frozen generator, builds
`rd_vio_tpu_torch.batch.BatchedVIO` over them (one SyntheticBackend per
sequence, the runtime's default host workers) and drives it in the
benchmark's closed lockstep loop. Set-up ends at the first steady tick, a
margin of ticks past the third batched keyframe flush; the window then runs
to the first tick boundary after --seconds. With --trace 0 the last line of
standard output carries the cell's end-to-end metrics, with --trace 1 its
per-layer metrics, read over whole profiled ticks inside the window. Either
way, once the window has closed, the comparison with the plain reference
decides `correct` (vio_bench/checks.py), and each number compared is
printed beside its limit, as the last lines of standard error and as the
last key of the result.

Exits 1 without a result where no CUDA device is there or fewer than the
cell asks for, where a declared metric cannot be read, and where jax,
jaxlib, flax or the JAX package rd_vio_tpu is loaded.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
from pathlib import Path

T_IMPORT = time.perf_counter()

FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "rd_vio_tpu")


def process_age_s() -> float:
    """Seconds since this process started (/proc/self/stat's start time),
    so that set-up includes the interpreter's start and the imports."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        start_ticks = int(fields[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - T_IMPORT


def forbidden_loaded():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN_MODULES))


def fixed_caches(root: Path):
    """Every build and kernel cache in a fixed directory of the checkout."""
    cache = root / ".vio_bench_cache"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("CUDA_CACHE_PATH", str(cache / "nv"))
    os.environ.setdefault("USE_FLAX", "0")


# --------------------------------------------------------------------------
# inputs
# --------------------------------------------------------------------------


def sequence_seeds(seed: int, n: int):
    import numpy as np

    ss = np.random.SeedSequence([abs(int(seed)), int(seed < 0)])
    return [int(s) for s in ss.generate_state(n, dtype=np.uint32)]


def make_sequences(config: dict, traffic: dict, seed: int):
    """The traffic's sequences, by the frozen generator. Where the traffic
    names a `scene_seed`, every run replays the same scenes (landmarks) and
    the run's seed draws the sensor noise alone; else the seed draws both."""
    import numpy as np

    from vio_bench import synthetic

    cam, imu, scene = config["camera"], config["imu"], config["assumed"]
    K = np.array([[cam["fx"], 0.0, cam["cx"]], [0.0, cam["fy"], cam["cy"]], [0.0, 0.0, 1.0]])
    dynamic = bool(traffic.get("dynamic", False))
    n = int(traffic["sequences"])
    fixed = traffic.get("scene_seed")
    noise = sequence_seeds(seed, n)
    scenes = noise if fixed is None else sequence_seeds(int(fixed), n)
    seqs = []
    for s, ns in zip(scenes, noise):
        seqs.append(synthetic.generate(
            duration=float(traffic["duration_s"]), imu_rate=float(imu["rate_hz"]),
            cam_rate=float(cam["rate_hz"]), n_landmarks=int(scene["n_landmarks"]),
            max_keypoints=int(scene["max_keypoints"]),
            pixel_noise=float(scene["pixel_noise_px"]),
            gyro_noise=float(imu["gyro_noise_density"]) * math.sqrt(imu["rate_hz"]),
            accel_noise=float(imu["accel_noise_density"]) * math.sqrt(imu["rate_hz"]),
            K_mat=K, image_size=(int(cam["width"]), int(cam["height"])), seed=s,
            noise_seed=None if fixed is None else ns,
            excitation=float(scene["excitation"]), period=float(scene["period_s"]),
            n_dynamic=int(scene["n_dynamic"]) if dynamic else 0,
            dynamic_velocity=float(scene["dynamic_velocity_m_s"])))
    return seqs


def make_port_config(config: dict, seq):
    import numpy as np

    from rd_vio_tpu_torch.config import Config

    cfg = Config()
    for k, v in config["settings"].items():
        if not hasattr(cfg, k):
            raise ValueError(f"configuration setting {k!r} is not a setting of the port")
        setattr(cfg, k, np.asarray(v, float) if isinstance(v, list) else v)
    cfg.camera_intrinsic = seq.K_mat
    cfg.camera_resolution = (int(config["camera"]["width"]), int(config["camera"]["height"]))
    return cfg


# --------------------------------------------------------------------------
# the run
# --------------------------------------------------------------------------


class RunFailed(RuntimeError):
    pass


def run_cell(config: dict, traffic: dict, cellspec: dict, seed: int, seconds: float,
             trace: bool, device, faults: dict = None, control: bool = False,
             log=print) -> dict:
    """One run of a cell (see the module docstring). Returns the record the
    caller prints; raises RunFailed where the run cannot give one. With
    `control` the numbers compared are the control's (vio_bench.checks),
    and the program's own are kept beside them under `program_numbers`."""
    import numpy as np
    import torch

    from rd_vio_tpu_torch.batch import BatchedVIO
    from rd_vio_tpu_torch.models import builders
    from rd_vio_tpu_torch.models.feature_tracker import SyntheticBackend
    from rd_vio_tpu_torch.utils.metrics import GLOBAL_TIMER
    from vio_bench import capture, checks, lockstep
    from vio_bench.trace import PhaseStamps, Tracer, counter_values, counters_since, reduce_device

    on_card = torch.device(device).type == "cuda"
    seqs = make_sequences(config, traffic, seed)
    cfgs = [make_port_config(config, q) for q in seqs]
    caps = builders.Caps(**config["caps"])
    vio = BatchedVIO(cfgs, [SyntheticBackend(q) for q in seqs], caps=caps, device=device)
    ls = lockstep.Lockstep(vio, seqs)
    sampler = capture.Sampler(np.random.default_rng(sequence_seeds(seed, 1)[0]),
                              cellspec["samples"])
    remove = capture.install(vio, sampler, faults)
    stamps = PhaseStamps()
    stamps.wrap(vio.disp, "_flush_kf", "batched keyframe flush (batch.kf)")
    stamps.wrap(vio.disp, "_flush_sub", "batched subwindow flush (batch.sub)")
    stamps.wrap(vio, "_add_frame", "add_frame: the sequences' new frames")
    ls.stamps = stamps
    n = len(seqs)
    try:
        # -- set-up: to the first steady tick --------------------------------
        k0 = None
        while k0 is None:
            k = ls.tick()
            if k % 25 == 24:
                log(f"[vio_bench] set-up tick {k + 1}: {time.perf_counter() - T_IMPORT:.1f} s, "
                    f"states {ls.states()}, batched keyframe flushes {ls.kf_flushes[-1]}",
                    file=sys.stderr, flush=True)
            if 2 in ls.states():
                raise RunFailed(f"a sequence crashed at tick {k}")
            if k + 1 >= int(traffic["max_setup_ticks"]):
                raise RunFailed(f"no steady window after {k + 1} ticks (batched keyframe "
                                f"flushes {ls.kf_flushes[-1]})")
            k0 = lockstep.steady_window_start(ls.kf_flushes,
                                              int(traffic["window_after_kf_flushes"]),
                                              int(traffic["window_margin_ticks"]))
        if k0 != ls.k - 1:
            raise RunFailed("the steady window opened on a tick already past")
        setup_s = process_age_s() if on_card else time.perf_counter() - T_IMPORT
        if any(s != 1 for s in ls.states()):
            raise RunFailed(f"sequences not tracking at the window's start: {ls.states()}")
        t_w0 = ls.tick_end[k0]
        tot = sorted(((sum(v), name, len(v)) for name, v in GLOBAL_TIMER.samples.items()),
                     reverse=True)[:8]
        log("[vio_bench] set-up's largest host spans (s, calls; the last 256 calls each): "
            + ", ".join(f"{name} {t:.1f} ({n})" for t, name, n in tot), file=sys.stderr)
        log(f"[vio_bench] steady window opens after tick {k0} ({setup_s:.1f} s of set-up, "
            f"{ls.kf_flushes[k0]} batched keyframe flushes)", file=sys.stderr, flush=True)

        # -- the window -------------------------------------------------------
        sampler.on = True
        tracer = None
        prof = None  # [first profiled tick, ticks profiled]
        profile_ticks = int(cellspec["profile_ticks"])
        while True:
            if trace and prof is None and ls.k - 1 > k0 and \
                    ls.kf_flushes[-1] > ls.kf_flushes[-2]:
                # the profile starts right after a batched keyframe flush,
                # with the program's spans and counters from nought
                GLOBAL_TIMER.reset()
                counters0 = counter_values(clear_logs=True)
                stamps.spans.clear()
                stamps.on = True
                tracer = Tracer()
                tracer.start()
                prof = [ls.k, 0]
            k = ls.tick()
            if prof is not None and prof[1] < profile_ticks:
                prof[1] += 1
                if prof[1] == profile_ticks:
                    tracer.stop()
                    stamps.on = False
                    spans = {name: list(v) for name, v in GLOBAL_TIMER.samples.items()}
                    counters = counters_since(counters0)
                    syncs = tracer.syncs()
                    prof_kf = ls.kf_flushes[-1] - ls.kf_flushes[prof[0] - 1]
            done = time.perf_counter() - t_w0 >= seconds
            if done and (not trace or (prof is not None and prof[1] >= profile_ticks)):
                break
            if trace and prof is None and ls.k - k0 > int(traffic["max_window_ticks"]):
                raise RunFailed("no batched keyframe flush to start the profile after")
        k1 = k
        t_w1 = ls.tick_end[k1]
        sampler.on = False
        window_frames = list(range(k0 + 1, k1 + 1))

        # -- every window frame's pose, a few ticks past the close if need be
        def pending():
            return [i for i in range(n)
                    if not any(abs(t - seqs[i].t_frame[k1]) < 1e-6
                               for t, _, _ in ls.published[i][-4:])]

        for _ in range(int(traffic["drain_ticks"])):
            if not pending():
                break
            ls.tick()
        peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    except lockstep.SequencesEnded as e:
        raise RunFailed(str(e)) from e
    finally:
        remove()
    published = [list(p) for p in ls.published]
    ticks = {"start": list(ls.tick_start), "end": list(ls.tick_end), "kf": list(ls.kf_flushes),
             "window": [k0, k1]}
    ls.close()
    del vio, ls

    # -- metrics ------------------------------------------------------------
    metrics = {}
    record = {"attempted": n * len(window_frames)}
    if not trace:
        from vio_bench.stats import rate

        in_window = sum(t_w0 < stamp <= t_w1 for pubs in published for _, _, stamp in pubs)
        metrics["agg_frames_per_s"] = {"value": rate(in_window, t_w1 - t_w0),
                                       "unit": "frames/s"}
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
        record["window"] = {"ticks": len(window_frames), "seconds": t_w1 - t_w0,
                            "published_in_window": in_window}
    else:
        from vio_bench.metrics import reader

        if prof is None or prof[1] < profile_ticks:
            raise RunFailed("the profiled ticks did not complete")
        if prof_kf < 1:
            raise RunFailed(f"the {prof[1]} profiled ticks hold no batched keyframe flush")
        events = tracer.device_events()
        if not events:
            raise RunFailed("torch.profiler recorded no device activity over the profiled "
                            "ticks")
        dev = reduce_device(events, tracer.t0, tracer.t1, stamps)
        # what a per-layer reader may read: every span and counter of the
        # program over the profiled ticks, the host syncs, the device
        tr = {"ticks": prof[1], "frames": prof[1] * n, "spans": spans, "counters": counters,
              "syncs": syncs, "device": dev}
        for name in cellspec["per_layer"]:
            mod = reader(name)
            v = mod.read(tr)
            if v is not None:
                metrics[name] = {"value": v, "unit": mod.UNIT}
        record["breakdown"] = {"device_ops": dev["device_ops"], "idle_gaps": dev["idle_gaps"]}
        record["profiled"] = {"first_tick": prof[0], "ticks": prof[1], "kf_flushes": prof_kf}
        record["device_extra"] = {"busy_s": dev["busy_s"], "window_s": dev["window_s"]}

    # -- the comparison -------------------------------------------------------
    if on_card:
        torch.cuda.empty_cache()
    t_c = time.perf_counter()
    nums, rows = checks.numbers(sampler.samples, published, seqs, window_frames, config)
    if control:
        record["program_numbers"], record["program_rows"] = nums, rows
        nums, rows = checks.numbers(sampler.samples, published, seqs, window_frames, config,
                                    control=True)
    record["check_seconds"] = time.perf_counter() - t_c
    record["numbers"], record["rows"] = nums, rows
    record["metrics"] = metrics
    record["memory_peak_bytes"] = peak
    record["ticks"] = ticks
    record["setup_s"] = setup_s
    return record


def judge(numbers: dict, limits: dict):
    """(correct, {name: {"value", "limit"}}): every number at or under its
    limit; a number that could not be read fails."""
    out, ok = {}, True
    for name, limit in limits.items():
        v = numbers.get(name)
        if v is None:
            ok = False
            out[name] = {"value": None, "limit": limit}
            continue
        ok &= bool(v <= limit)
        out[name] = {"value": v, "limit": limit}
    return ok, out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--record", default=None,
                    help="also write the run's whole record (JSON) to this file")
    ap.add_argument("--control", type=int, choices=(0, 1), default=0,
                    help="1: the control in the program's place in the comparison, which "
                         "must then come out not correct (setting and testing the limits; "
                         "the benchmark's own runs never pass it)")
    args = ap.parse_args(argv)

    from vio_bench import manifest

    root = manifest.ROOT
    fixed_caches(root)
    man = manifest.load_manifest()
    bad = manifest.check_names(man)
    if bad:
        print(f"vio_bench: BENCHMARK.json: {bad}", file=sys.stderr)
        return 1
    w = manifest.cell(man, args.workload)
    config = manifest.load_data("configs", w["config"])
    traffic = manifest.load_data("traffic", w["traffic"])
    cellspec = manifest.load_data("cells", w["name"])
    declared = manifest.declared_metrics(man, w["name"], bool(args.trace))
    cellspec["per_layer"] = sorted(declared) if args.trace else []

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(w["chips"]):
        print(f"vio_bench: needs {w['chips']} CUDA device(s); "
              f"available: {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    try:
        rec = run_cell(config, traffic, cellspec, args.seed, args.seconds,
                       bool(args.trace), device, control=bool(args.control), log=print)
    except RunFailed as e:
        print(f"vio_bench: run failed: {e}", file=sys.stderr)
        return 1

    metrics = rec["metrics"]
    errs = manifest.check_printed(metrics, declared)
    if errs:
        print("vio_bench: the result would not match the cell's declared metrics: "
              + "; ".join(errs), file=sys.stderr)
        return 1
    loaded = forbidden_loaded()
    if loaded:
        print(f"vio_bench: modules that may not load in this process are loaded: {loaded}",
              file=sys.stderr)
        return 1
    correct, shown = judge(rec["numbers"], cellspec["limits"])
    n_failed = rec["numbers"].get("unpublished_frames", 0)
    device_rec = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                  "count": int(w["chips"]), "memory_peak_bytes": int(rec["memory_peak_bytes"])}
    out = {"correct": bool(correct), "attempted": rec["attempted"], "failed": int(n_failed),
           "metrics": metrics, "device": device_rec}
    if args.trace:
        device_rec.update(rec["device_extra"])
        out["breakdown"] = rec["breakdown"]
    out["compared"] = rec["numbers"]["compared"]
    if args.control:
        out["control"] = True
    out["checks"] = shown
    if args.record:
        with open(args.record, "w") as f:
            json.dump(rec, f, default=float)
    for name, v in shown.items():
        print(f"check {name}: {v['value']} (limit {v['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
