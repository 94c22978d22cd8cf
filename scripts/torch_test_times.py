"""Time the port's parity tests on the CPU.

    python scripts/torch_test_times.py files [--root DIR] [--out JSON] [FILE ...]
    python scripts/torch_test_times.py suite [--root DIR] [--out JSON] [--work DIR]

`files` runs each tests/test_torch_*.py file (or the FILEs named) alone, one
after another, as `pytest FILE --durations=0`, each with a fresh HOME (so an
empty JAX compilation cache) and JAX_PLATFORMS=cpu. For each file it prints
the wall seconds and, per test, pytest's call seconds split by the spawned
processes' call log (tests/test_torch_image.py `TIMING_LOG`):

- `child_start`: from the first call's submission to its start in the
  spawned `child` (process start, imports of jax, torch and the port);
- `child`: seconds the child spent inside the test's calls (the port's
  half; in modules without `jax_side` it holds their JAX calls too);
- `jax_start`, `jax`: the same for the `jax_side` process (the JAX half);
- `overlap`: seconds in which both processes were inside calls at once.

`suite` runs the tier-1 command (the pytest line of ROADMAP.md's Tier-1
verify, with `--dist load` as the test runner runs it, and its log and
junit files under --work) with a fresh HOME and TMPDIR under --work, and
prints its wall seconds, the user+sys CPU seconds of all its reaped
processes (what `/usr/bin/time -v` reports), its exit code and the counts
of the junit file.

--root is the checkout whose tests run (default: this repo).
"""

import argparse
import glob
import json
import os
import re
import resource
import shutil
import subprocess
import sys
import tempfile
import time
import xml.etree.ElementTree as ET

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DURATION = re.compile(r"^\s*([0-9.]+)s (call|setup|teardown)\s+(\S+)")


def _cpu_children():
    r = resource.getrusage(resource.RUSAGE_CHILDREN)
    return r.ru_utime + r.ru_stime


def _env(home, tmp=None, log=None):
    env = dict(os.environ, HOME=home, JAX_PLATFORMS="cpu", ALLOW_MULTIPLE_LIBTPU_LOAD="1")
    env.pop("RD_VIO_TPU_JAX_CACHE", None)
    if tmp:
        env["TMPDIR"] = tmp
    if log:
        env["RDVIO_TEST_TIMING_LOG"] = log
    return env


def _union(spans):
    """Total length of the union of (a, b) intervals."""
    total, end = 0.0, -1e300
    for a, b in sorted(spans):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def _split(calls):
    """Per test: child_start, child, jax_start, jax, overlap (seconds)."""
    out, spans, seen_pool = {}, {}, set()
    for c in calls:
        d = out.setdefault(c["test"], dict(child_start=0.0, child=0.0, jax_start=0.0,
                                          jax=0.0, overlap=0.0))
        key = "jax" if c["proc"] == "jax_side" else "child"
        if c["pool"] not in seen_pool:  # a process's first call waits for its start
            seen_pool.add(c["pool"])
            d[key + "_start"] += c["start"] - c["submit"]
        d[key] += c["end"] - c["start"]
        spans.setdefault((c["test"], key), []).append((c["start"], c["end"]))
    for test, d in out.items():
        sc, sj = spans.get((test, "child"), []), spans.get((test, "jax"), [])
        d["overlap"] = _union(sc) + _union(sj) - _union(sc + sj)
        out[test] = {k: round(v, 2) for k, v in d.items()}
    return out


def run_files(root, files):
    res = {}
    for f in files:
        home = tempfile.mkdtemp(prefix="home_")
        log = os.path.join(home, "calls.jsonl")
        t0 = time.time()
        p = subprocess.run([sys.executable, "-m", "pytest", f, "-q", "-p", "no:cacheprovider",
                            "--durations=0"], cwd=root, env=_env(home, log=log),
                           capture_output=True, text=True)
        wall = time.time() - t0
        calls = []
        if os.path.exists(log):
            with open(log) as fh:
                calls = [json.loads(line) for line in fh]
        split = _split(calls)
        tests = {}
        for line in p.stdout.splitlines():
            m = DURATION.match(line)
            if m:
                t = tests.setdefault(m.group(3), {})
                t[m.group(2)] = float(m.group(1))
        for name, t in tests.items():
            t.update(split.get(name, {}))
        last = p.stdout.strip().splitlines()[-1] if p.stdout.strip() else ""
        res[os.path.basename(f)] = dict(wall=round(wall, 1), rc=p.returncode, summary=last,
                                        tests=tests)
        print(json.dumps({os.path.basename(f): res[os.path.basename(f)]}), flush=True)
        shutil.rmtree(home, ignore_errors=True)
    total = round(sum(r["wall"] for r in res.values()), 1)
    print(json.dumps(dict(total_wall=total, files=len(res))), flush=True)
    return dict(files=res, total_wall=total)


def run_suite(root, work):
    os.makedirs(work, exist_ok=True)
    home, tmp = os.path.join(work, "home"), os.path.join(work, "tmp")
    for d in (home, tmp):
        shutil.rmtree(d, ignore_errors=True)
        os.makedirs(d)
    log, xml = os.path.join(work, "t1.log"), os.path.join(work, "t1.xml")
    cmd = ("set -o pipefail; timeout -k 10 1470 env JAX_PLATFORMS=cpu "
           "ALLOW_MULTIPLE_LIBTPU_LOAD=1 python -m pytest tests/ -q -m 'not slow' "
           "--continue-on-collection-errors -p no:cacheprovider -p xdist -n 6 --dist load "
           f"--junitxml={xml} -p no:randomly 2>&1 | tee {log}")
    cpu0, t0 = _cpu_children(), time.time()
    p = subprocess.run(["bash", "-c", cmd], cwd=root, env=_env(home, tmp), capture_output=True,
                       text=True)
    wall, cpu = time.time() - t0, _cpu_children() - cpu0
    counts = {}
    if os.path.exists(xml):
        s = ET.parse(xml).getroot()
        s = s if s.tag == "testsuite" else s.find("testsuite")
        counts = {k: int(s.get(k, 0)) for k in ("tests", "errors", "failures", "skipped")}
        counts["passed"] = (counts["tests"] - counts["errors"] - counts["failures"]
                            - counts["skipped"])
    failed = [line for line in p.stdout.splitlines() if line.startswith(("FAILED", "ERROR"))]
    out = dict(rc=p.returncode, wall=round(wall, 1), user_sys=round(cpu, 1), **counts,
               failed=failed[:20])
    print(json.dumps(out), flush=True)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("mode", choices=["files", "suite"])
    ap.add_argument("files", nargs="*")
    ap.add_argument("--root", default=REPO)
    ap.add_argument("--out")
    ap.add_argument("--work", default=os.path.join(tempfile.gettempdir(), "rdvio_suite"))
    a = ap.parse_args()
    root = os.path.abspath(a.root)
    if a.mode == "files":
        files = a.files or sorted(glob.glob(os.path.join(root, "tests", "test_torch_*.py")))
        res = run_files(root, [os.path.relpath(f, root) if os.path.isabs(f) else f
                               for f in files])
    else:
        res = run_suite(root, a.work)
    if a.out:
        with open(a.out, "w") as f:
            json.dump(res, f, indent=1)


if __name__ == "__main__":
    main()
