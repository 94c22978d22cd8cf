"""BENCHMARK.json and the data files it names: loading, the character rules
for names and units, and the check that a run prints exactly the metrics its
cell declares."""

from __future__ import annotations

import json
import re
from pathlib import Path
from typing import Dict, List

ROOT = Path(__file__).resolve().parent.parent
BENCH_DIR = Path(__file__).resolve().parent

NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


class ManifestError(ValueError):
    pass


def valid_name(s: str) -> bool:
    return isinstance(s, str) and bool(NAME_RE.match(s))


def valid_unit(s: str) -> bool:
    return isinstance(s, str) and bool(UNIT_RE.match(s))


def load_manifest(path: Path = None) -> dict:
    path = Path(path) if path is not None else ROOT / "BENCHMARK.json"
    with open(path) as f:
        return json.load(f)


def check_names(man: dict) -> List[str]:
    """Every name and unit of the manifest against the allowed characters;
    returns the offending entries (empty when all pass)."""
    bad = []
    for c in man.get("configs", []):
        if not valid_name(c.get("name")):
            bad.append(f"config name {c.get('name')!r}")
        for k in c.get("reduced", []):
            if not valid_name(k):
                bad.append(f"reduced key {k!r}")
    for w in man.get("workloads", []):
        for key in ("name", "config", "traffic"):
            if not valid_name(w.get(key)):
                bad.append(f"workload {key} {w.get(key)!r}")
    for group in ("end_to_end", "per_layer"):
        for m in man.get(group, []):
            if not valid_name(m.get("name")):
                bad.append(f"metric name {m.get('name')!r}")
            if not valid_unit(m.get("unit")):
                bad.append(f"unit {m.get('unit')!r} of {m.get('name')!r}")
            if m.get("better") not in ("lower", "higher"):
                bad.append(f"better of {m.get('name')!r}")
    return bad


def cell(man: dict, name: str) -> dict:
    for w in man["workloads"]:
        if w["name"] == name:
            return w
    raise ManifestError(f"no workload {name!r} in BENCHMARK.json")


def declared_metrics(man: dict, workload: str, trace: bool) -> Dict[str, dict]:
    """The metrics a run of `workload` has to print, by name: its
    end-to-end metrics in a timed run, its per-layer metrics in a traced
    one. A metric with a `workloads` key belongs to the cells it lists;
    one without it to every cell."""
    group = "per_layer" if trace else "end_to_end"
    return {m["name"]: m for m in man[group]
            if "workloads" not in m or workload in m["workloads"]}


def data_file(kind: str, name: str, suffix: str = ".json") -> Path:
    """vio_bench/<kind>/<name><suffix>, refusing names that would leave it."""
    if not valid_name(name):
        raise ManifestError(f"{kind} name {name!r} has characters a name may not have")
    path = BENCH_DIR / kind / f"{name}{suffix}"
    if not path.is_file():
        raise ManifestError(f"{kind} {name!r}: no file {path.relative_to(ROOT)}")
    return path


def load_data(kind: str, name: str) -> dict:
    with open(data_file(kind, name)) as f:
        return json.load(f)


def check_printed(metrics: Dict[str, dict], declared: Dict[str, dict]) -> List[str]:
    """What is wrong with the metrics a run is about to print, against the
    cell's declared list: a missing or extra name, a wrong unit, a value
    that is not a finite number. Empty when the two agree."""
    import math

    errs = []
    for name in sorted(set(declared) - set(metrics)):
        errs.append(f"declared metric {name} is missing")
    for name in sorted(set(metrics) - set(declared)):
        errs.append(f"metric {name} is not declared for this cell")
    for name in sorted(set(metrics) & set(declared)):
        m = metrics[name]
        if m.get("unit") != declared[name]["unit"]:
            errs.append(f"metric {name} has unit {m.get('unit')!r}, declared "
                        f"{declared[name]['unit']!r}")
        v = m.get("value")
        if not isinstance(v, (int, float)) or isinstance(v, bool) or not math.isfinite(v):
            errs.append(f"metric {name} has no finite value ({v!r})")
    return errs
