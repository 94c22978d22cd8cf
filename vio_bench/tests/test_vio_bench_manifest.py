"""BENCHMARK.json against the contract's shapes: names and units, the data
file of every configuration, traffic mix, cell and per-layer metric, the
check that a run prints exactly its declared metrics, and the time budget
of a full check."""

import json

import pytest

from vio_bench import manifest
from vio_bench.metrics import reader


@pytest.fixture(scope="module")
def man():
    return manifest.load_manifest()


@pytest.mark.parametrize("s, ok", [
    ("agg_frames_per_s", True), ("pose_latency_ms.p90", True), ("euroc_mav.lockstep4", True),
    ("_x", True), ("9a", True), ("a b", False), ("a,b", False), ("a/b", False),
    (".a", False), ("", False), ("x" * 64, True), ("x" * 65, False), ("µs", False),
])
def test_name_characters(s, ok):
    assert manifest.valid_name(s) is ok


@pytest.mark.parametrize("s, ok", [
    ("frames/s", True), ("ms", True), ("%", True), ("count", True), ("s", True),
    ("frames per second", False), ("", False), ("x" * 17, False), ("µs", False),
])
def test_unit_characters(s, ok):
    assert manifest.valid_unit(s) is ok


def test_manifest_names_and_keys(man):
    assert manifest.check_names(man) == []
    assert set(man) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert len(json.dumps(man)) < 64 * 1024
    names = [m["name"] for m in man["end_to_end"] + man["per_layer"]]
    assert len(names) == len(set(names))
    assert "setup_s" in names
    for m in man["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in man["end_to_end"]}
    for m in man["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


def test_every_named_file_is_there(man):
    for c in man["configs"]:
        conf = manifest.load_data("configs", c["name"])
        assert conf["name"] == c["name"] and c["file"] == f"vio_bench/configs/{c['name']}.json"
        assert set(c["reduced"]) <= set(conf["reduced"]) | set(conf["assumed"])
    used = set()
    for w in man["workloads"]:
        assert w["chips"] == 1
        used.add(w["config"])
        manifest.load_data("traffic", w["traffic"])
        cell = manifest.load_data("cells", w["name"])
        assert cell["profile_ticks"] >= 1 and cell["limits"]
    assert used == {c["name"] for c in man["configs"]}
    for m in man["per_layer"]:
        assert reader(m["name"]).UNIT == m["unit"]


def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric(man):
    for w in man["workloads"]:
        e2e = manifest.declared_metrics(man, w["name"], trace=False)
        assert "setup_s" in e2e and len(e2e) >= 2
        assert manifest.declared_metrics(man, w["name"], trace=True)


def test_printed_names_must_equal_the_declared_ones(man):
    w = man["workloads"][0]["name"]
    declared = manifest.declared_metrics(man, w, trace=True)
    full = {n: {"value": 1.0, "unit": m["unit"]} for n, m in declared.items()}
    assert manifest.check_printed(full, declared) == []
    missing = dict(full)
    gone = sorted(missing)[0]
    del missing[gone]
    assert manifest.check_printed(missing, declared) == [f"declared metric {gone} is missing"]
    extra = dict(full, lk_fwd_rev_roofline={"value": 50.0, "unit": "%"})
    assert "not declared" in manifest.check_printed(extra, declared)[0]
    wrong = dict(full, **{gone: {"value": 1.0, "unit": "us"}})
    assert "unit" in manifest.check_printed(wrong, declared)[0]
    nan = dict(full, **{gone: {"value": float("nan"), "unit": declared[gone]["unit"]}})
    assert "finite" in manifest.check_printed(nan, declared)[0]


def test_a_full_check_fits_its_time(man):
    cells, runs = 24, 2 + 14 * 24
    assert runs * (man["run_seconds"] + 60) + cells * 2 * 90 + 1200 <= 43200


def test_data_file_refuses_paths():
    with pytest.raises(manifest.ManifestError):
        manifest.data_file("configs", "../BENCHMARK")
