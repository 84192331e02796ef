"""BENCHMARK.json keeps to its contract's form, and every name it holds finds
its file; a configuration, mix and metric added as files are taken as data."""
from __future__ import annotations

import json
import re

import pytest

from fzbench import harness

from .conftest import ROOT, cpu_run, tiny_copy

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"},
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_manifest_names_units_and_keys():
    m = MANIFEST
    assert set(m) == KEYS["top"]
    assert 1 <= m["run_seconds"] <= 51 and isinstance(m["run_seconds"], int)
    assert all(PATH.match(p) and ".." not in p and not p.startswith("/") for p in m["paths"])
    assert len(m["command"]) <= 32 and all(_line(w) for w in m["command"])
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in m[section]]
        assert len(names) == len(set(names)), section
        for e in m[section]:
            extra = set(e) - KEYS[section]
            assert extra <= ({"workloads"} if section in ("end_to_end", "per_layer") else set())
            assert KEYS[section] <= set(e), (section, e["name"])
            assert NAME.match(e["name"]), e["name"]
    metric_names = [e["name"] for e in m["end_to_end"] + m["per_layer"]]
    assert len(metric_names) == len(set(metric_names))
    cells = {w["name"] for w in m["workloads"]}
    for c in m["configs"]:
        assert _line(c["source"]) and _line(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for w in m["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and _line(w["why"])
        assert w["chips"] in (1, 4)
    for e in m["end_to_end"] + m["per_layer"]:
        assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        assert set(e.get("workloads", [])) <= cells
    for e in m["end_to_end"]:
        assert e["source"] in ("host_clock", "device_trace")
        assert 0.01 <= e["bound"] <= 0.25
    for e in m["per_layer"]:
        assert e["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert _line(e["layer"]) and e["moves"] in {x["name"] for x in m["end_to_end"]}
    assert "setup_s" in {e["name"] for e in m["end_to_end"]}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("workload", [w["name"] for w in MANIFEST["workloads"]])
def test_every_cell_finds_its_files(workload):
    bench = harness.Bench(ROOT)
    cell = bench.cell(workload)
    entry = next(c for c in MANIFEST["configs"] if c["name"] == cell["config"])
    cfg = bench.config(cell["config"])
    assert cfg["name"] == cell["config"] and cfg["reduced"] == entry["reduced"]
    assert entry["file"].startswith("fzbench/")
    bench.traffic(cell["traffic"])
    assert (bench.proxies() / f"{cfg['proxy']}.py").is_file()
    e2e = bench.metrics(workload, False)
    layer = bench.metrics(workload, True)
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2 and layer
    assert {m["moves"] for m in layer} <= {m["name"] for m in e2e}
    for m in e2e + layer:
        assert callable(bench.reader(m["name"]))


def test_new_config_mix_and_metric_are_taken_as_data(tmp_path, monkeypatch):
    """One more of each, added as files and entries in a copy (a proxy kind
    with the configuration), runs without an edit to any file the benchmark has."""
    from repro_torch.tune import dispatch
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", str(tmp_path / "tune.json"))
    dispatch.reset()
    root = tiny_copy(tmp_path / "checkout")
    before = {p: p.read_bytes() for p in (root / "fzbench").rglob("*") if p.is_file()}
    (root / "fzbench/configs/box-24.json").write_text(json.dumps({
        "name": "box-24", "source": "a test", "fields": ["a", "b"], "shape": [24, 24],
        "dtype": "float32", "proxy": "waves", "reduced": [], "assumed": []}))
    (root / "fzbench/proxies/waves.py").write_text(
        "import torch\n\ndef make(shape, gen, device):\n"
        "    return torch.rand(shape, generator=gen, device=device).cumsum(-1)\n")
    mix = json.loads((root / "fzbench/traffic/compress-paper.json").read_text())
    mix["fz"].update(eb=1e-4, eb_mode="abs")
    (root / "fzbench/traffic/compress-abs.json").write_text(json.dumps(mix))
    (root / "fzbench/metrics/calls_done.py").write_text(
        "def read(record):\n    return float(len(record['calls']))\n")
    m = json.loads((root / "BENCHMARK.json").read_text())
    m["configs"].append({"name": "box-24", "source": "a test", "reduced": [], "why": "a test",
                         "file": "fzbench/configs/box-24.json"})
    m["workloads"].append({"name": "box-24.abs", "config": "box-24", "traffic": "compress-abs",
                           "chips": 1, "why": "a test"})
    m["end_to_end"].append({"name": "calls_done", "unit": "calls", "better": "higher",
                            "bound": 0.05, "source": "host_clock", "workloads": ["box-24.abs"]})
    (root / "BENCHMARK.json").write_text(json.dumps(m))
    out = cpu_run(root, "box-24.abs")
    assert out["correct"] and out["metrics"]["calls_done"]["value"] == out["attempted"]
    assert {"ratio", "call_ms_p95", "setup_s"} <= set(out["metrics"])
    assert all(p.read_bytes() == b for p, b in before.items())
    dispatch.reset()
