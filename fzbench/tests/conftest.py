"""Fixtures of the benchmark's CPU tests: a copy of the benchmark's files at
tiny sizes, run through the harness on the CPU (the port's kernel wrappers run
their plain versions for CPU tensors)."""
from __future__ import annotations

import json
import shutil
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
# particle: enough elements that the strict mix (rel 1e-5) fills its outlier
# channel on every field, and under its capacity of n/256
TINY_SHAPES = {"turbulent": [20, 18, 16], "particle": [200_001]}


def tiny_copy(dest: Path) -> Path:
    """BENCHMARK.json and fzbench's data files under ``dest``, every
    configuration cut to a shape a test can hold."""
    for part in ("configs", "proxies", "traffic", "metrics"):
        shutil.copytree(ROOT / "fzbench" / part, dest / "fzbench" / part)
    shutil.copy(ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
    for path in (dest / "fzbench" / "configs").glob("*.json"):
        cfg = json.loads(path.read_text())
        cfg["shape"] = TINY_SHAPES[cfg["proxy"]]
        path.write_text(json.dumps(cfg))
    return dest


@pytest.fixture
def tiny_root(tmp_path, monkeypatch):
    """A tiny copy of the benchmark, with an empty tuning cache for the port,
    run on two CPU threads (several test workers share the cores)."""
    from repro_torch.tune import dispatch
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", str(tmp_path / "tune_cache.json"))
    dispatch.reset()
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield tiny_copy(tmp_path / "checkout")
    torch.set_num_threads(threads)
    dispatch.reset()


def cpu_run(root: Path, workload: str, seed: int = 2**31 + 5, seconds: float = 0.3,
            trace: bool = False) -> dict:
    from fzbench import harness
    return harness.run(harness.Bench(root), workload, seed, seconds, trace,
                       torch.device("cpu"), time.perf_counter())
