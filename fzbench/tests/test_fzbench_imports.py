"""What the benchmark loads and how it refuses: no module of JAX or the JAX
package, no result without a card or without the program."""
from __future__ import annotations

import json
import shutil
import subprocess
import sys

import pytest
import torch

from fzbench import run

from .conftest import ROOT

_PROBE = """
import json, sys, time, pathlib, os
root = pathlib.Path(sys.argv[1])
sys.path[0:0] = [str(root / "src"), str(root)]
os.environ["REPRO_TORCH_TUNE_CACHE"] = sys.argv[3]
import torch
from fzbench import control, harness, run
from fzbench.reference import check, fz_ref
out = harness.run(harness.Bench(pathlib.Path(sys.argv[2])), "nyx-512.compress", 7, 0.2, True,
                  torch.device("cpu"), time.perf_counter())
print(json.dumps({"correct": out["correct"], "forbidden": run.forbidden_modules()}))
"""


def test_no_module_of_jax_or_the_jax_package_is_loaded(tiny_root, tmp_path):
    proc = subprocess.run([sys.executable, "-c", _PROBE, str(ROOT), str(tiny_root),
                           str(tmp_path / "tune.json")],
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got == {"correct": True, "forbidden": []}


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    before = run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro_torch_fake", object())
    monkeypatch.setitem(sys.modules, "jaxtyping_fake", object())
    assert run.forbidden_modules() == before
    monkeypatch.setitem(sys.modules, "repro.core.fake", object())
    monkeypatch.setitem(sys.modules, "flax", object())
    assert {"repro", "flax"} <= set(run.forbidden_modules())


def _run_py(cwd, *args):
    return subprocess.run([sys.executable, "fzbench/run.py", *args], cwd=cwd,
                          capture_output=True, text=True, timeout=300)


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the refusal without one cannot be shown")


def test_without_a_card_there_is_no_result(no_card):
    proc = _run_py(ROOT, "--workload", "nyx-512.compress", "--seed", str(2**31 + 3),
                   "--seconds", "1", "--trace", "0")
    assert proc.returncode != 0
    assert not [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    assert "CUDA card" in proc.stderr


def test_without_the_program_there_is_no_result(tmp_path):
    """A directory holding only BENCHMARK.json and the benchmark's files."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "fzbench", tmp_path / "fzbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = _run_py(tmp_path, "--workload", "nyx-512.decompress", "--seed", "5",
                   "--seconds", "1", "--trace", "0")
    assert proc.returncode != 0
    assert not [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    assert "repro_torch" in proc.stderr
