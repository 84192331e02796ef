"""The tiny cells on the card, through the port's CUDA kernels: sound runs
are correct and the control is not. Marked ``cuda``; skips without a card.

    PYTHONPATH=src python -m pytest -q -m cuda fzbench/tests/test_fzbench_card.py
"""
from __future__ import annotations

import time

import pytest
import torch

from fzbench import control, harness

from .test_fzbench_correct import CELLS

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("workload", CELLS)
def test_sound_runs_are_correct_on_the_card(tiny_root, card, workload):
    out = harness.run(harness.Bench(tiny_root), workload, 2**31 + 9, 0.5, True, card,
                      time.perf_counter())
    assert out["correct"], out["checks"]
    assert out["device"]["busy_s"] > 0 and out["metrics"]


@pytest.mark.parametrize("workload", CELLS)
def test_the_control_is_not_correct_on_the_card(tiny_root, card, workload):
    out = control.run_control(harness.Bench(tiny_root), workload, 17, 0.5, card)
    assert not out["correct"]
