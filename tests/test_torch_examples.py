"""The port's four examples (``repro_torch.examples``) in-process on the CPU
against the reference's (``examples/``), run in-process on the same seed.

quickstart and compress_field at a (16, 16, 8) field: the same printed CR, and
PSNR within 1e-4 dB of the reference's (its ``metrics.psnr`` values recorded
during its run). serve_compressed_kv ``--smoke`` with and without
``--kernels``: its own asserts. train_lm: 2 steps at batch 2, sequence 16, its
first loss within 1e-3 relative of the reference's ``Trainer`` on the same
~100M config, weights and stream. The reference runs with the jax 0.9 aliases
set by a function-scoped ``monkeypatch``.
"""
import contextlib
import dataclasses
import functools
import importlib.util
import io
import re
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from repro_torch import interop, obs
from repro_torch.core import metrics
from repro_torch.examples import compress_field, quickstart, serve_compressed_kv, train_lm

ROOT = Path(__file__).resolve().parents[1]
SHAPE = (16, 16, 8)
PSNR_TOL = 1e-4           # dB
LOSS_RTOL = 1e-3


def _aliases(mp):
    import jax._src.core as jcore
    from jax.experimental.pallas import tpu as pltpu
    mp.setattr(jax.core, "trace_state_clean", jcore.trace_state_clean, raising=False)
    mp.setattr(pltpu, "TPUCompilerParams", pltpu.CompilerParams, raising=False)


@pytest.fixture
def ref(monkeypatch):
    """The reference's examples as modules, with the jax 0.9 aliases, for one test."""
    _aliases(monkeypatch)

    def load(name):
        spec = importlib.util.spec_from_file_location(f"ref_example_{name}",
                                                      ROOT / "examples" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod
    yield load
    jax.clear_caches()


@pytest.fixture
def clean_obs():
    obs.reset()
    obs.clear_events()
    yield
    obs.reset()
    obs.clear_events()


def _recorded(mp, module, name):
    """Wrap ``module.name`` so that each value it returns is kept, in order."""
    seen, real = [], getattr(module, name)

    def wrapper(*a, **k):
        out = real(*a, **k)
        seen.append(float(out))
        return out
    mp.setattr(module, name, wrapper)
    return seen


def _run_ref(mod, mp, argv, shape=None):
    """The reference example's ``main`` on ``argv`` in a fresh reference
    registry (its telemetry checks read it); its field forced to ``shape`` when
    given. Returns (stdout, the psnr values it computed)."""
    from repro import obs as jobs
    from repro.core import metrics as jmetrics
    if shape is not None:
        real = mod.make_field
        mp.setattr(mod, "make_field", lambda kind, _shape, seed=0: real(kind, shape, seed=seed))
    psnrs = _recorded(mp, jmetrics, "psnr")
    mp.setattr(sys, "argv", [mod.__name__, *argv])
    out = io.StringIO()
    jobs.reset()
    jobs.clear_events()
    try:
        with contextlib.redirect_stdout(out):
            mod.main()
    finally:
        jobs.reset()
        jobs.clear_events()
    return out.getvalue(), psnrs


def test_quickstart_matches_the_reference(ref, monkeypatch, capsys, clean_obs):
    text_ref, psnr_ref = _run_ref(ref("quickstart"), monkeypatch, [], shape=SHAPE)
    got = quickstart.main(["--shape", *map(str, SHAPE), "--device", "cpu"])
    text = capsys.readouterr().out
    crs = re.findall(r"CR=\s*([\d.]+)x", text)
    assert crs == re.findall(r"CR=\s*([\d.]+)x", text_ref)
    assert len(crs) == 5                 # three bounds, the bf16 source, the kernel path
    want = psnr_ref[:3]                  # the three bounds' psnr, in order
    assert [b["eb"] for b in got["bounds"]] == [1e-2, 1e-3, 1e-4]
    np.testing.assert_allclose([b["psnr"] for b in got["bounds"]], want, rtol=0, atol=PSNR_TOL)
    assert "bit-identical to the reference path" in text
    for line in ("cold tier: plain", "bfloat16 source: raw"):
        assert line in text and line in text_ref


@pytest.mark.parametrize("kind", ["wavefront", "turbulent"])
def test_compress_field_matches_the_reference(ref, monkeypatch, capsys, kind, clean_obs):
    argv = ["--kind", kind, "--shape", *map(str, SHAPE)]
    text_ref, psnr_ref = _run_ref(ref("compress_field"), monkeypatch, argv)
    psnrs = _recorded(monkeypatch, metrics, "psnr")
    rows = compress_field.main(argv + ["--device", "cpu"])
    text = capsys.readouterr().out
    ref_rows = [ln for ln in text_ref.splitlines() if re.match(r"\de-0\d,", ln)]
    assert len(rows) == len(ref_rows) == len(compress_field.EBS)
    assert text.splitlines()[:2] == text_ref.splitlines()[:2]      # title and CSV header
    for row, ref_row in zip(rows, ref_rows):
        cols, ref_cols = row.split(","), ref_row.split(",")
        # eb, CR, bitrate and the absolute bound as printed
        assert [cols[i] for i in (0, 1, 2, 6)] == [ref_cols[i] for i in (0, 1, 2, 6)]
    np.testing.assert_allclose(psnrs, psnr_ref, rtol=0, atol=PSNR_TOL)


@pytest.mark.parametrize("kernels", [False, True])
def test_serve_compressed_kv_smoke_passes_its_asserts(kernels, clean_obs, capsys):
    argv = ["--smoke", "--device", "cpu"] + (["--kernels"] if kernels else [])
    out = serve_compressed_kv.main(argv)
    text = capsys.readouterr().out
    st = out["stats"]
    assert st.completed == 4 and st.preemptions >= 1 and st.prefix_hits >= 2
    assert out["teacher_forced"] >= 0.9 and 0 <= out["agreement"] <= 1
    assert "0 sentinel violations" in text
    assert ("tuned dispatch:" in text) == kernels


def test_serve_compressed_kv_smoke_schedules_as_the_reference(ref, monkeypatch, capsys,
                                                              clean_obs):
    """The trace's schedule does not depend on the weights: the printed
    scheduling lines equal the reference's."""
    text_ref, _ = _run_ref(ref("serve_compressed_kv"), monkeypatch, ["--smoke"])
    obs.reset()
    serve_compressed_kv.main(["--smoke", "--device", "cpu"])
    text = capsys.readouterr().out
    for head in ("trace:", "completed", "prefix sharing:", "latency (steps):"):
        line = next(ln for ln in text.splitlines() if ln.startswith(head))
        assert line == next(ln for ln in text_ref.splitlines() if ln.startswith(head))


def test_train_lm_first_loss_matches_the_reference(ref, monkeypatch, tmp_path, clean_obs):
    from repro import configs as jconfigs
    from repro.configs.base import ShapeConfig as JShape
    from repro.data.tokens import TokenStream as JStream
    from repro.launch.mesh import make_local_mesh as jmesh
    from repro.models import nn as jnn
    from repro.models import zoo as jzoo
    from repro.train import TrainConfig as JTrainConfig
    from repro.train import Trainer as JTrainer

    cfg = dataclasses.replace(
        jconfigs.get("yi-6b"), arch_id="yi-100m", n_layers=10, d_model=640, n_heads=10,
        n_kv_heads=2, d_ff=1792, vocab=16_384, head_dim=64)
    jm = jzoo.build(cfg)
    saved = jnn._ACT_SHARDER, jnn._GRAD_TAP
    try:
        jt = JTrainer(jm, JShape("train_local", 16, 2, "train"), jmesh(),
                      JTrainConfig(peak_lr=3e-4, warmup_steps=30, total_steps=2),
                      stream=JStream(vocab_size=cfg.vocab, seq_len=16, global_batch=2, seed=0))
        start = jax.tree.map(np.asarray, jt.params)   # before its step donates them
        ref_loss = jt.run(1)[0]["loss"]
    finally:
        jnn.set_act_sharder(saved[0])
        jnn.set_grad_tap(saved[1])
    # the example's trainer, started from the reference's weights
    tp = interop.params_from_reference(start, device="cpu")
    monkeypatch.setattr(train_lm, "Trainer", functools.partial(train_lm.Trainer,
                                                               init_params=tp))
    hist = train_lm.main(["--steps", "2", "--batch", "2", "--seq", "16",
                          "--ckpt-dir", str(tmp_path / "ck"), "--device", "cpu"])
    assert [m["step"] for m in hist] == [0, 1]
    np.testing.assert_allclose(hist[0]["loss"], ref_loss, rtol=LOSS_RTOL)
    assert all(np.isfinite(m["loss"]) for m in hist)
    assert (tmp_path / "ck" / "LATEST").read_text().strip().endswith("2")
