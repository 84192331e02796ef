"""``correct`` on the CPU at tiny sizes: sound runs pass, and every fault a
cell can have, planted where the timed path produces its answer, fails; so
does the control (the reference in bfloat16 in the program's place)."""
from __future__ import annotations

import pytest
import torch

from fzbench import control, harness
from repro_torch.core import fz
from repro_torch.kernels import ops

from .conftest import cpu_run

CELLS = ["nyx-512.compress", "hacc-280m.decompress", "nyx-512.decompress",
         "hacc-280m.compress-strict"]


@pytest.mark.parametrize("workload", CELLS)
def test_sound_runs_are_correct(tiny_root, workload):
    out = cpu_run(tiny_root, workload)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert list(out)[-1] == "checks"
    assert all(c["value"] == 0 and c["limit"] == 0 for c in out["checks"].values())


@pytest.mark.parametrize("workload", CELLS)
def test_traced_runs_are_correct(tiny_root, workload):
    out = cpu_run(tiny_root, workload, trace=True)
    assert out["correct"] and list(out)[-1] == "checks"
    assert "window_s" in out["device"]
    direction = "decompress" if workload.endswith(".decompress") else "compress"
    assert f"host_ms.{direction}" in out["metrics"]


def _compress_fault(kind):
    """(owner, attribute, stand-in) of a fault in the timed compress path."""
    if kind == "eb_loosened":
        real_eb = fz.resolve_eb
        return fz, "resolve_eb", lambda data, cfg: 2 * real_eb(data, cfg)
    if kind == "stale_answer":                 # the previous call's answer, state unchanged
        real_compress, prev = fz.compress, {}

        def stale(x, cfg, **kw):
            c = real_compress(x, cfg, **kw)
            out, prev["c"] = prev.get("c", c), c
            return out
        return fz, "compress", stale
    real = ops.fused_compress_stages

    def stages(data, eb, **kw):
        if kind == "half_field_left_out":
            data = data.clone()
            data.reshape(-1)[data.numel() // 2:] = 0
        out = list(real(data, eb, **kw))
        if kind == "payload_byte_flipped":
            out[1] = out[1].clone()
            out[1].view(torch.uint8)[0, 1] ^= 0x10
        elif kind == "outlier_value_altered":       # (.., outlier_idx, outlier_val, n_over)
            out[4] = out[4].clone()
            out[4][0] += 1
        elif kind == "outliers_dropped":
            out[3] = torch.full_like(out[3], data.numel())
            out[4] = torch.zeros_like(out[4])
            out[5] = torch.zeros_like(out[5])
        return tuple(out)
    return ops, "fused_compress_stages", stages


@pytest.mark.parametrize("workload", ["nyx-512.compress", "hacc-280m.compress-strict"])
@pytest.mark.parametrize("kind", ["payload_byte_flipped", "eb_loosened", "half_field_left_out",
                                  "stale_answer"])
def test_compress_faults_are_not_correct(tiny_root, monkeypatch, workload, kind):
    monkeypatch.setattr(*_compress_fault(kind))
    out = cpu_run(tiny_root, workload)
    assert not out["correct"]
    assert out["checks"]["container_mismatch"]["value"] > 0


def test_the_strict_cell_fills_its_outlier_channel(tiny_root):
    """Every field of the strict mix has outliers, and fewer than the channel holds."""
    from fzbench import fields
    bench = harness.Bench(tiny_root)
    cell = bench.cell("hacc-280m.compress-strict")
    cfg, mix = bench.config(cell["config"]), bench.traffic(cell["traffic"])
    fzcfg = fz.FZConfig(**mix["fz"])
    for i in range(len(cfg["fields"])):
        x = fields.make_field(cfg["proxy"], cfg["shape"], cfg["dtype"], 2**31 + 5, cfg["name"],
                              i, "cpu", bench.proxies())
        c = fz.compress(x, fzcfg, device="cpu")
        assert 0 < int(c.n_outliers) < fzcfg.outlier_capacity(x.numel())


@pytest.mark.parametrize("kind", ["outlier_value_altered", "outliers_dropped"])
def test_outlier_channel_faults_are_not_correct(tiny_root, monkeypatch, kind):
    monkeypatch.setattr(*_compress_fault(kind))
    out = cpu_run(tiny_root, "hacc-280m.compress-strict")
    assert not out["correct"]
    assert out["checks"]["container_mismatch"]["value"] > 0
    assert out["checks"]["bound_violations"]["value"] > 0


def test_a_wrong_stored_size_is_not_correct(tiny_root, monkeypatch):
    monkeypatch.setattr(fz.FZCompressed, "used_bytes", lambda self: 32)
    out = cpu_run(tiny_root, "nyx-512.compress")
    assert not out["correct"]
    assert out["checks"]["container_mismatch"]["value"] > 0


def _decompress_fault(kind):
    real = ops.fused_decompress

    def broken(*args, **kw):
        y = real(*args, **kw).clone()
        if kind == "value_altered":
            y.reshape(-1)[y.numel() // 3] += 1e-3
        elif kind == "half_field_left_out":
            y.reshape(-1)[y.numel() // 2:] = 0
        else:                                   # "state_unchanged": a buffer never written
            y.zero_()
        return y
    return broken


@pytest.mark.parametrize("workload", ["hacc-280m.decompress", "nyx-512.decompress"])
@pytest.mark.parametrize("kind", ["value_altered", "half_field_left_out", "state_unchanged"])
def test_decompress_faults_are_not_correct(tiny_root, monkeypatch, workload, kind):
    monkeypatch.setattr(ops, "fused_decompress", _decompress_fault(kind))
    out = cpu_run(tiny_root, workload)
    assert not out["correct"]
    assert out["checks"]["recon_mismatch"]["value"] > 0
    assert out["checks"]["container_mismatch"]["value"] == 0     # set-up's compress is sound


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("seed", [11, 2**31 + 12, 13])
def test_the_control_is_not_correct(tiny_root, workload, seed):
    out = control.run_control(harness.Bench(tiny_root), workload, seed, 0.3,
                              torch.device("cpu"))
    assert not out["correct"]
    failing = {k for k, c in out["checks"].items() if c["value"] > c["limit"]}
    assert failing, out["checks"]
