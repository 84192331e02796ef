"""The serving steps the dry-run shares (``train.build_prefill_step`` /
``build_decode_step``), ``zoo.Model.cache_specs`` / ``cache_shardings``,
``configs.cells_for`` and the dry-run's two knobs, against the reference.

* For every arch at its published config (shapes only: ``meta`` tensors and
  ``jax.eval_shape``): ``cells_for``, the cache's leaves (shape, type) and
  their logical shardings equal the reference's.
* At SMOKE, one arch a family (dense, moe, vlm, hybrid, ssm, audio), with the
  reference's weights carried over (its zero- and one-initialised leaves
  perturbed, as ``test_torch_ssm`` does): the port's prefill and decode steps
  on a one-device stand-in mesh against the reference's builders on a
  one-device mesh, run op by op (``jax.disable_jit``: the compiled reference
  keeps some bfloat16 chains in float32), at the families' tolerances
  (logits 0.125, the float caches 5e-2 of their range, lengths exact). The
  port's decode step writes the cache it was given in place.
* ``attention.set_causal_skip(True)`` gives the same outputs as ``False``
  (bit for bit), and both are within 2e-4 of the reference's skip path;
  ``nn.set_bf16_matmul_output`` switches the chunked attention to bfloat16
  operands, within bfloat16 tolerance of the reference's bfloat16 mode.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_ssm import (LOGIT_TOL, STATE_REL, _aliases, carried, f32,  # noqa: F401
                            reference_step_globals, rel_err)

from repro_torch import configs
from repro_torch.configs.base import SHAPES, ShapeConfig, cells_for
from repro_torch.models import attention, nn, zoo
from repro_torch.train import build_decode_step, build_prefill_step

FAMILIES = ("yi-6b", "dbrx-132b", "qwen2-vl-72b", "zamba2-2.7b", "rwkv6-3b", "whisper-tiny")
B, S = 2, 24
ATTN_TOL = 2e-4


class StandIn:
    """A one-device mesh the port's builders read by its axis names and sizes."""
    axis_names = ("data", "model")
    shape = {"data": 1, "model": 1}


@pytest.fixture
def ref(monkeypatch):
    _aliases(monkeypatch)
    from repro import configs as rconfigs
    from repro.configs import base as rbase
    from repro.models import attention as rattention
    from repro.models import nn as rnn
    from repro.models import zoo as rzoo
    from repro.train import step as rstep
    with reference_step_globals():
        yield dict(configs=rconfigs, base=rbase, zoo=rzoo, step=rstep, nn=rnn,
                   attention=rattention)


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_cells_cache_specs_and_shardings_match_the_reference(ref, arch):
    rcfg = ref["configs"].get(arch)
    cfg = configs.get(arch)
    assert cells_for(cfg) == ref["base"].cells_for(rcfg)
    model, rmodel = zoo.build(cfg), ref["zoo"].build(rcfg)
    for name in cells_for(cfg):
        shape = SHAPES[name]
        cache, logical = model.cache_specs(shape)
        rcache, rlogical = rmodel.cache_specs(ref["base"].SHAPES[name])
        assert {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
                for k, v in cache.items()} == \
            {k: (tuple(v.shape), str(v.dtype)) for k, v in rcache.items()}
        assert all(v.device.type == "meta" for v in cache.values())
        assert logical == {k: tuple(v) for k, v in rlogical.items()}
        assert zoo.cache_shardings(cfg, cache) == logical


def _inputs(cfg, kind, rng):
    """The step's inputs as numpy: tokens (and M-RoPE positions, audio embeddings)."""
    if kind == "prefill":
        out = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
        if cfg.mrope_sections is not None:
            out["positions"] = np.broadcast_to(np.arange(S, dtype=np.int32),
                                               (B, 3, S)).copy()
        if cfg.family == "audio":
            out["audio_embeds"] = rng.standard_normal(
                (B, cfg.n_audio_ctx, cfg.d_model)).astype(np.float32)
        return out
    out = {"token": rng.integers(0, cfg.vocab, (B,)).astype(np.int32)}
    if cfg.mrope_sections is not None:
        out["positions"] = np.full((B, 3, 1), S, np.int32)
    return out


def _to_torch(d):
    out = {}
    for k, v in d.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        out[k] = t.to(torch.bfloat16) if k == "audio_embeds" else t
    return out


def _to_jax(d):
    return {k: jnp.asarray(v, jnp.bfloat16) if k == "audio_embeds" else jnp.asarray(v)
            for k, v in d.items()}


def _hold_cache(cache, jcache, what):
    assert set(cache) == set(jcache), what
    for name, leaf in cache.items():
        assert tuple(leaf.shape) == tuple(jcache[name].shape), (what, name)
        if leaf.dtype.is_floating_point:
            assert rel_err(leaf, jcache[name]) <= STATE_REL, (what, name)
        else:
            np.testing.assert_array_equal(leaf.numpy(), np.asarray(jcache[name]))


@pytest.mark.parametrize("arch", FAMILIES)
def test_prefill_and_decode_steps_match_the_reference(ref, arch):
    jm, jp, m, tp = carried(arch)
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    rng = np.random.default_rng(0)
    pre = _inputs(m.cfg, "prefill", rng)
    rb = ref["base"]
    jpre, jpre_info = ref["step"].build_prefill_step(jm, rb.ShapeConfig("p", S, B, "prefill"),
                                                     mesh)
    pre_fn, info = build_prefill_step(m, ShapeConfig("p", S, B, "prefill"), StandIn())
    assert set(info) == set(jpre_info) == {"params", "batch", "cache", "input_structs",
                                           "cache_structs"}
    assert {k: tuple(v.shape) for k, v in info["cache_structs"].items()} == \
        {k: tuple(v.shape) for k, v in jpre_info["cache_structs"].items()}
    with jax.disable_jit():
        jl, jc = jpre(jp, _to_jax(pre))
    tl, tc = pre_fn(tp, _to_torch(pre))
    assert float(np.abs(f32(tl) - f32(jl)).max()) <= LOGIT_TOL
    _hold_cache(tc, jc, "prefill")

    dec = _inputs(m.cfg, "decode", rng)
    jdec, _ = ref["step"].build_decode_step(jm, rb.ShapeConfig("d", S, B, "decode"), mesh)
    dec_fn, dinfo = build_decode_step(m, ShapeConfig("d", S, B, "decode"), StandIn())
    assert set(dinfo) == {"params", "batch", "cache", "input_structs", "cache_structs"}
    with jax.disable_jit():
        jl1, jc1 = jdec(jp, jc, _to_jax(dec))
    given = dict(tc)
    tl1, tc1 = dec_fn(tp, tc, _to_torch(dec))
    assert tc1 is tc                                  # updated in place, as donated
    assert tc1["length"] is given["length"]
    assert float(np.abs(f32(tl1) - f32(jl1)).max()) <= LOGIT_TOL
    _hold_cache(tc1, jc1, "decode")


def _qkv(seed, Sq=96, H=4, KVH=2, D=16):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((2, Sq, h, D)).astype(np.float32) for h in (H, KVH, KVH)]


@pytest.mark.parametrize("chunk", [16, 32, 96])
def test_causal_skip_equals_the_full_chunk_loop(ref, chunk):
    q, k, v = (torch.from_numpy(a) for a in _qkv(1))
    full = attention.flash_attention(q, k, v, q_chunk=chunk, kv_chunk=chunk)
    try:
        attention.set_causal_skip(True)
        skip = attention.flash_attention(q, k, v, q_chunk=chunk, kv_chunk=chunk)
        ref["attention"].set_causal_skip(True)
        want = ref["attention"].flash_attention(*(jnp.asarray(a) for a in _qkv(1)),
                                                q_chunk=chunk, kv_chunk=chunk)
    finally:
        attention.set_causal_skip(False)
        ref["attention"].set_causal_skip(False)
    assert torch.equal(full, skip)
    np.testing.assert_allclose(skip.numpy(), np.asarray(want), atol=ATTN_TOL, rtol=ATTN_TOL)


def test_bf16_matmul_output_switch(ref):
    assert nn.bf16_matmul_output() is False
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in _qkv(2))
    plain = attention.flash_attention(q, k, v, q_chunk=32, kv_chunk=32)
    try:
        nn.set_bf16_matmul_output(True)
        ref["nn"].set_bf16_matmul_output(True)
        assert nn.bf16_matmul_output() is True
        low = attention.flash_attention(q, k, v, q_chunk=32, kv_chunk=32)
        want = ref["attention"].flash_attention(
            *(jnp.asarray(a, jnp.bfloat16) for a in _qkv(2)), q_chunk=32, kv_chunk=32)
    finally:
        nn.set_bf16_matmul_output(False)
        ref["nn"].set_bf16_matmul_output(False)
    assert low.dtype == torch.bfloat16
    assert not torch.equal(low, plain)         # the products did run in bfloat16
    np.testing.assert_allclose(f32(low), f32(want), atol=0.05)
    np.testing.assert_allclose(f32(low), f32(plain), atol=0.05)


def test_depth_cut_keeps_the_cache_leaves(ref):
    """The dry-run's depth unit: zamba2's cache has a leaf a superblock's layers."""
    cfg = configs.get("zamba2-2.7b")
    cut = dataclasses.replace(cfg, n_layers=cfg.shared_attn_every)
    cache, _ = zoo.build(cut).cache_specs(SHAPES["long_500k"])
    rcfg = dataclasses.replace(ref["configs"].get("zamba2-2.7b"), n_layers=cfg.shared_attn_every)
    rcache, _ = ref["zoo"].build(rcfg).cache_specs(ref["base"].SHAPES["long_500k"])
    assert {k: tuple(v.shape) for k, v in cache.items()} == \
        {k: tuple(v.shape) for k, v in rcache.items()}
