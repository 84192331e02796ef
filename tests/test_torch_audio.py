"""The port's audio encoder-decoder (whisper-tiny) against the reference, on the CPU.

The reference runs in this process with the two jax 0.9 aliases (the
function-scoped ``ref`` fixture), its model op by op (``jax.disable_jit``)
where the port is held to it, as ``tests/test_torch_ssm.py`` does. Its SMOKE
parameters (``model.init(jax.random.key(0))``, the zero MLP biases made
random) are carried over with ``interop.params_from_reference``; the audio
frontend's embeddings and the tokens are numpy arrays from a seed.

At SMOKE the config has 4 heads over 2 KV heads; whisper attends with all
``n_heads`` for K/V (the reference's ``whisper.py:139-142``), so every cache
leaf has 4 heads.

Tolerances: ``_sin_pos`` in float32 1e-5 absolute (``pow``/``sin``/``cos``
of another library), so one bfloat16 ulp once rounded (8 of 576,000 values
at 1500 x 384 round the other way); logits of
prefill and decode ``LOGIT_TOL`` 0.125 absolute (measured 0.0078); every cache leaf equal in
name, shape and type after ``make_cache``, prefill and a decode step, the
cross K/V 0.0625 (bfloat16, a few ulps); prefill S + decode against prefill
S + 1 at ``LOGIT_TOL``; ``forward_train`` loss 1e-3 relative, each gradient
leaf 0.05 of its max |g| (measured 0.013); whole-cache parking as the recurrent families
(routes bit for bit, containers equal to the reference's, tokens >= 0.9).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import whisper as jwhisper
from repro.models import zoo as jzoo
from repro_torch import configs, obs, pytree
from repro_torch.configs.base import SHAPES
from repro_torch.models import whisper, zoo
from repro_torch.serve import Engine
from repro_torch.serve.kvpool import PoolConfig
from test_torch_ssm import (GRAD_TOL, LOGIT_TOL, LOSS_RTOL, _aliases, carried, f32, hold_parking,
                            leaf_types, reference_step_globals, rel_err)

ARCH = "whisper-tiny"
CROSS_KV_TOL = 0.0625


@pytest.fixture
def ref(monkeypatch):
    """The reference with the jax 0.9 aliases, for one test; its compiled
    primitives stay cached for the module (``tests/test_torch_ssm.py``)."""
    _aliases(monkeypatch)
    yield jzoo


@pytest.fixture(scope="module", autouse=True)
def _clear_jax_caches():
    yield
    jax.clear_caches()


@pytest.fixture(scope="module")
def models():
    return carried(ARCH)


def _audio(B, cfg, seed=0):
    a = (np.random.default_rng(seed).standard_normal((B, cfg.n_audio_ctx, cfg.d_model))
         * 0.5).astype(np.float32)
    return jnp.asarray(a, jnp.bfloat16), torch.from_numpy(a).to(torch.bfloat16)


def test_config_and_specs_match_reference():
    cfg, jcfg = configs.get(ARCH, smoke=True), jconfigs.get(ARCH, smoke=True)
    assert (cfg.n_layers, cfg.n_enc_layers, cfg.n_audio_ctx, cfg.n_heads, cfg.n_kv_heads) == \
        (jcfg.n_layers, jcfg.n_enc_layers, jcfg.n_audio_ctx, 4, 2)
    m, jm = zoo.build(cfg), jzoo.build(jcfg)
    assert m.decode_paged is None and m.prefill_suffix is None
    for shape in SHAPES.values():
        specs, shards = m.input_specs(shape)
        jspecs, jshards = jm.input_specs(shape)
        assert {k: (tuple(v.shape), str(v.dtype).replace("torch.", "")) for k, v in specs.items()} \
            == {k: (tuple(v.shape), str(v.dtype)) for k, v in jspecs.items()}
        assert shards == jshards
    assert specs.get("audio_embeds") is None            # decode takes one token
    train = m.input_specs(SHAPES["train_4k"])[0]["audio_embeds"]
    assert train.dtype == torch.bfloat16 and tuple(train.shape) == (256, 64, 128)
    assert m.param_specs() == jm.param_specs()
    assert zoo.build(configs.get(ARCH)).param_count() == 61_620_864


def test_sin_pos_matches_reference():
    for n, d in ((64, 128), (1500, 384), (7, 10)):
        want = np.asarray(jwhisper._sin_pos(n, d))
        got = whisper._sin_pos(n, d)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
        np.testing.assert_allclose(f32(got.to(torch.bfloat16)),
                                   f32(jnp.asarray(want).astype(jnp.bfloat16)), atol=2**-8)


def test_prefill_and_decode_match_reference(ref, models, record_property):
    jm, jp, m, tp = models
    cfg = m.cfg
    toks = np.random.default_rng(0).integers(0, 512, (2, 24), dtype=np.int32)
    ja, ta = _audio(2, cfg)
    assert leaf_types(m.make_cache(2, 24, device="cpu")) == leaf_types(jm.make_cache(2, 24))
    with jax.disable_jit():
        jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks), "audio_embeds": ja})
    tl, tc = m.prefill(tp, {"tokens": torch.from_numpy(toks), "audio_embeds": ta})
    assert leaf_types(tc) == leaf_types(jc)
    assert tc["k"].shape[3] == cfg.n_heads != cfg.n_kv_heads
    tok = np.asarray([5, 7], np.int32)
    with jax.disable_jit():
        jl1, jc1 = jm.decode(jp, jc, jnp.asarray(tok))
    tl1, tc1 = m.decode(tp, tc, torch.from_numpy(tok))
    assert leaf_types(tc1) == leaf_types(jc1)
    worst = {"prefill": float(np.abs(f32(tl) - f32(jl)).max()),
             "decode": float(np.abs(f32(tl1) - f32(jl1)).max())}
    record_property("logit_err", worst)
    assert max(worst.values()) <= LOGIT_TOL, worst
    for name in ("xk", "xv"):
        assert float(np.abs(f32(tc[name]) - f32(jc[name])).max()) <= CROSS_KV_TOL
        assert tc1[name] is tc[name]                    # decode leaves the cross K/V as it was
    np.testing.assert_array_equal(tc1["length"].numpy(), np.asarray(jc1["length"]))


def test_prefill_then_decode_equals_longer_prefill(models):
    _, _, m, tp = models
    _, ta = _audio(2, m.cfg)
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, 512, (2, 21), dtype=np.int32))
    full_l, full_c = m.prefill(tp, {"tokens": toks, "audio_embeds": ta})
    _, pre = m.prefill(tp, {"tokens": toks[:, :20], "audio_embeds": ta})
    step_l, step_c = m.decode(tp, pre, toks[:, 20])
    assert float((step_l.float() - full_l.float()).abs().max()) <= LOGIT_TOL
    assert torch.equal(step_c["xk"], full_c["xk"])
    assert torch.equal(step_c["k"][:, :, :20], full_c["k"][:, :, :20])


def test_forward_train_loss_and_grads(ref, models, record_property):
    jm, jp, m, tp = models
    ja, ta = _audio(2, m.cfg, seed=1)
    arr = np.random.default_rng(0).integers(0, 512, (2, 41)).astype(np.int32)
    jb = {"tokens": jnp.asarray(arr[:, :-1]), "labels": jnp.asarray(arr[:, 1:]),
          "audio_embeds": ja}
    with jax.disable_jit():
        (jl, _), jg = jax.value_and_grad(jm.train_loss, has_aux=True)(jp, jb)
    flat = [p.detach().requires_grad_(True) for p in pytree.leaves(tp)]
    loss, _ = m.train_loss(pytree.unflatten(tp, flat),
                           {"tokens": torch.from_numpy(arr[:, :-1].copy()),
                            "labels": torch.from_numpy(arr[:, 1:].copy()),
                            "audio_embeds": ta})
    grads = torch.autograd.grad(loss, flat)
    assert abs(float(loss.detach()) - float(jl)) <= LOSS_RTOL * abs(float(jl))
    worst = max(rel_err(g, w) for g, w in zip(grads, jax.tree.leaves(jg)))
    record_property("grad_err", worst)
    assert worst <= GRAD_TOL
    with pytest.raises(KeyError, match="audio_embeds"):
        m.train_loss(tp, {"tokens": torch.from_numpy(arr[:, :-1].copy()),
                          "labels": torch.from_numpy(arr[:, 1:].copy())})


def test_generate_with_parking_matches_the_reference(ref, models, record_property):
    jm, jp, m, tp = models
    toks = np.random.default_rng(3).integers(0, 512, (2, 24), dtype=np.int32)
    ja, ta = _audio(2, m.cfg, seed=3)
    names = hold_parking(m, tp, jm, jp, {"tokens": toks, "audio_embeds": ta},
                         {"tokens": jnp.asarray(toks), "audio_embeds": ja}, 6, record_property)
    assert names == ["k", "v", "xk", "xv"]


def test_no_paged_pool(models):
    _, _, m, tp = models
    eng = Engine(m, tp, device="cpu", pool=PoolConfig(num_pages=4, page_size=8,
                                                      seq_capacity=32, eb=1e-4))
    with pytest.raises(NotImplementedError, match="plain k/v/length caches"):
        eng.make_pool()


def test_trainer_fails_without_audio_as_the_reference(ref, models):
    """The ``Trainer`` feeds tokens and labels only, in both packages
    (``repro/train/trainer.py:122``), and whisper's step needs ``audio_embeds``:
    the reference's first step raises on its input shardings (which name
    ``audio_embeds``), the port's where the loss reads it."""
    import torch.distributed as dist
    from repro.configs.base import ShapeConfig as JShape
    from repro.data.tokens import TokenStream as JStream
    from repro.launch import mesh as jmesh
    from repro.train import TrainConfig as JTrainConfig
    from repro.train.trainer import Trainer as JTrainer
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.tokens import TokenStream
    from repro_torch.launch import mesh as lmesh
    from repro_torch.train import TrainConfig, Trainer
    jm, _, m, tp = models
    with reference_step_globals():
        jt = JTrainer(jm, JShape("tiny", 16, 2, "train"), jmesh.make_local_mesh(),
                      JTrainConfig(), stream=JStream(512, 16, 2, seed=0))
        with pytest.raises(ValueError, match="audio_embeds"):
            jt.run(1)
    owns = lmesh.start_local_group("cpu")
    try:
        t = Trainer(m, ShapeConfig("tiny", 16, 2, "train"), lmesh.make_local_mesh(device="cpu"),
                    TrainConfig(), stream=TokenStream(512, 16, 2, seed=0), init_params=tp,
                    device="cpu")
        with pytest.raises(KeyError, match="audio_embeds"):
            t.run(1)
    finally:
        obs.reset()
        obs.clear_events()
        if owns:
            dist.destroy_process_group()


def test_launch_serve_kv_compress_on_the_cpu(capsys):
    from repro_torch.launch import serve as launch_serve
    obs.reset()
    out = launch_serve.main(["--arch", ARCH, "--smoke", "--kv-compress", "--device", "cpu",
                             "--prompt-len", "24", "--tokens", "4"])
    text = capsys.readouterr().out
    assert f"{ARCH}-smoke: generated (2, 4) tokens on cpu" in text and "KV parked" in text
    assert tuple(out["tokens"].shape) == (2, 4) and out["parked_bytes"] > 0
    with pytest.raises(NotImplementedError, match="plain k/v/length caches"):
        launch_serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--paged"])
    obs.reset()
    obs.clear_events()
