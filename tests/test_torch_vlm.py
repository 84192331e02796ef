"""The port's M-RoPE VLM backbone (qwen2-vl-72b) against the reference, on the CPU.

The reference runs in this process with the two jax 0.9 aliases (the
function-scoped ``ref`` fixture); its SMOKE parameters (``model.init(
jax.random.key(0))``, M-RoPE sections (4, 6, 6)) are carried over with
``interop.params_from_reference``, and inputs are numpy arrays from a seed.
Position ids differ across the t/h/w axes where a test says so (an image-like
block of rows and columns), so every section of the rotation is exercised.

Tolerances:

* ``apply_mrope`` in float32: 2e-4 (``cos``/``sin`` of another library), and
  M-RoPE equal to RoPE within 1e-5 when the three ids agree (the
  reference's own check in ``tests/test_attention_ssm.py``);
* logits of prefill and decode: ``LOGIT_TOL`` 0.125 absolute, as the dense
  test; the first layer's K/V bit for bit;
* float32 ``forward_train`` against the compiled reference: loss 2e-5
  relative, each gradient leaf 2e-5 of its max |g|; bfloat16 against the
  reference run op by op: loss 5e-4, each leaf 0.05 of its max |g|;
* whole-cache ``generate`` with parking: the kernel route (the plain versions
  on the CPU) equals the plain route bit for bit, tokens and containers; the
  port's containers of one cache equal the reference's ``compress_cache``
  containers bit for bit; tokens agree with the reference's ``generate`` in
  >= 90% of places (bfloat16 near ties, as ``tests/test_kvpool.py`` allows).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import attention as jatt
from repro.models import zoo as jzoo
from repro_torch import configs, interop, obs, pytree
from repro_torch.configs.base import SHAPES
from repro_torch.models import attention as tatt
from repro_torch.models import zoo
from repro_torch.serve import Engine, KVCompressionConfig
from repro_torch.serve.engine import compress_cache
from repro_torch.serve.kvpool import PoolConfig

ARCH = "qwen2-vl-72b"
TOL = 2e-4
LOGIT_TOL = 0.125
BF16_LOSS_TOL = 5e-4
GRAD_TOL = 0.05


@pytest.fixture
def ref(monkeypatch):
    """The reference's model zoo with the jax 0.9 aliases, for one test."""
    import jax._src.core as jcore
    from jax.experimental.pallas import tpu as pltpu
    monkeypatch.setattr(jax.core, "trace_state_clean", jcore.trace_state_clean, raising=False)
    monkeypatch.setattr(pltpu, "TPUCompilerParams", pltpu.CompilerParams, raising=False)
    yield jzoo
    jax.clear_caches()


@pytest.fixture(scope="module")
def models():
    jm = jzoo.build(jconfigs.get(ARCH, smoke=True))
    jp = jm.init(jax.random.key(0))
    tp = interop.params_from_reference(jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, zoo.build(configs.get(ARCH, smoke=True)), tp


def f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _image_positions(B, S, start=0):
    """t/h/w ids: text positions, then a 4 x 4 image block (one t, rows and
    columns), then text again from past the block."""
    pos = np.broadcast_to(np.arange(start, start + S, dtype=np.int32), (B, 3, S)).copy()
    if S >= 12:
        blk = np.arange(16) if S >= 20 else np.arange(S - 4)
        blk = blk[: S - 4]
        pos[:, 0, 4:4 + len(blk)] = start + 4
        pos[:, 1, 4:4 + len(blk)] = start + 4 + blk // 4
        pos[:, 2, 4:4 + len(blk)] = start + 4 + blk % 4
    return pos


# ---------------------------------------------------------------------------
# M-RoPE
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sections,theta", [((4, 6, 6), 1e6), ((6, 5, 5), 1e4),
                                            ((16, 0, 0), 1e4)])
def test_apply_mrope_matches_reference(sections, theta):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 24, 4, 32)).astype(np.float32)
    pos3 = rng.integers(0, 4096, (2, 3, 24)).astype(np.int32)
    want = jatt.apply_mrope(jnp.asarray(x), jnp.asarray(pos3), sections, theta)
    got = tatt.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos3), sections, theta)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got_b = tatt.apply_mrope(xb, torch.from_numpy(pos3), sections, theta)
    want_b = jatt.apply_mrope(jnp.asarray(x, jnp.bfloat16), jnp.asarray(pos3), sections, theta)
    assert got_b.dtype == torch.bfloat16
    np.testing.assert_allclose(f32(got_b), f32(want_b), atol=0.02)


def test_mrope_matches_rope_when_positions_equal():
    """The reference's check (``tests/test_attention_ssm.py``) on the port: with
    t = h = w ids, M-RoPE is RoPE."""
    B, S, H, D = 1, 8, 2, 32
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((B, S, H, D))
                         .astype(np.float32))
    pos = torch.arange(S, dtype=torch.int32).expand(B, S)
    y1 = tatt.apply_rope(x, pos, theta=1e4)
    y2 = tatt.apply_mrope(x, pos[:, None, :].expand(B, 3, S), (6, 5, 5), theta=1e4)
    np.testing.assert_allclose(y1.numpy(), y2.numpy(), rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="head_dim/2"):
        tatt.apply_mrope(x, pos[:, None, :].expand(B, 3, S), (6, 5, 6))


# ---------------------------------------------------------------------------
# the model (SMOKE, params carried over)
# ---------------------------------------------------------------------------

def test_zoo_gates_the_page_native_paths_as_the_reference(models):
    jm, _, m, _ = models
    assert m.decode_paged is None and m.prefill_suffix is None
    assert jm.decode_paged is None and jm.prefill_suffix is None
    for arch in ("yi-6b", "dbrx-132b"):
        assert zoo.build(configs.get(arch, smoke=True)).decode_paged is not None
    for shape in SHAPES.values():
        specs, shards = m.input_specs(shape)
        jspecs, jshards = jm.input_specs(shape)
        assert {k: tuple(v.shape) for k, v in specs.items()} == \
            {k: tuple(v.shape) for k, v in jspecs.items()}
        assert shards == jshards
    assert tuple(m.input_specs(SHAPES["decode_32k"])[0]["positions"].shape) == (128, 3, 1)


def test_forward_prefill_and_decode(ref, models):
    jm, jp, m, tp = models
    rng = np.random.default_rng(0)
    toks = rng.integers(0, 512, (2, 24), dtype=np.int32)
    batch = {"tokens": toks, "lengths": np.asarray([24, 17], np.int32),
             "positions": _image_positions(2, 24)}
    jl, jc = jm.prefill(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tl, tc = m.prefill(tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(f32(tl), f32(jl), atol=LOGIT_TOL)
    np.testing.assert_array_equal(f32(tc["k"][0]), f32(jc["k"][0]))
    np.testing.assert_allclose(f32(tc["k"]), f32(jc["k"]), atol=LOGIT_TOL)
    np.testing.assert_array_equal(tc["length"].numpy(), np.asarray(jc["length"]))
    # decode from the port's cache in both, by default positions and by given ones
    jcache = {"k": jnp.asarray(f32(tc["k"]), jnp.bfloat16),
              "v": jnp.asarray(f32(tc["v"]), jnp.bfloat16),
              "length": jnp.asarray(tc["length"].numpy())}
    tok = np.asarray([5, 7], np.int32)
    jl0, jc0 = jm.decode(jp, jcache, jnp.asarray(tok))
    tl0, tc0 = m.decode(tp, tc, torch.from_numpy(tok))
    np.testing.assert_allclose(f32(tl0), f32(jl0), atol=LOGIT_TOL)
    np.testing.assert_array_equal(tc0["length"].numpy(), np.asarray(jc0["length"]))
    pos = np.asarray([[[20], [9], [11]], [[13], [13], [2]]], np.int32)      # (B, 3, 1)
    jl1, _ = jm.decode(jp, jcache, jnp.asarray(tok), jnp.asarray(pos))
    tl1, _ = m.decode(tp, tc, torch.from_numpy(tok), positions=torch.from_numpy(pos))
    np.testing.assert_allclose(f32(tl1), f32(jl1), atol=LOGIT_TOL)
    assert not torch.equal(tl0, tl1)               # the given ids move the rotation
    # the default is the cache length on all three axes
    dflt = tc["length"][:, None, None].expand(2, 3, 1)
    tl2, _ = m.decode(tp, tc, torch.from_numpy(tok), positions=dflt)
    assert torch.equal(tl0, tl2)
    with pytest.raises(ValueError, match="positions"):
        m.prefill(tp, {"tokens": torch.from_numpy(toks)})


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_train_loss_and_grads(ref, models, dtype):
    jm, jp, m, tp = models
    if dtype == "float32":
        jp = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
        tp = pytree.tree_map(lambda t: t.to(torch.float32), tp)
    arr = np.random.default_rng(0).integers(0, 512, (4, 33)).astype(np.int32)
    pos = _image_positions(4, 32)
    jb = {"tokens": jnp.asarray(arr[:, :-1]), "labels": jnp.asarray(arr[:, 1:]),
          "positions": jnp.asarray(pos)}
    with jax.disable_jit(dtype == "bfloat16"):
        (jl, _), jg = jax.value_and_grad(jm.train_loss, has_aux=True)(jp, jb)
    flat = [p.detach().requires_grad_(True) for p in pytree.leaves(tp)]
    loss, aux = m.train_loss(pytree.unflatten(tp, flat),
                             {"tokens": torch.from_numpy(arr[:, :-1].copy()),
                              "labels": torch.from_numpy(arr[:, 1:].copy()),
                              "positions": torch.from_numpy(pos)})
    grads = torch.autograd.grad(loss, flat)
    assert torch.equal(loss, aux["xent"])          # no MoE: the aux term is 0
    rtol, gtol = (2e-5 * abs(float(jl)), 2e-5) if dtype == "float32" else (BF16_LOSS_TOL,
                                                                          GRAD_TOL)
    assert abs(float(loss.detach()) - float(jl)) <= rtol
    for g, w in zip(grads, jax.tree.leaves(jg)):
        assert np.abs(f32(g) - f32(w)).max() <= gtol * np.abs(f32(w)).max()


# ---------------------------------------------------------------------------
# serving and training through the entry points
# ---------------------------------------------------------------------------

def test_no_paged_pool_for_mrope(models):
    _, _, m, tp = models
    eng = Engine(m, tp, device="cpu", pool=PoolConfig(num_pages=4, page_size=8,
                                                      seq_capacity=32, eb=1e-4))
    assert not eng.paged_decode_enabled and eng.prefill_suffix is None
    with pytest.raises(NotImplementedError, match="M-RoPE"):
        eng.make_pool()
    with pytest.raises(ValueError, match="no paged decode"):
        eng.decode_step_paged({}, torch.zeros(1, dtype=torch.int32))


def test_generate_with_parking_matches_the_reference(ref, models):
    """``Engine.generate(park_between=True)``, positions broadcast as the launcher
    does: the kernel route equals the plain route bit for bit, the port's
    containers of one cache equal the reference's, and tokens agree."""
    from repro.serve import engine as jengine
    jm, jp, m, tp = models
    B, S = 2, 24
    rng = np.random.default_rng(3)
    toks = rng.integers(0, 512, (B, S), dtype=np.int32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, 3, S)).copy()
    out = {}
    for use_kernels in (True, False):
        kcfg = KVCompressionConfig(enabled=True, eb=1e-4, use_kernels=use_kernels,
                                   min_leaf_size=1024)
        eng = Engine(m, tp, kv_compress=kcfg, device="cpu")
        toks_out, cache = eng.generate({"tokens": toks, "positions": pos}, 6,
                                       park_between=True)
        out[use_kernels] = (toks_out, cache, compress_cache(cache, kcfg))
    assert torch.equal(out[True][0], out[False][0])
    for name in ("k", "v"):
        assert torch.equal(out[True][1][name], out[False][1][name])
        a, b = (interop.to_numpy(out[u][2][name][1]) for u in (True, False))
        for f in a:
            np.testing.assert_array_equal(a[f], b[f], f)
    # the same cache parked by the reference: the same containers
    cache = out[True][1]
    jkcfg = jengine.KVCompressionConfig(enabled=True, eb=1e-4, min_leaf_size=1024)
    jparked = jengine.compress_cache({"k": jnp.asarray(f32(cache["k"]), jnp.bfloat16),
                                      "v": jnp.asarray(f32(cache["v"]), jnp.bfloat16),
                                      "length": jnp.asarray(cache["length"].numpy())}, jkcfg)
    for name in ("k", "v"):
        got, want = interop.to_numpy(out[True][2][name][1]), jparked[name][1]
        for f, leaf in got.items():
            np.testing.assert_array_equal(leaf, np.asarray(getattr(want, f)), f)
    jeng = jengine.Engine(jm, jp, kv_compress=jkcfg)
    jtoks, _ = jeng.generate({"tokens": jnp.asarray(toks), "positions": jnp.asarray(pos)}, 6,
                             park_between=True)
    agree = float((out[True][0].numpy() == np.asarray(jtoks)).mean())
    assert agree >= 0.9, agree


def test_trainer_takes_no_positions_as_in_the_reference(models):
    """The reference's ``Trainer`` feeds tokens and labels only
    (``repro/train/trainer.py:122``), so an M-RoPE model cannot train through
    it; the port's ``Trainer`` keeps that and its step raises."""
    import torch.distributed as dist
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.tokens import TokenStream
    from repro_torch.launch import mesh as lmesh
    from repro_torch.train import TrainConfig, Trainer
    _, _, m, tp = models
    owns = lmesh.start_local_group("cpu")
    try:
        t = Trainer(m, ShapeConfig("tiny", 16, 2, "train"), lmesh.make_local_mesh(device="cpu"),
                    TrainConfig(), stream=TokenStream(512, 16, 2, seed=0), init_params=tp,
                    device="cpu")
        with pytest.raises(ValueError, match="positions"):
            t.run(1)
    finally:
        obs.reset()
        obs.clear_events()
        if owns:
            dist.destroy_process_group()


def test_launch_serve_kv_compress_on_the_cpu(capsys):
    from repro_torch.launch import serve as launch_serve
    obs.reset()
    out = launch_serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--kv-compress",
                             "--prompt-len", "24", "--tokens", "6"])
    text = capsys.readouterr().out
    assert f"{ARCH}-smoke: generated (2, 6) tokens on cpu" in text and "KV parked" in text
    assert tuple(out["tokens"].shape) == (2, 6) and out["parked_bytes"] > 0
    with pytest.raises(NotImplementedError, match="M-RoPE"):
        launch_serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--paged"])
    obs.reset()
    obs.clear_events()
