"""The port's dense LM (`repro_torch.models.transformer`) vs the JAX
package's, on the JAX package's own `init_lm` weights carried over by
`params_from_numpy`, in float32 on the CPU.

Tolerance: logits within 1e-4 and KV caches within 1e-5.  Both packages
run the same float32 operations; the last bits differ between the two
libraries' matmul summation orders and transcendental functions, and the
port's chunked attention on the CPU is the full-matrix softmax where JAX
runs its blocked one (2e-5 apart on their own, tests/test_attention.py),
which two layers and the head carry to the logits.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs.base import LM_SHAPES as JAX_LM_SHAPES
from repro.launch.train import reduced_lm_config as jreduced
from repro.models import transformer as jtfm
from repro_torch.configs import get_config
from repro_torch.configs.base import LM_SHAPES, LMConfig
from repro_torch.launch.serve import reduced_lm_config
from repro_torch.models import transformer as tfm

ARCHS = ("smollm-135m", "nemotron-4-15b")
SMALL = dict(layers=2, d_model=64, n_heads=4, n_kv=2, d_head=16, d_ff=96,
             vocab=256)


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    arch = request.param
    jcfg = jreduced(jget_config(arch)[0], **SMALL)
    cfg = reduced_lm_config(get_config(arch)[0], **SMALL)
    jparams = jtfm.init_lm(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree.map(np.array, jparams)   # writable copies
    return arch, jcfg, cfg, jparams, tree, tfm.params_from_numpy(
        tree, cfg, device="cpu")


def _tokens(seed, b, s, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


def test_configs_match_the_jax_package():
    """The same fields and values, dense and MoE, and the same step shapes;
    param_dtype is a torch dtype."""
    for arch in ("smollm-135m", "nemotron-4-15b", "command-r-plus-104b",
                 "qwen3-moe-30b-a3b", "granite-moe-1b-a400m"):
        cfg, fam = get_config(arch)
        jcfg, jfam = jget_config(arch)
        assert fam == jfam == "lm"
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        assert cfg.padded_vocab == jcfg.padded_vocab
        assert cfg.param_count() == jcfg.param_count()
        assert cfg.active_param_count() == jcfg.active_param_count()
        assert cfg.param_dtype == torch.bfloat16
        small = dataclasses.asdict(reduced_lm_config(cfg, **SMALL))
        assert small == dataclasses.asdict(jreduced(jcfg, **SMALL))
    assert get_config("qwen3-moe-30b-a3b")[0].moe.n_experts == 128
    assert [f.name for f in dataclasses.fields(LMConfig)] == [
        f.name for f in dataclasses.fields(type(jget_config(ARCHS[0])[0]))]
    assert [dataclasses.asdict(s) for s in LM_SHAPES] == [
        dataclasses.asdict(s) for s in JAX_LM_SHAPES]
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("no-such-arch")
    assert get_config("gcn-cora")[1] == "gnn"     # the GNN slice's config


def test_params_from_numpy_round_trip(model):
    arch, _, cfg, _, tree, params = model
    assert torch.equal(params.embed, torch.from_numpy(tree["embed"]))
    assert torch.equal(params.head, torch.from_numpy(tree["head"]))
    assert torch.equal(params.ln_out, torch.from_numpy(tree["ln_out"]))
    assert len(params.layers) == cfg.n_layers
    for i, layer in enumerate(params.layers):
        for name in ("ln_attn", "wq", "wk", "wv", "wo", "ln_ffn"):
            assert torch.equal(getattr(layer, name),
                               torch.from_numpy(tree["layers"][name][i]))
        assert set(layer.ffn) == set(tree["layers"]["ffn"])
        for name, arr in tree["layers"]["ffn"].items():
            assert torch.equal(layer.ffn[name], torch.from_numpy(arr[i]))
    assert ("w_gate" in params.layers[0].ffn) == cfg.gated
    n = sum(p.numel() for p in params.parameters())
    # param_count counts the unpadded vocab; the tensors hold padded rows
    assert n == cfg.param_count() + 2 * (cfg.padded_vocab - cfg.vocab) * \
        cfg.d_model


def test_params_from_numpy_refuses_moe_and_a_missing_head(model):
    """A dense tree for an MoE config is refused, and so is a missing
    head; the MoE tree itself round-trips (`test_moe_params_from_numpy_
    round_trip`)."""
    _, _, cfg, _, tree, _ = model
    moe_cfg = reduced_lm_config(get_config("smollm-135m")[0], **SMALL)
    from repro_torch.configs.base import MoESpec
    moe_cfg = dataclasses.replace(moe_cfg, moe=MoESpec(4, 2, 32))
    with pytest.raises(ValueError, match="no 'moe'"):
        tfm.params_from_numpy(tree, moe_cfg, device="cpu")
    headless = {k: v for k, v in tree.items() if k != "head"}
    with pytest.raises(ValueError, match="head"):
        tfm.params_from_numpy(headless, cfg, device="cpu")


def test_lm_forward_matches_jax(model):
    _, jcfg, cfg, jparams, _, params = model
    toks = _tokens(0, 2, 21)
    got, aux = tfm.lm_forward(params, torch.from_numpy(toks), cfg)
    want, _ = jtfm.lm_forward(jparams, jnp.asarray(toks), jcfg)
    assert got.shape == (2, 21, cfg.padded_vocab)
    assert float(aux) == 0.0                      # dense: no MoE aux loss
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-4)


def test_prefill_and_three_decode_steps_match_jax(model):
    _, jcfg, cfg, jparams, _, params = model
    toks = _tokens(1, 3, 11)
    max_len = 16
    logits, cache = tfm.prefill(params, torch.from_numpy(toks), cfg,
                                max_len=max_len)
    jlogits, jcache = jtfm.prefill(jparams, jnp.asarray(toks), jcfg,
                                   max_len=max_len)

    def check(logits, cache, jlogits, jcache):
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   rtol=1e-4, atol=1e-4)
        for key in ("k", "v"):
            assert cache[key].shape == jcache[key].shape
            np.testing.assert_allclose(cache[key].numpy(),
                                       np.asarray(jcache[key]), rtol=1e-5,
                                       atol=1e-5)
        np.testing.assert_array_equal(cache["len"].numpy(),
                                      np.asarray(jcache["len"]))

    check(logits, cache, jlogits, jcache)
    tok = torch.argmax(logits, -1).to(torch.int32)
    for _ in range(3):
        logits, cache = tfm.decode_step(params, cache, tok, cfg)
        jlogits, jcache = jtfm.decode_step(jparams, jcache,
                                           jnp.asarray(tok.numpy()), jcfg)
        check(logits, cache, jlogits, jcache)
        tok = torch.argmax(logits, -1).to(torch.int32)


def test_decode_step_writes_every_slot_clamped(model):
    """Free slots (len 0) write at position 0, and a slot at the end of
    the cache writes at the last position (the clamp of JAX's
    dynamic_update_slice), exactly as the JAX step does."""
    _, jcfg, cfg, jparams, _, params = model
    rng = np.random.default_rng(2)
    shape = (cfg.n_layers, 3, 8, cfg.n_kv, cfg.d_head)
    k0, v0 = rng.normal(size=shape).astype(np.float32), rng.normal(
        size=shape).astype(np.float32)
    lens = np.array([0, 5, 9], np.int32)
    tok = np.array([3, 7, 11], np.int32)
    cache = {"k": torch.from_numpy(k0.copy()), "v": torch.from_numpy(v0.copy()),
             "len": torch.from_numpy(lens.copy())}
    logits, cache = tfm.decode_step(params, cache, torch.from_numpy(tok), cfg)
    jlogits, jcache = jtfm.decode_step(
        jparams, {"k": jnp.asarray(k0), "v": jnp.asarray(v0),
                  "len": jnp.asarray(lens)}, jnp.asarray(tok), jcfg)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=1e-4,
                               atol=1e-4)
    for key, before in (("k", k0), ("v", v0)):
        got = cache[key].numpy()
        np.testing.assert_allclose(got, np.asarray(jcache[key]), rtol=1e-5,
                                   atol=1e-5)
        changed = np.argwhere((got != before).any(axis=(0, 3, 4)))
        assert changed.tolist() == [[0, 0], [1, 5], [2, 7]]
    assert cache["len"].tolist() == [1, 6, 10]


def test_init_lm_shapes_dtypes_and_seed():
    cfg = reduced_lm_config(get_config("smollm-135m")[0], **SMALL)
    cfg = dataclasses.replace(cfg, dtype="bfloat16")
    a = tfm.init_lm(cfg, torch.Generator().manual_seed(3), device="cpu")
    b = tfm.init_lm(cfg, torch.Generator().manual_seed(3), device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(a.parameters(),
                                                 b.parameters()))
    assert {p.dtype for p in a.parameters()} == {torch.bfloat16}
    assert a.embed.shape == (cfg.padded_vocab, cfg.d_model)
    assert a.layers[1].wq.shape == (cfg.d_model, cfg.n_heads * cfg.d_head)
    assert a.head.shape == (cfg.d_model, cfg.padded_vocab)
    std = a.layers[0].wq.float().std().item()
    assert abs(std - cfg.d_model ** -0.5) < 0.1 * cfg.d_model ** -0.5
    with torch.no_grad():
        logits, _ = tfm.lm_forward(a, torch.from_numpy(_tokens(4, 1, 9)),
                                   cfg)
    assert logits.dtype == torch.bfloat16 and torch.isfinite(logits).all()
    with pytest.raises(ValueError, match="generator"):
        tfm.init_lm(cfg, torch.Generator(), device="meta")


# ---------------------------------------------------------- MoE configs
@pytest.fixture(scope="module")
def granite():
    """Reduced granite-moe-1b-a400m (`reduced_lm_config`: 4 layers,
    d_model 128, 8 experts top-8) on JAX's `init_lm` weights."""
    jcfg = jreduced(jget_config("granite-moe-1b-a400m")[0])
    cfg = reduced_lm_config(get_config("granite-moe-1b-a400m")[0])
    jparams = jtfm.init_lm(jax.random.PRNGKey(1), jcfg)
    tree = jax.tree.map(np.array, jparams)
    return jcfg, cfg, jparams, tree, tfm.params_from_numpy(tree, cfg,
                                                           device="cpu")


def test_moe_params_from_numpy_round_trip(granite):
    """The stacked `[L, E, ...]` expert tensors land in each layer's
    `moe` dict as they are (the router float32), and init_lm builds the
    same structure."""
    _, cfg, _, tree, params = granite
    for i, layer in enumerate(params.layers):
        assert not hasattr(layer, "ffn")
        assert set(layer.moe) == set(tree["layers"]["moe"]) == {
            "router", "w_in", "w_gate", "w_out"}
        for name, arr in tree["layers"]["moe"].items():
            assert torch.equal(layer.moe[name], torch.from_numpy(arr[i]))
    assert params.layers[0].moe["w_in"].shape == (
        cfg.moe.n_experts, cfg.d_model, cfg.moe.d_ff_expert)
    n = sum(p.numel() for p in params.parameters())
    assert n == cfg.param_count() + 2 * (cfg.padded_vocab - cfg.vocab) * \
        cfg.d_model
    bf = dataclasses.replace(cfg, dtype="bfloat16")
    init = tfm.init_lm(bf, torch.Generator().manual_seed(0), device="cpu")
    assert [n for n, _ in init.named_parameters()] == [
        n for n, _ in params.named_parameters()]
    assert init.layers[1].moe["router"].dtype == torch.float32
    assert init.layers[1].moe["w_out"].dtype == torch.bfloat16


def test_moe_prefill_and_three_decode_steps_match_jax(granite):
    """Reduced granite: prefill plus three decode steps, logits within
    1e-5 of JAX's and the caches within 1e-5."""
    jcfg, cfg, jparams, _, params = granite
    toks = _tokens(5, 2, 13, vocab=cfg.vocab)
    logits, cache = tfm.prefill(params, torch.from_numpy(toks), cfg,
                                max_len=17)
    jlogits, jcache = jtfm.prefill(jparams, jnp.asarray(toks), jcfg,
                                   max_len=17)
    for step in range(4):
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   rtol=1e-5, atol=1e-5)
        for key in ("k", "v"):
            np.testing.assert_allclose(cache[key].numpy(),
                                       np.asarray(jcache[key]), rtol=1e-5,
                                       atol=1e-5)
        if step == 3:
            break
        tok = torch.argmax(logits, -1).to(torch.int32)
        logits, cache = tfm.decode_step(params, cache, tok, cfg)
        jlogits, jcache = jtfm.decode_step(jparams, jcache,
                                           jnp.asarray(tok.numpy()), jcfg)


def test_moe_lm_forward_matches_jax(granite):
    jcfg, cfg, jparams, _, params = granite
    toks = _tokens(6, 2, 19, vocab=cfg.vocab)
    with torch.no_grad():
        got, aux = tfm.lm_forward(params, torch.from_numpy(toks), cfg)
    want, jaux = jtfm.lm_forward(jparams, jnp.asarray(toks), jcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)
