"""LM training in the port (`models.transformer.lm_loss`, its gradients
and `launch.train`) against the JAX package's, on the JAX package's own
`init_lm` weights (`params_from_numpy`) and the same token batches, in
float32 on the CPU at the reduced configs (`reduced_lm_config`: 4 layers,
d_model 128, at most 8 experts).

Tolerances: the loss within 1e-5 and every gradient leaf within 1e-4 of
its largest |gradient| (the same float32 operations; the port's attention
on the CPU is the full-matrix softmax where JAX runs its blocked one, and
matmuls sum in another order).  `launch.train.main`'s final loss after 8
AdamW steps within 1e-4 of JAX's.  With `--grad-compression` within 2e-3:
the two runs' gradients agree only to float32 rounding, which flips the
int8 value of any element lying within an ulp of a rounding boundary;
each flip moves that gradient element by a whole quantization step, and
AdamW's normalised update magnifies it, so the losses drift apart by more
than 1e-4.  Measured on the CPU at this argv: the compressed runs 4.4e-4
apart after 8 steps, JAX's compressed run and the port's uncompressed one
3.2e-3 apart; at 6 steps the uncompressed port lies nearer (1.2e-4 against
1.6e-3), so the final loss alone cannot tell compression from none.  The
compression inside `train.main` is therefore held bitwise on the port's
own gradients: every step's int8 values, scales, carried error and the
gradient handed to AdamW against JAX's `compress`/`decompress` on the
same inputs.  The resumed run is bitwise the uninterrupted one.
"""
import tempfile

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as jget_config
from repro.launch import train as jtrain
from repro.optim import compression as jcomp
from repro.models import transformer as jtfm
from repro_torch.configs import get_config
from repro_torch.data.tokens import TokenStream
from repro_torch.launch import train
from repro_torch.models import transformer as tfm
from repro_torch.optim import compression
from repro_torch.optim.adamw import AdamW

ARCHS = ("smollm-135m", "granite-moe-1b-a400m")
TRAIN_ARGV = ["--arch", "smollm-135m", "--steps", "8", "--batch", "2",
              "--seq", "64"]


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    arch = request.param
    jcfg = jtrain.reduced_lm_config(jget_config(arch)[0])
    cfg = train.reduced_lm_config(get_config(arch)[0])
    jparams = jtfm.init_lm(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree.map(np.array, jparams)
    batch = TokenStream(cfg.vocab, 2, 48, seed=3).batch_at(1)
    return arch, jcfg, cfg, jparams, tree, batch


def _leaves(params, cfg):
    """(name, tensor) of the port's parameters in the JAX tree's terms:
    per-layer tensors stacked `[L, ...]`."""
    block = "moe" if cfg.moe else "ffn"
    out = {"embed": params.embed, "ln_out": params.ln_out}
    if params.head is not None:
        out["head"] = params.head
    for name in tfm._LAYER_TENSORS:
        out[f"layers/{name}"] = [getattr(p, name) for p in params.layers]
    for key in getattr(params.layers[0], block):
        out[f"layers/{block}/{key}"] = [getattr(p, block)[key]
                                        for p in params.layers]
    return out


def _jax_leaf(tree, name):
    for part in name.split("/"):
        tree = tree[part]
    return np.asarray(tree)


def _grads(params, cfg):
    out = {}
    for name, t in _leaves(params, cfg).items():
        out[name] = (torch.stack([x.grad for x in t]).numpy()
                     if isinstance(t, list) else t.grad.numpy())
    return out


def _port_loss(tree, cfg, batch, remat=None):
    import dataclasses
    if remat is not None:
        cfg = dataclasses.replace(cfg, remat=remat)
    params = tfm.params_from_numpy(tree, cfg, device="cpu")
    loss, parts = tfm.lm_loss(params, {k: torch.from_numpy(v)
                                       for k, v in batch.items()}, cfg)
    loss.backward()
    return params, loss, parts


def test_lm_loss_and_gradients_match_jax(model):
    arch, jcfg, cfg, jparams, tree, batch = model
    (jloss, jparts), jgrads = jax.value_and_grad(
        jtfm.lm_loss, has_aux=True)(jparams, {k: jnp.asarray(v) for k, v in
                                              batch.items()}, jcfg)
    params, loss, parts = _port_loss(tree, cfg, batch)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5,
                               atol=1e-5)
    for key in ("ce", "moe_aux"):
        np.testing.assert_allclose(float(parts[key]), float(jparts[key]),
                                   rtol=1e-5, atol=1e-5)
    if cfg.moe:
        assert float(parts["moe_aux"]) > 0
    got = _grads(params, cfg)
    assert len(got) == len(jax.tree.leaves(jgrads))
    for name, g in got.items():
        want = _jax_leaf(jgrads, name)
        assert g.shape == want.shape, name
        np.testing.assert_allclose(g, want, rtol=0,
                                   atol=1e-4 * np.abs(want).max(),
                                   err_msg=name)


def test_remat_on_and_off_are_bitwise_equal(model):
    """Checkpointed layers recompute the same forward: equal losses and
    gradients, bit for bit."""
    _, _, cfg, _, tree, batch = model
    on, loss_on, _ = _port_loss(tree, cfg, batch, remat=True)
    off, loss_off, _ = _port_loss(tree, cfg, batch, remat=False)
    assert torch.equal(loss_on, loss_off)
    g_on, g_off = _grads(on, cfg), _grads(off, cfg)
    for name in g_on:
        np.testing.assert_array_equal(g_on[name], g_off[name], err_msg=name)


def test_grad_cast_casts_the_cotangent():
    x = torch.ones(3, 4, dtype=torch.bfloat16, requires_grad=True)
    y = tfm.grad_cast(x, torch.bfloat16).float()
    seen = {}
    y.register_hook(lambda g: seen.update(dtype=g.dtype))
    (y * 1.5).sum().backward()
    assert seen["dtype"] == torch.float32          # the f32 cotangent ...
    assert x.grad.dtype == torch.bfloat16          # ... arrives cast
    z = torch.ones(2, requires_grad=True)
    w = tfm.grad_cast(z, torch.bfloat16)
    assert torch.equal(w, z)
    w.backward(torch.full((2,), 1 / 3))
    # rounded to bf16 on the way (autograd hands a float32 input's
    # gradient back in float32)
    assert torch.equal(z.grad, torch.full((2,), 1 / 3).to(
        torch.bfloat16).float())
    assert not torch.equal(z.grad, torch.full((2,), 1 / 3))


def test_embed_lookup_gradient_is_jax_segment_sum():
    rng = np.random.default_rng(4)
    table = rng.normal(size=(50, 8)).astype(np.float32)
    tokens = rng.integers(0, 50, (3, 17))
    tokens[0, :5] = 7                              # repeated ids
    cot = rng.normal(size=(3, 17, 8)).astype(np.float32)
    emb = torch.from_numpy(table).requires_grad_(True)
    out = tfm.embed_lookup(emb, torch.from_numpy(tokens))
    np.testing.assert_array_equal(out.detach().numpy(), table[tokens])
    out.backward(torch.from_numpy(cot))
    want = jax.ops.segment_sum(jnp.asarray(cot.reshape(-1, 8)),
                               jnp.asarray(tokens.reshape(-1)), 50)
    np.testing.assert_allclose(emb.grad.numpy(), np.asarray(want),
                               rtol=1e-6, atol=1e-6)


def _init_tree(arch="smollm-135m", seed=0):
    jcfg = jtrain.reduced_lm_config(jget_config(arch)[0])
    return jax.tree.map(np.array, jtfm.init_lm(jax.random.PRNGKey(seed),
                                               jcfg))


@pytest.mark.parametrize("extra,tol", [([], 1e-4),
                                       (["--grad-compression"], 2e-3)])
def test_train_main_matches_jax(extra, tol):
    """The argv of tests/test_checkpoint.py: 8 steps of batch 2 x 64 from
    JAX's initial weights; the final loss against JAX's `train.main`."""
    want = jtrain.main(TRAIN_ARGV + extra)
    got = train.main(TRAIN_ARGV + extra + ["--device", "cpu"],
                     init_params=_init_tree())
    assert abs(got - want) < tol


def test_train_main_compression_is_jax_bitwise(monkeypatch):
    """Each of the 8 steps of `train.main --grad-compression`: JAX's
    `compress` and `decompress` on the port's gradient and carried error
    give the port's int8 values, scales and new error bit for bit; the
    error carries to the next step; AdamW gets the dequantized
    gradient."""
    seen, given = [], []
    compress, decompress, step = (compression.compress,
                                  compression.decompress, AdamW.step)

    def rec_compress(tree, error):
        out = compress(tree, error)
        seen.append({"g": {k: v.clone() for k, v in tree.items()},
                     "e": {k: v.clone() for k, v in error.items()},
                     "out": out})
        return out

    def rec_decompress(q, scales):
        seen[-1]["deq"] = decompress(q, scales)
        return seen[-1]["deq"]

    def rec_step(self, grads=None):
        given.append(grads)
        return step(self, grads=grads)

    monkeypatch.setattr(compression, "compress", rec_compress)
    monkeypatch.setattr(compression, "decompress", rec_decompress)
    monkeypatch.setattr(AdamW, "step", rec_step)
    train.main(TRAIN_ARGV + ["--grad-compression", "--device", "cpu"],
               init_params=_init_tree())
    assert len(seen) == len(given) == 8
    for i, (rec, grads) in enumerate(zip(seen, given)):
        tq, ts, terr = rec["out"]
        jq, js, jerr = jcomp.compress(
            {k: jnp.asarray(v.numpy()) for k, v in rec["g"].items()},
            {k: jnp.asarray(v.numpy()) for k, v in rec["e"].items()})
        jd = jcomp.decompress(jq, js)
        assert set(jq) == set(tq) == set(rec["deq"])
        for k in tq:
            np.testing.assert_array_equal(tq[k].numpy(), np.asarray(jq[k]))
            np.testing.assert_array_equal(ts[k].numpy(), np.asarray(js[k]))
            np.testing.assert_array_equal(terr[k].numpy(),
                                          np.asarray(jerr[k]))
            np.testing.assert_array_equal(rec["deq"][k].numpy(),
                                          np.asarray(jd[k]))
            if i + 1 < len(seen):
                assert torch.equal(seen[i + 1]["e"][k], terr[k])
        assert [g.data_ptr() for g in grads] == [
            rec["deq"][k].data_ptr() for k in rec["deq"]]


def test_resumed_run_is_bitwise_the_uninterrupted_one():
    """Fail at step 6 with a snapshot every 4 steps, resume: the final
    loss equals the uninterrupted run's bit for bit (the restart
    contract), and the crash exits with code 42."""
    tree = _init_tree()
    argv = TRAIN_ARGV + ["--device", "cpu", "--ckpt-every", "4"]
    with tempfile.TemporaryDirectory() as d1:
        full = train.main(argv + ["--ckpt", d1], init_params=tree)
    with tempfile.TemporaryDirectory() as d2:
        with pytest.raises(SystemExit) as crash:
            train.main(argv + ["--ckpt", d2, "--fail-at", "6"],
                       init_params=tree)
        assert crash.value.code == 42
        steps = []
        resumed = train.main(argv + ["--ckpt", d2], init_params=tree,
                             on_step=lambda s, loss, sec: steps.append(s))
    assert steps == [4, 5, 6, 7]
    assert resumed == full


def test_training_reduces_loss():
    """The 60-step run of tests/test_system.py learns."""
    loss = train.main(["--arch", "smollm-135m", "--steps", "60", "--batch",
                       "8", "--seq", "64", "--lr", "1e-2", "--device",
                       "cpu"])
    assert loss < 6.5        # ln(1024) = 6.93 at random init


def test_train_refuses_a_mesh_and_a_missing_card():
    """A mesh runs since the mesh slice (tests/test_torch_mesh_training.py);
    one whose blocks would not split evenly is refused before any rank
    starts."""
    with pytest.raises(ValueError, match="does not split"):
        train.main(TRAIN_ARGV + ["--mesh", "1x3", "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            train.main(TRAIN_ARGV)
