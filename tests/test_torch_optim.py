"""The port's AdamW (`repro_torch.optim.adamw`, a `torch.optim.Optimizer`)
against the JAX package's functional AdamW: five steps on the same
parameters and gradients, with global-norm clipping active and a
`cosine_warmup` schedule, every parameter and moment within 1e-6."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.optim.adamw import AdamW as JaxAdamW
from repro.optim.adamw import cosine_warmup as jcosine
from repro.optim.adamw import global_norm as jglobal_norm
from repro_torch.optim import AdamW, cosine_warmup, global_norm

TOL = dict(rtol=1e-6, atol=1e-6)
SHAPES = {"a": (4, 3), "b": (3,), "c": (2, 2, 5)}


@pytest.mark.parametrize("clip,sched,wd", [(1.0, True, 0.01),
                                           (None, False, 0.0),
                                           (0.5, True, 0.1)])
def test_five_steps_match_jax(clip, sched, wd):
    rng = np.random.default_rng(0)
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in SHAPES.items()}
    grads = [{k: (rng.normal(size=s) * 3).astype(np.float32)
              for k, s in SHAPES.items()} for _ in range(5)]
    jopt = JaxAdamW(lr=1e-2, weight_decay=wd, clip_norm=clip,
                    schedule=jcosine(2, 5) if sched else None)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = jopt.init(jp)
    tp = {k: torch.from_numpy(v.copy()).requires_grad_(True)
          for k, v in params.items()}
    # JAX flattens the dict by sorted key; the optimizer folds the global
    # norm in its parameters' order
    opt = AdamW([tp[k] for k in sorted(tp)], lr=1e-2, weight_decay=wd,
                clip_norm=clip, schedule=cosine_warmup(2, 5) if sched
                else None)
    for g in grads:
        jp, state = jopt.update({k: jnp.asarray(v) for k, v in g.items()},
                                state, jp)
        for k, v in g.items():
            tp[k].grad = torch.from_numpy(v)
        opt.step()
        for k in SHAPES:
            np.testing.assert_allclose(tp[k].detach().numpy(),
                                       np.asarray(jp[k]), **TOL)
            np.testing.assert_allclose(opt.state[tp[k]]["m"].numpy(),
                                       np.asarray(state.m[k]), **TOL)
            np.testing.assert_allclose(opt.state[tp[k]]["v"].numpy(),
                                       np.asarray(state.v[k]), **TOL)
    assert opt.steps == int(state.step) == 5


def test_schedule_and_global_norm_match_jax():
    for step in range(0, 12):
        np.testing.assert_allclose(
            float(cosine_warmup(3, 10, floor=0.2)(step)),
            float(jcosine(3, 10, floor=0.2)(jnp.asarray(step))), **TOL)
    rng = np.random.default_rng(1)
    xs = [rng.normal(size=s).astype(np.float32) for s in SHAPES.values()]
    np.testing.assert_allclose(
        float(global_norm([torch.from_numpy(x) for x in xs])),
        float(jglobal_norm([jnp.asarray(x) for x in xs])), **TOL)


def test_missing_gradient_counts_as_zero():
    """A parameter without a gradient still decays, as every leaf does in
    the JAX update."""
    p = torch.ones(3, requires_grad=True)
    AdamW([p], lr=0.1, weight_decay=0.5).step()
    np.testing.assert_allclose(p.detach().numpy(), 1 - 0.1 * 0.5, **TOL)


# ----------------------------------------- gradient compression, token data
from repro.data.tokens import TokenStream as JaxTokenStream  # noqa: E402
from repro.optim import compression as jcomp  # noqa: E402
from repro_torch.data.tokens import TokenStream  # noqa: E402
from repro_torch.dist.comm import StackedComm  # noqa: E402
from repro_torch.optim import compression  # noqa: E402

COMP_SHAPES = {"w": (300, 70), "b": (70,), "s": (5,)}


def _grad_tree(rng, scale=1e-3):
    return {k: (rng.normal(size=s) * scale).astype(np.float32)
            for k, s in COMP_SHAPES.items()}


def test_compress_and_decompress_are_bitwise_jax():
    """Two error-feedback rounds: int8 values, scales, errors and the
    dequantized tree equal to the JAX package's bit for bit (the same
    float32 arithmetic; round half to even on both)."""
    rng = np.random.default_rng(0)
    jerr = jcomp.init_error({k: jnp.zeros(s) for k, s in COMP_SHAPES.items()})
    terr = compression.init_error({k: torch.zeros(s)
                                   for k, s in COMP_SHAPES.items()})
    for scale in (1e-3, 4.0):
        g = _grad_tree(rng, scale)
        g["s"][:] = [0.5, -1.5, 2.5, 127.0, 0.0]     # halves round to even
        jq, js, jerr = jcomp.compress({k: jnp.asarray(v) for k, v in
                                       g.items()}, jerr)
        tq, ts, terr = compression.compress({k: torch.from_numpy(v) for k, v
                                             in g.items()}, terr)
        jd = jcomp.decompress(jq, js)
        td = compression.decompress(tq, ts)
        for k in COMP_SHAPES:
            assert tq[k].dtype == torch.int8
            np.testing.assert_array_equal(tq[k].numpy(), np.asarray(jq[k]))
            assert float(ts[k]) == float(js[k])
            np.testing.assert_array_equal(terr[k].numpy(),
                                          np.asarray(jerr[k]))
            np.testing.assert_array_equal(td[k].numpy(), np.asarray(jd[k]))


def test_compressed_psum_over_stacked_shards_matches_jax():
    """k = 4 shards stacked: the int32 sum of the shards' int8 values
    times the mean scale, and each shard's new error, against JAX's
    `compressed_psum` under `vmap` with the same axis name.  The int8 sums
    and errors are exact; the mean scale sums four float32 scales, whose
    order XLA picks: within 1e-6."""
    rng = np.random.default_rng(1)
    k = 4
    g = {n: np.stack([_grad_tree(rng)[n] for _ in range(k)])
         for n in COMP_SHAPES}
    err = {n: (rng.normal(size=a.shape) * 1e-6).astype(np.float32)
           for n, a in g.items()}
    comm = StackedComm(k)
    out, new_err = compression.compressed_psum(
        {n: torch.from_numpy(a) for n, a in g.items()},
        {n: torch.from_numpy(a) for n, a in err.items()}, comm)
    jout, jerr = jax.vmap(lambda t, e: jcomp.compressed_psum(t, e, "i"),
                          axis_name="i")(
        {n: jnp.asarray(a) for n, a in g.items()},
        {n: jnp.asarray(a) for n, a in err.items()})
    for n in COMP_SHAPES:
        np.testing.assert_array_equal(new_err[n].numpy(),
                                      np.asarray(jerr[n]))
        np.testing.assert_allclose(out[n].numpy(), np.asarray(jout[n]),
                                   rtol=1e-6, atol=0)
        for row in out[n][1:]:                    # every shard holds the sum
            assert torch.equal(row, out[n][0])
    assert comm.values > 0


@pytest.mark.parametrize("step,rank,world", [(0, 0, 1), (3, 0, 1), (7, 1, 2),
                                             (11, 3, 4), (2, 0, 4)])
def test_token_stream_batches_are_bitwise_jax(step, rank, world):
    ours = TokenStream(1000, 8, 33, seed=5).batch_at(step, rank, world)
    theirs = JaxTokenStream(1000, 8, 33, seed=5).batch_at(step, rank, world)
    assert set(ours) == set(theirs) == {"tokens", "labels"}
    for key in ours:
        assert ours[key].dtype == theirs[key].dtype
        np.testing.assert_array_equal(ours[key], theirs[key])


def test_token_stream_reads_a_corpus_file_as_jax(tmp_path):
    path = tmp_path / "corpus.bin"
    np.random.default_rng(2).integers(0, 60000, 5000).astype(
        np.uint16).tofile(path)
    ours = TokenStream(50000, 4, 65, seed=1, path=str(path)).batch_at(3)
    theirs = JaxTokenStream(50000, 4, 65, seed=1, path=str(path)).batch_at(3)
    for key in ours:
        np.testing.assert_array_equal(ours[key], theirs[key])
    assert ours["tokens"].max() < 50000          # clipped to the vocab
    with pytest.raises(ValueError, match="does not split"):
        TokenStream(10, 6, 4).batch_at(0, 0, 4)
