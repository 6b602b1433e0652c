"""The port's MoE layer (`repro_torch.nn.moe`) vs the JAX package's, on
the JAX package's `moe_init` weights and the same numpy tokens, in float32
on the CPU.

Tolerances: outputs and the aux loss within 1e-5 (the same float32
operations; the last bits differ in the libraries' matmul and softmax
summation orders); the routing (top-k experts, kept hits, token map) must
be equal.  Gradients within 1e-4 of each leaf's largest |gradient|, at
top_k >= 2: with top_k = 1 the renormalised weight is exactly 1 and the
router's gradient is the aux term plus the float32 cancellation residue
of the weight's own derivative, which no relative tolerance describes.  The expert-sharded form sums shard partials in
shard order where the local call sums all hits in one combine: 1e-6.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.nn import moe as jmoe
from repro_torch.dist.comm import StackedComm
from repro_torch.dist.world import run_world
from repro_torch.nn import moe as tmoe

import torch_dist_cases as cases

D, F = 32, 64
FWD = dict(rtol=1e-5, atol=1e-5)
SHARD_TOL = 1e-6
WORLD_TIMEOUT = 240.0


def _params(e, gated, seed=0, d=D, f=F):
    tree = jmoe.moe_init(jax.random.PRNGKey(seed), d, f, e, gated)
    return tree, {k: np.array(v) for k, v in tree.items()}


def _x(t, seed=2, d=D):
    return np.random.default_rng(seed).normal(size=(t, d)).astype(np.float32)


def _t(tree, grad=False):
    return {k: torch.from_numpy(v.copy()).requires_grad_(grad)
            for k, v in tree.items()}


def _jax_dispatch(jp, x, top_k, n_experts, cf, e_loc=None, my=0):
    """The routing and packing of `repro/nn/moe.py::moe_ffn`, step for
    step: (top_i, tokmap [e_loc, cap], valid [e_loc, cap])."""
    e_loc = e_loc or n_experts
    t = x.shape[0]
    gates = jax.nn.softmax(x.astype(jnp.float32) @ jp["router"], axis=-1)
    _, top_i = jax.lax.top_k(gates, top_k)
    flat_e = top_i.reshape(-1)
    flat_t = jnp.repeat(jnp.arange(t), top_k)
    mine = (flat_e // e_loc) == my
    le = jnp.where(mine, flat_e - my * e_loc, e_loc)
    order = jnp.argsort(le, stable=True)
    le_s, t_s = le[order], flat_t[order]
    seg_counts = jnp.zeros(e_loc + 1, jnp.int32).at[le_s].add(1)
    offsets = jnp.concatenate([jnp.zeros(1, jnp.int32),
                               jnp.cumsum(seg_counts)[:-1]])
    pos = jnp.arange(t * top_k, dtype=jnp.int32) - offsets[le_s]
    cap = int(max(8, round(t * top_k / n_experts * cf)))
    keep = (le_s < e_loc) & (pos < cap)
    tgt_e = jnp.where(keep, le_s, e_loc)
    tgt_c = jnp.where(keep, pos, 0)
    tokmap = jnp.zeros((e_loc + 1, cap), jnp.int32).at[tgt_e, tgt_c].set(
        t_s.astype(jnp.int32))
    valid = jnp.zeros((e_loc + 1, cap), bool).at[tgt_e, tgt_c].set(keep)
    return (np.asarray(top_i), np.asarray(tokmap[:e_loc]),
            np.asarray(valid[:e_loc]))


def _port_dispatch(params, x, top_k, n_experts, cf, e_loc=None, my=0):
    e_loc = e_loc or n_experts
    _, top_w, top_i = tmoe.route(params["router"], x, top_k)
    cap = tmoe.capacity(x.shape[0], top_k, n_experts, cf)
    tokmap, _, valid = tmoe.dispatch(top_w, top_i, e_loc, my, cap, x.dtype)
    return (top_i.numpy(), tokmap.reshape(e_loc, cap).numpy(),
            valid.reshape(e_loc, cap).numpy())


def _check_routing(jp, params, x, k, e, cf, **shard):
    jtop, jtok, jvalid = _jax_dispatch(jp, jnp.asarray(x), k, e, cf, **shard)
    ttop, ttok, tvalid = _port_dispatch(params, torch.from_numpy(x), k, e,
                                        cf, **shard)
    np.testing.assert_array_equal(ttop, jtop)
    np.testing.assert_array_equal(tvalid, jvalid)
    np.testing.assert_array_equal(ttok, jtok)
    return jvalid


# (T, E, K) of tests/test_moe.py, gated and not, at ample capacity
AMPLE = [(t, e, k, g) for g in (True, False)
         for t, e, k in ((64, 8, 2), (128, 16, 4), (32, 4, 1))]


@pytest.mark.parametrize("t,e,k,gated", AMPLE)
def test_moe_ffn_matches_jax_at_ample_capacity(t, e, k, gated):
    jp, tree = _params(e, gated)
    x = _x(t)
    params = _t(tree)
    out, aux = tmoe.moe_ffn(params, torch.from_numpy(x), k, e,
                            capacity_factor=float(e))
    jout, jaux = jmoe.moe_ffn(jp, jnp.asarray(x), k, e,
                              capacity_factor=float(e))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **FWD)
    np.testing.assert_allclose(float(aux), float(jaux), **FWD)
    valid = _check_routing(jp, params, x, k, e, float(e))
    assert valid.sum() == t * k                       # nothing dropped
    # the dense oracle, the port's and the JAX package's
    ref = tmoe.moe_ffn_reference(params, torch.from_numpy(x), k, e)
    jref = jmoe.moe_ffn_reference(jp, jnp.asarray(x), k, e)
    np.testing.assert_allclose(ref.numpy(), np.asarray(jref), **FWD)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), **FWD)


@pytest.mark.parametrize("t,e,k,cf", [(256, 8, 2, 1.0), (200, 8, 2, 1.25),
                                      (96, 16, 4, 0.5)])
def test_moe_ffn_capacity_drops_match_jax(t, e, k, cf):
    """Below ample capacity the same hits are dropped: equal kept sets
    and token maps, outputs within 1e-5."""
    jp, tree = _params(e, True, seed=1)
    x = _x(t, seed=3)
    params = _t(tree)
    valid = _check_routing(jp, params, x, k, e, cf)
    assert valid.sum() < t * k                        # some hits dropped
    out, aux = tmoe.moe_ffn(params, torch.from_numpy(x), k, e, cf)
    jout, jaux = jmoe.moe_ffn(jp, jnp.asarray(x), k, e, cf)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **FWD)
    np.testing.assert_allclose(float(aux), float(jaux), **FWD)


def test_top_k_takes_the_lower_index_among_equal_gates():
    """Router columns 1 and 3 equal (and largest): top-2 is (1, 3), the
    order of `jax.lax.top_k`."""
    router = np.zeros((D, 4), np.float32)
    router[:, 1] = router[:, 3] = 1.0
    x = np.abs(_x(5))
    _, _, top_i = tmoe.route(torch.from_numpy(router), torch.from_numpy(x),
                             2)
    _, jtop = jax.lax.top_k(jax.nn.softmax(jnp.asarray(x) @ router), 2)
    assert top_i.tolist() == [[1, 3]] * 5 == np.asarray(jtop).tolist()


def test_capacity_rounds_as_python_does():
    # T·K/E·cf = 10.5 and 11.5: round half to even, floor of 8
    assert tmoe.capacity(42, 2, 8, 1.0) == 10
    assert tmoe.capacity(46, 2, 8, 1.0) == 12
    assert tmoe.capacity(4, 2, 8, 1.0) == 8


@pytest.mark.parametrize("t,e,k,cf", [(64, 4, 2, 4.0), (64, 8, 2, 1.25),
                                      (128, 16, 4, 1.0)])
def test_moe_gradients_match_jax(t, e, k, cf):
    """Gradients of the router, the expert weights and x of
    `mean(out²) + 0.01·aux` against `jax.grad`, within 1e-4 of each
    leaf's largest |gradient|."""
    jp, tree = _params(e, True, seed=2, d=16, f=32)
    x = _x(t, seed=4, d=16)

    def jloss(p, xx):
        out, aux = jmoe.moe_ffn(p, xx, k, e, capacity_factor=cf)
        return (out ** 2).mean() + 0.01 * aux

    jg, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    params = _t(tree, grad=True)
    tx = torch.from_numpy(x).requires_grad_(True)
    out, aux = tmoe.moe_ffn(params, tx, k, e, capacity_factor=cf)
    ((out ** 2).mean() + 0.01 * aux).backward()
    pairs = [(params[n].grad, jg[n]) for n in tree] + [(tx.grad, jgx)]
    for got, want in pairs:
        want = np.asarray(want)
        assert np.abs(want).max() > 0
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("n", [2, 4])
def test_expert_sharded_form_on_stacked_shards(n):
    """k = 2 and 4 expert shards stacked in one process: the whole output
    equals the local call's and the sum of JAX's per-shard partials
    (JAX's `shard_index`, `n_shards`), and each shard's routing is
    JAX's."""
    e, k, t, cf = 8, 2, 96, 1.25
    jp, tree = _params(e, True, seed=5)
    x = _x(t, seed=6)
    got = cases.moe_sharded_case(tree, x, k, e, cf, StackedComm(n))
    local, aux = tmoe.moe_ffn(_t(tree), torch.from_numpy(x), k, e, cf)
    np.testing.assert_allclose(got["out"], local.numpy(), rtol=0,
                               atol=SHARD_TOL)
    assert float(got["aux"]) == float(aux)
    e_loc = e // n
    parts = []
    for s in range(n):
        jl = {name: (a if name == "router" else a[s * e_loc:(s + 1) * e_loc])
              for name, a in jp.items()}
        parts.append(np.asarray(jmoe.moe_ffn(
            jl, jnp.asarray(x), k, e, cf, shard_index=jnp.asarray(s),
            n_shards=n)[0]))
        tl = {name: (a if name == "router" else a[s * e_loc:(s + 1) * e_loc])
              for name, a in tree.items()}
        _check_routing(jp, _t(tl), x, k, e, cf, e_loc=e_loc, my=s)
    np.testing.assert_allclose(got["out"], np.sum(parts, axis=0), rtol=0,
                               atol=SHARD_TOL)


def test_expert_sharded_form_over_two_gloo_ranks(tmp_path):
    """Two CPU ranks, each holding half the experts: every rank's output
    equals the stacked k = 2 run bitwise (the psum folds in shard order on
    both)."""
    e, k, t, cf = 8, 2, 96, 1.25
    _, tree = _params(e, True, seed=5)
    x = _x(t, seed=6)
    done = run_world(cases.moe_rank_main, 2, (tree, x, k, e, cf,
                                              str(tmp_path)),
                     device="cpu", timeout=WORLD_TIMEOUT)
    assert [r.value for r in done] == [0, 1]
    stacked = cases.moe_sharded_case(tree, x, k, e, cf, StackedComm(2))
    for r in range(2):
        with np.load(tmp_path / f"rank{r}.npz") as z:
            np.testing.assert_array_equal(z["out"], stacked["out"])
            np.testing.assert_array_equal(z["aux"], stacked["aux"])


def test_sharded_form_refuses_a_shard_count_mismatch():
    _, tree = _params(8, True)
    with pytest.raises(ValueError, match="expert shards"):
        tmoe.moe_ffn([_t(tree)], torch.from_numpy(_x(8)), 2, 8,
                     comm=StackedComm(2))
    with pytest.raises(ValueError, match="experts a shard"):
        tmoe.moe_ffn([_t(tree), _t(tree)], torch.from_numpy(_x(8)), 2, 8,
                     comm=StackedComm(2))
