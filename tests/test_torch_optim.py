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
