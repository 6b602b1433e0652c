"""The port's continuous batcher and serve launcher vs the JAX package's,
on the JAX package's own reduced smollm weights (float32, CPU).

Greedy tokens must be equal, not close: the batcher's lists against the
JAX batcher's and against offline greedy generation through the port's
`lm_forward` (the invariant of tests/test_serving.py).
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.launch.train import reduced_lm_config as jreduced
from repro.models import transformer as jtfm
from repro.serving.scheduler import ContinuousBatcher as JBatcher
from repro.serving.scheduler import Request as JRequest
from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.models import transformer as tfm
from repro_torch.serving import ContinuousBatcher, Request

SMALL = dict(layers=2, d_model=64, n_heads=4, n_kv=2, d_head=16, d_ff=96,
             vocab=256)


@pytest.fixture(scope="module")
def model():
    jcfg = jreduced(jget_config("smollm-135m")[0], **SMALL)
    cfg = serve.reduced_lm_config(get_config("smollm-135m")[0], **SMALL)
    jparams = jtfm.init_lm(jax.random.PRNGKey(0), jcfg)
    params = tfm.params_from_numpy(jax.tree.map(np.array, jparams), cfg,
                                   device="cpu")
    return jcfg, cfg, jparams, params


def _offline_greedy(params, cfg, prompt, n):
    toks = list(prompt)
    for _ in range(n):
        logits, _ = tfm.lm_forward(params, torch.tensor([toks]), cfg)
        toks.append(int(torch.argmax(logits[0, -1])))
    return toks[len(prompt):]


def _serve(batcher_cls, request_cls, params, cfg, prompts, slots, max_len,
           max_new, **kw):
    sched = batcher_cls(params, cfg, batch_slots=slots, max_len=max_len, **kw)
    reqs = [request_cls(uid=i, prompt=p, max_new=max_new)
            for i, p in enumerate(prompts)]
    for r in reqs:
        sched.submit(r)
    sched.run()
    return reqs


def test_batcher_matches_jax_batcher_and_offline_generation(model):
    """The prompts of tests/test_serving.py: 3 requests over 2 slots."""
    jcfg, cfg, jparams, params = model
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 256, size=n).astype(np.int32)
               for n in (5, 9, 7)]
    got = _serve(ContinuousBatcher, Request, params, cfg, prompts, 2, 32, 6,
                 device="cpu")
    want = _serve(JBatcher, JRequest, jparams, jcfg, prompts, 2, 32, 6)
    for r, w, p in zip(got, want, prompts):
        assert r.done and len(r.out) == 6
        assert r.out == w.out, (r.uid, r.out, w.out)
        assert r.out == _offline_greedy(params, cfg, p.tolist(), 6)


def test_batcher_more_requests_than_slots(model):
    jcfg, cfg, jparams, params = model
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 256, size=4).astype(np.int32)
               for _ in range(5)]
    got = _serve(ContinuousBatcher, Request, params, cfg, prompts, 2, 24, 3,
                 device="cpu")
    want = _serve(JBatcher, JRequest, jparams, jcfg, prompts, 2, 24, 3)
    assert all(r.done and len(r.out) == 3 for r in got)
    assert [r.out for r in got] == [w.out for w in want]


def test_batcher_retires_at_the_end_of_the_cache(model):
    """A request that would overrun `max_len` retires when its slot's
    length reaches `max_len - 1`, as in the JAX batcher; a prompt that does
    not fit is refused."""
    jcfg, cfg, jparams, params = model
    prompts = [np.arange(10, dtype=np.int32), np.arange(3, dtype=np.int32)]
    got = _serve(ContinuousBatcher, Request, params, cfg, prompts, 1, 14, 50,
                 device="cpu")
    want = _serve(JBatcher, JRequest, jparams, jcfg, prompts, 1, 14, 50)
    assert [r.out for r in got] == [w.out for w in want]
    assert [len(r.out) for r in got] == [4, 11]
    sched = ContinuousBatcher(params, cfg, 1, 8, device="cpu")
    with pytest.raises(ValueError, match="max_len"):
        sched.submit(Request(0, np.arange(8, dtype=np.int32)))


def test_greedy_generate_matches_offline_generation(model):
    _, cfg, _, params = model
    prompts = np.random.default_rng(2).integers(0, 256, (2, 6))
    gen, times = serve.greedy_generate(params, cfg, torch.from_numpy(prompts),
                                       5)
    assert gen.shape == (2, 5) and gen.dtype == torch.int32
    assert set(times) == {"prefill_s", "decode_s"}
    for row, p in zip(gen.tolist(), prompts):
        assert row == _offline_greedy(params, cfg, p.tolist(), 5)


def test_serve_launcher_on_cpu(capsys):
    gen = serve.main(["--device", "cpu", "--batch", "2", "--prompt-len", "8",
                      "--gen", "4", "--seed", "3"])
    assert gen.shape == (2, 4) and gen.device.type == "cpu"
    out = capsys.readouterr().out
    assert "generated (2, 4) tokens" in out and "sample:" in out
    again = serve.main(["--device", "cpu", "--batch", "2", "--prompt-len",
                        "8", "--gen", "4", "--seed", "3"])
    assert torch.equal(gen, again)
