"""Training launcher: real steps of an LM config; the counterpart of
`repro/launch/train.py`.

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \
      --steps 50 --batch 8 --seq 256 [--ckpt DIR] [--device cpu]

A step is `lm_loss` -> backward -> optional int8 error-feedback gradient
compression -> AdamW with a cosine warm-up schedule.  Fault tolerance:
the run resumes from the newest snapshot in `--ckpt`; `--fail-at N`
exits with code 42 before step N (the restart contract: the resumed run
continues bit for bit).  Runs on the card unless `--device cpu`.

Only `--mesh 1x1` runs: the mesh, the `DistCtx` and the sharding specs
need a device mesh, which the port has not taken on.
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import time

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.core.engine import resolve_device
from repro_torch.data.tokens import TokenStream
from repro_torch.models import transformer as tfm
from repro_torch.optim import compression
from repro_torch.optim.adamw import AdamW, cosine_warmup


def reduced_lm_config(cfg, layers=4, d_model=128, n_heads=4, n_kv=2,
                      d_head=32, d_ff=256, vocab=1024):
    """Shrink an assigned config to a trainable-on-CPU size, keeping its
    family structure (MoE stays MoE, activation stays)."""
    moe = cfg.moe
    if moe is not None:
        moe = dataclasses.replace(moe, n_experts=min(moe.n_experts, 8),
                                  d_ff_expert=d_ff)
    return dataclasses.replace(
        cfg, n_layers=layers, d_model=d_model, n_heads=n_heads, n_kv=n_kv,
        d_head=d_head, d_ff=d_ff, vocab=vocab, moe=moe, dtype="float32",
        q_chunk=64, kv_chunk=64, remat_block=1)


def train_state(params: tfm.LM, opt: AdamW, err):
    """The snapshot tree of a run: parameters, AdamW's step count and
    float32 moments (zeros before the first step) and the compression
    error, keyed by parameter name."""
    named = dict(params.named_parameters())
    moments = {key: {} for key in ("m", "v")}
    for name, p in named.items():
        st = opt.state[p]
        for key in moments:
            moments[key][name] = st[key] if st else torch.zeros_like(
                p, dtype=torch.float32)
    tree = {"params": {n: p.detach() for n, p in named.items()},
            "opt": {"steps": torch.tensor(opt.steps), **moments}}
    if err is not None:
        tree["err"] = err
    return tree


def load_train_state(tree, params: tfm.LM, opt: AdamW, err) -> None:
    """Put a restored `train_state` tree back into the run, in place."""
    with torch.no_grad():
        for name, p in params.named_parameters():
            p.copy_(tree["params"][name])
            opt.state[p]["m"] = tree["opt"]["m"][name]
            opt.state[p]["v"] = tree["opt"]["v"][name]
    opt.steps = int(tree["opt"]["steps"])
    if err is not None:
        err.update(tree["err"])


def main(argv=None, init_params=None, on_step=None):
    """Run the launcher; returns the last step's loss.  `init_params`
    (the JAX package's `init_lm` tree as numpy arrays) replaces the random
    initial weights; `on_step(step, loss, seconds)` is called after each
    step, `seconds` its host wall time ending in a device sync."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--mesh", default="1x1", help="DxM; only 1x1 runs")
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--fail-at", type=int, default=-1)
    ap.add_argument("--grad-compression", action="store_true")
    ap.add_argument("--full-size", action="store_true",
                    help="use the arch's real config (needs a card)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.mesh != "1x1":
        raise NotImplementedError(
            f"--mesh {args.mesh}: a device mesh (DistCtx, sharding specs) "
            "is not ported; see ROADMAP item 12")
    cfg, family = get_config(args.arch)
    if family != "lm":
        raise SystemExit(f"{args.arch} is not an LM; train.py drives LMs")
    if not args.full_size:
        cfg = reduced_lm_config(cfg)
    dev = resolve_device(args.device)

    if init_params is None:
        params = tfm.init_lm(cfg, torch.Generator(dev).manual_seed(args.seed),
                             device=dev)
    else:
        params = tfm.params_from_numpy(init_params, cfg, device=dev)
    named = dict(params.named_parameters())
    opt = AdamW(named.values(), lr=args.lr,
                schedule=cosine_warmup(10, args.steps))
    err = compression.init_error(named) if args.grad_compression else None

    stream = TokenStream(cfg.vocab, args.batch, args.seq, seed=args.seed)
    ckpt = CheckpointManager(args.ckpt) if args.ckpt else None
    start = 0
    if ckpt and ckpt.latest_step() is not None:
        tree, start = ckpt.restore(train_state(params, opt, err))
        load_train_state(tree, params, opt, err)
        print(f"resumed from step {start}")

    loss = math.nan
    t0 = time.time()
    for step in range(start, args.steps):
        if step == args.fail_at:
            print(f"simulated failure at step {step}")
            if ckpt:
                ckpt.wait()
            raise SystemExit(42)
        t_step = time.perf_counter()
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in stream.batch_at(step).items()}
        value, _ = tfm.lm_loss(params, batch, cfg)
        opt.zero_grad(set_to_none=True)
        value.backward()
        grads = None
        if err is not None:
            # int8 error-feedback compression of the gradient signal
            q, scales, new_err = compression.compress(
                {n: p.grad for n, p in named.items()}, err)
            err.update(new_err)
            deq = compression.decompress(q, scales)
            grads = [deq[n] for n in named]
        opt.step(grads=grads)
        loss = float(value.detach())        # one device sync a step
        if on_step is not None:
            on_step(step, loss, time.perf_counter() - t_step)
        if step % 10 == 0 or step == args.steps - 1:
            print(f"step {step:5d} loss {loss:.4f} "
                  f"({(time.time() - t0):.1f}s)", flush=True)
        if ckpt and (step + 1) % args.ckpt_every == 0:
            ckpt.save(step + 1, train_state(params, opt, err))
    if ckpt:
        ckpt.save(args.steps, train_state(params, opt, err))
        ckpt.wait()
    print(f"final loss {loss:.4f}")
    return loss


if __name__ == "__main__":
    main()
