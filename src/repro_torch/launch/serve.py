"""Serving launcher: batched prefill + greedy decode on a reduced config
(`launch.train.reduced_lm_config`), dense or MoE; the counterpart of
`repro/launch/serve.py`.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \
      --batch 4 --prompt-len 64 --gen 32 [--device cpu]

Runs on the card unless `--device cpu`.  `greedy_generate` is the flow
itself, for callers that bring their own config and weights.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.engine import resolve_device
from repro_torch.launch.train import reduced_lm_config
from repro_torch.models import transformer as tfm


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def greedy_generate(params: tfm.LM, cfg, prompts: torch.Tensor, gen: int):
    """Batched prefill of `prompts [B, S]`, then `gen - 1` greedy decode
    steps over a cache of `S + gen` positions.  Returns (tokens `[B, gen]`
    int32, {"prefill_s", "decode_s"} on the host clock, each ending in a
    device synchronise)."""
    dev = prompts.device
    max_len = prompts.shape[1] + gen
    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = tfm.prefill(params, prompts, cfg, max_len=max_len)
    tok = torch.argmax(logits, -1).to(torch.int32)
    _sync(dev)
    t1 = time.perf_counter()
    out = [tok]
    for _ in range(gen - 1):
        logits, cache = tfm.decode_step(params, cache, tok, cfg)
        tok = torch.argmax(logits, -1).to(torch.int32)
        out.append(tok)
    _sync(dev)
    t2 = time.perf_counter()
    return torch.stack(out, dim=1), {"prefill_s": t1 - t0,
                                     "decode_s": t2 - t1}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg, family = get_config(args.arch)
    if family != "lm":
        raise SystemExit(f"{args.arch} is not an LM")
    cfg = reduced_lm_config(cfg)
    dev = resolve_device(args.device)
    params = tfm.init_lm(cfg, torch.Generator(dev).manual_seed(args.seed),
                         device=dev)
    rng = np.random.default_rng(args.seed)
    prompts = torch.from_numpy(rng.integers(
        0, cfg.vocab, (args.batch, args.prompt_len))).to(dev)
    gen, times = greedy_generate(params, cfg, prompts, args.gen)
    dt = times["prefill_s"] + times["decode_s"]
    print(f"generated {tuple(gen.shape)} tokens in {dt:.2f}s "
          f"({args.batch * args.gen / dt:.1f} tok/s)")
    print("sample:", gen[0, :16].tolist())
    return gen


if __name__ == "__main__":
    main()
