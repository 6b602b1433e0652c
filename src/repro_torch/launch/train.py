"""Training launcher: real steps of an LM config; the counterpart of
`repro/launch/train.py`.

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \
      --steps 50 --batch 8 --seq 256 [--ckpt DIR] [--device cpu]

A step is `lm_loss` -> backward -> optional int8 error-feedback gradient
compression -> AdamW with a cosine warm-up schedule.  Fault tolerance:
the run resumes from the newest snapshot in `--ckpt`; `--fail-at N`
exits with code 42 before step N (the restart contract: the resumed run
continues bit for bit).  Runs on the card unless `--device cpu`.

`--mesh DxM` with D·M > 1 runs the step over a D x M device mesh
("data", "model") of D·M ranks (`dist.world.run_world`, gloo: on one card
every rank shares it, since NCCL takes one card a rank; `--device cpu`
runs them on the CPU).  Each rank holds its blocks of
`dist.sharding.lm_mesh_specs`, drawn as the unsharded run draws them,
and its rows of each batch; the step is the same `lm_loss` under a
`DistCtx`, then `reduce_grads` sums each gradient over the ranks that hold
the same block, compression (if on) quantizes each rank's float32
gradient blocks, and AdamW updates the blocks (the clip's norm summed over
the ranks).  A snapshot is the gathered state, in the 1x1 run's layout,
written by rank 0; a restore cuts each rank's blocks out of it.  Rank 0
prints and returns the loss.

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \
      --steps 8 --batch 4 --seq 64 --mesh 2x2 --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import math
import sys
import time

import torch
import torch.distributed as dist

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.core.engine import resolve_device
from repro_torch.data.tokens import TokenStream
from repro_torch.dist import comm as dcomm
from repro_torch.dist import sharding as shd
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import segment_combine as sc
from repro_torch.launch.mesh import make_mesh, mesh_axes
from repro_torch.models import transformer as tfm
from repro_torch.optim import compression
from repro_torch.optim.adamw import AdamW, cosine_warmup

WORLD_TIMEOUT_S = 1800.0


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


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--mesh", default="1x1", help="DxM, e.g. 2x2")
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--fail-at", type=int, default=-1)
    ap.add_argument("--grad-compression", action="store_true")
    ap.add_argument("--full-size", action="store_true",
                    help="use the arch's real config (needs a card)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    return ap


def _config(args):
    cfg, family = get_config(args.arch)
    if family != "lm":
        raise SystemExit(f"{args.arch} is not an LM; train.py drives LMs")
    return cfg if args.full_size else reduced_lm_config(cfg)


def _mesh_shape(text: str):
    d, m = (int(x) for x in text.split("x"))
    return d, m


def main(argv=None, init_params=None, on_step=None, rank_context=None,
         ranks_out=None, cfg=None, final_params=None):
    """Run the launcher; returns the last step's loss.  `init_params`
    (the JAX package's `init_lm` tree as numpy arrays) replaces the random
    initial weights; `on_step(step, loss, seconds)` is called after each
    step, `seconds` its host wall time ending in a device sync.
    `final_params`, a path, gets the parameters after the last step
    (`save_params`: the whole model on the host, a mesh run's gathered
    from the ranks' blocks), unless the run stops at `--fail-at`.

    Under a mesh of more than one rank, `on_step` is called for rank 0's
    steps once the world has ended; `ranks_out` (a list) receives every
    rank's record (its steps with loss, seconds, peak memory and kernel
    launches); `rank_context(rank, current_step)` (importable by name)
    makes a context manager each rank enters around its steps, whose
    value comes back in the rank's record as "context".  `cfg`, when
    given, replaces the config that `--arch` and `--full-size` name."""
    args = _parser().parse_args(argv)
    cfg = cfg or _config(args)
    d, m = _mesh_shape(args.mesh)
    if d * m > 1:
        return _mesh_main(args, argv, init_params, on_step, rank_context,
                          ranks_out, cfg, final_params)
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
        loss = float(train_step(params, named, opt, err, batch, cfg))
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
    if final_params:
        save_params(named, final_params)
    print(f"final loss {loss:.4f}")
    return loss


def save_params(named, path, specs=None, mesh=None, lead=True) -> None:
    """`torch.save` of {name: the whole parameter on the host}, each
    copied off the card as it comes.  On a mesh (`specs`, `mesh`) every
    rank takes part in each gather and `lead` writes."""
    out = {}
    for n, p in named.items():
        t = (p.detach() if mesh is None
             else gather_block(p.detach(), specs[n], mesh))
        if lead:
            out[n] = t.cpu()
    if lead:
        torch.save(out, path)


def train_step(params, named, opt: AdamW, err, batch, cfg,
               ctx=tfm.LOCAL_CTX, specs=None):
    """One step: the loss, its backward, on a mesh the gradients summed
    over the ranks that hold the same block (`reduce_grads`, by `specs`),
    the optional compression, AdamW.  Returns the loss (the whole loss
    over the mesh), a device scalar."""
    value, parts = tfm.lm_loss(params, batch, cfg, ctx)
    opt.zero_grad(set_to_none=True)
    value.backward()
    grads = None
    if ctx.mesh is not None:
        grads = reduce_grads(named, specs, ctx)
    if err is not None:
        # int8 error-feedback compression of the gradient signal
        q, scales, new_err = compression.compress(
            grads if grads is not None
            else {n: p.grad for n, p in named.items()}, err)
        err.update(new_err)
        grads = compression.decompress(q, scales)
    if grads is not None:
        grads = [grads[n] for n in named]
    opt.step(grads=grads)
    return parts["loss"] if ctx.mesh is not None else value.detach()


# ----------------------------------------------------------------- mesh run
def _replicated_group(spec, ctx):
    """The group over which a block under `spec` is replicated (its
    gradient shares are summed there): the world, dp, tp or None."""
    axes = {a for e in spec if e is not None
            for a in ((e,) if isinstance(e, str) else e)}
    over_dp = ctx.dp_size > 1 and not axes & set(ctx.dp)
    over_tp = ctx.n_ep > 1 and ctx.tp not in axes
    if over_dp and over_tp:
        return dist.group.WORLD
    return ctx.dp_group if over_dp else ctx.tp_group if over_tp else False


def reduce_grads(named, specs, ctx):
    """Each parameter's float32 gradient, its shares summed over the ranks
    that hold the same block (rank order); zeros for no gradient."""
    out = {}
    with torch.no_grad():
        for name, p in named.items():
            g = (torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                 if p.grad is None else p.grad.to(torch.float32))
            group = _replicated_group(specs[name], ctx)
            out[name] = (g if group is False
                         else dcomm.group_all_reduce(g, group))
    return out


def mesh_sq_norm(named, specs, ctx):
    """AdamW's `sq_norm` on a mesh: each parameter's sum of squares
    counted once a block (by the ranks at coordinate 0 of its replicated
    axes), summed over every rank, then over the parameters in order."""
    coords = shd.mesh_coords(ctx.mesh)
    own = []
    for name in named:
        axes = {a for e in specs[name] if e is not None
                for a in ((e,) if isinstance(e, str) else e)}
        own.append(all(coords[a] == 0 for a in coords if a not in axes))

    def sq_norm(sq):
        mine = torch.stack([x if o else torch.zeros_like(x)
                            for x, o in zip(sq, own)])
        total = dcomm.group_all_reduce(mine, dist.group.WORLD)
        return functools.reduce(torch.add, total.unbind(0))
    return sq_norm


def gather_block(t: torch.Tensor, spec, mesh) -> torch.Tensor:
    """The whole tensor from the ranks' blocks under `spec` (gathered over
    each sharding axis, minor axis first)."""
    for d, e in enumerate(spec):
        if e is None:
            continue
        for axis in reversed((e,) if isinstance(e, str) else e):
            t = dcomm._gather(t, d, mesh.get_group(axis))
    return t


def mesh_train_state(params, opt, err, specs, mesh):
    """`train_state` of the whole model from the ranks' blocks (every rank
    takes part; the tree is whole on each)."""
    local = train_state(params, opt, err)

    def whole(tree):
        return {n: gather_block(t, specs[n], mesh) for n, t in tree.items()}
    out = {"params": whole(local["params"]),
           "opt": {"steps": local["opt"]["steps"],
                   "m": whole(local["opt"]["m"]),
                   "v": whole(local["opt"]["v"])}}
    if err is not None:
        out["err"] = whole(local["err"])
    return out


def _restore_blocks(ckpt, params, opt, err, specs, mesh):
    """Restore the newest snapshot (a whole-model `train_state`, read on
    the host) and keep each rank's blocks; returns its step."""
    like = train_state(params, opt, err)

    def whole_like(tree):
        return {n: torch.empty(
            gather_shape(t.shape, specs[n], mesh), dtype=t.dtype)
            for n, t in tree.items()}
    host = {"params": whole_like(like["params"]),
            "opt": {"steps": like["opt"]["steps"].cpu(),
                    "m": whole_like(like["opt"]["m"]),
                    "v": whole_like(like["opt"]["v"])}}
    if err is not None:
        host["err"] = whole_like(like["err"])
    tree, start = ckpt.restore(host)

    def blocks(t):
        return {n: shd.local_block(x, specs[n], mesh) for n, x in t.items()}
    local = {"params": blocks(tree["params"]),
             "opt": {"steps": tree["opt"]["steps"],
                     "m": blocks(tree["opt"]["m"]),
                     "v": blocks(tree["opt"]["v"])}}
    if err is not None:
        local["err"] = blocks(tree["err"])
    dev = next(params.parameters()).device
    load_train_state(_to(local, dev), params, opt, err)
    return start


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def gather_shape(shape, spec, mesh):
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    out = list(shape)
    for d, e in enumerate(spec):
        for axis in (() if e is None else (e,) if isinstance(e, str)
                     else e):
            out[d] *= sizes[axis]
    return tuple(out)


def _launches():
    return {"k3_fwd": fa.LAUNCHES, "k3_bwd": fa.LAUNCHES_BWD,
            "k1": sc.LAUNCHES["dense"]}


def mesh_context(cfg, mesh, batch: int):
    """(the `DistCtx`, the storage specs) of a run on `mesh` at a global
    `batch` (split over dp when it divides); the dry run's cells take the
    same."""
    ax = mesh_axes(mesh)
    ctx = tfm.DistCtx(mesh=mesh, dp=ax["dp"], tp=ax["tp"],
                      batch_over_dp=batch % ax["dp_size"] == 0)
    specs = shd.lm_mesh_specs(cfg, ax["dp"], ax["tp"],
                              dict(zip(mesh.mesh_dim_names, mesh.shape)))
    return ctx, specs


def mesh_setup(args, cfg, comm, init_params=None):
    """A rank's mesh, context, specs, parameter blocks, optimizer and
    compression error."""
    dev = comm.device
    d, m = _mesh_shape(args.mesh)
    mesh = make_mesh((d, m), ("data", "model"), device_type=dev.type)
    ctx, specs = mesh_context(cfg, mesh, args.batch)

    def shard(name, t):
        return shd.local_block(t, specs[name], mesh)
    if init_params is None:
        params = tfm.init_lm(cfg, torch.Generator(dev).manual_seed(args.seed),
                             device=dev, shard=shard)
    else:
        params = tfm.params_from_numpy(init_params, cfg, device=dev,
                                       shard=shard)
    named = dict(params.named_parameters())
    opt = AdamW(named.values(), lr=args.lr,
                schedule=cosine_warmup(10, args.steps),
                sq_norm=mesh_sq_norm(named, specs, ctx))
    err = compression.init_error(named) if args.grad_compression else None
    return mesh, ctx, specs, params, named, opt, err


def local_rows(batch, ctx, mesh):
    """The rank's rows of a global batch (all of them when the batch is
    not split over dp)."""
    if not ctx.batch_over_dp or ctx.dp_size == 1:
        return batch
    coords = shd.mesh_coords(mesh)
    r = 0
    for a in ctx.dp:
        r = r * ctx._size(a) + coords[a]
    n = next(iter(batch.values())).shape[0] // ctx.dp_size
    return {k: v[r * n:(r + 1) * n] for k, v in batch.items()}


def _mesh_rank(comm, argv, init_params, rank_context, cfg, final_params):
    """One rank of a mesh run (`run_world`): returns its record."""
    args = _parser().parse_args(argv)
    dev = comm.device
    cuda = dev.type == "cuda"
    mesh, ctx, specs, params, named, opt, err = mesh_setup(args, cfg, comm,
                                                           init_params)
    stream = TokenStream(cfg.vocab, args.batch, args.seq, seed=args.seed)
    ckpt = CheckpointManager(args.ckpt) if args.ckpt else None
    lead = comm.rank == 0
    start = 0
    if ckpt and ckpt.latest_step() is not None:
        start = _restore_blocks(ckpt, params, opt, err, specs, mesh)
        if lead:
            print(f"resumed from step {start}")
    rec = {"rank": comm.rank, "steps": [], "failed_at": None,
           "coords": shd.mesh_coords(mesh)}
    current = {"step": start}
    context = (rank_context(comm.rank, lambda: current["step"])
               if rank_context is not None else None)
    value = context.__enter__() if context is not None else None
    try:
        for step in range(start, args.steps):
            current["step"] = step
            if step == args.fail_at:
                if lead:
                    print(f"simulated failure at step {step}")
                if ckpt:
                    ckpt.wait()
                rec["failed_at"] = step
                break
            if cuda:            # the peak of each step on its own
                torch.cuda.synchronize(dev)
                torch.cuda.reset_peak_memory_stats(dev)
            t_step = time.perf_counter()
            before = _launches()
            batch = {k: torch.from_numpy(v).to(dev) for k, v in
                     local_rows(stream.batch_at(step), ctx, mesh).items()}
            loss = float(train_step(params, named, opt, err, batch, cfg, ctx,
                                    specs))
            after = _launches()
            rec["steps"].append({
                "step": step, "loss": loss,
                "s": time.perf_counter() - t_step,
                "peak": (torch.cuda.max_memory_allocated(dev) if cuda
                         else None),
                **{k: after[k] - before[k] for k in after}})
            if lead and (step % 10 == 0 or step == args.steps - 1):
                print(f"step {step:5d} loss {loss:.4f}", flush=True)
            if ckpt and (step + 1) % args.ckpt_every == 0:
                tree = mesh_train_state(params, opt, err, specs, mesh)
                if lead:
                    ckpt.save(step + 1, tree)
        else:
            if ckpt:
                tree = mesh_train_state(params, opt, err, specs, mesh)
                if lead:
                    ckpt.save(args.steps, tree)
                    ckpt.wait()
            if final_params:
                save_params(named, final_params, specs, mesh, lead)
    finally:
        if context is not None:
            context.__exit__(None, None, None)
    rec["context"] = value
    return rec


def check_mesh(cfg, d: int, m: int) -> None:
    """Refuse, before any rank starts, a mesh whose blocks would not split
    evenly (every parameter under `lm_mesh_specs`, the experts over
    tp)."""
    sizes = {"data": d, "model": m}
    specs = shd.lm_mesh_specs(cfg, ("data",), "model", sizes)
    zero = dict.fromkeys(sizes, 0)
    for name, (shape, _) in tfm.param_shapes(cfg).items():
        shd.local_shape(shape, specs[name], sizes, zero)
    if cfg.moe is not None and cfg.moe.n_experts % m:
        raise ValueError(f"{cfg.moe.n_experts} experts do not split over "
                         f"{m} ranks")


def _mesh_main(args, argv, init_params, on_step, rank_context, ranks_out,
               cfg, final_params):
    d, m = _mesh_shape(args.mesh)
    if args.device not in ("cuda", "cpu"):
        raise ValueError(f"--device must be cuda or cpu under a mesh, got "
                         f"{args.device!r}")
    check_mesh(cfg, d, m)
    from repro_torch.dist.world import run_world
    done = run_world(_mesh_rank, d * m,
                     (list(sys.argv[1:] if argv is None else argv),
                      init_params, rank_context, cfg, final_params),
                     device=args.device, timeout=WORLD_TIMEOUT_S)
    recs = [r.value for r in done]
    if ranks_out is not None:
        ranks_out.extend(recs)
    lead = recs[0]
    if on_step is not None:
        for st in lead["steps"]:
            on_step(st["step"], st["loss"], st["s"])
    if lead["failed_at"] is not None:
        raise SystemExit(42)
    loss = lead["steps"][-1]["loss"] if lead["steps"] else math.nan
    print(f"final loss {loss:.4f}")
    return loss


if __name__ == "__main__":
    main()
