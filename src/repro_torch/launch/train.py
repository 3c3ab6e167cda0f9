"""Training driver: ``python -m repro_torch.launch.train --arch yi-9b --steps 200``
(``repro.launch.train``).

The JAX package's flags (``--arch --steps --global-batch --seq-len --lr
--dp --tp --zero1 --full --ckpt --log-every``) with its defaults, warmup
(max(5, steps // 20)) and log lines, plus the port's ``--device`` (the
card unless ``cpu`` is asked for; no card raises), ``--dist-backend`` (as
``launch/serve.py``) and ``--layers N`` (the arch cut to its first N
layers at full width, as chip_smoke.py's phases cut depth).  Reduced
configs unless ``--full``; seeded random weights (seed 0, drawn as
``model.init_params`` draws them), bf16 with the JAX package's fp32
leaves; the synthetic bigram stream of ``training/data.py``.

At ``--dp`` x ``--tp`` > 1 the ranks are processes over
``torch.distributed`` (``launch/mesh.py``), the global batch split over
the data replicas; training at tp > 1 serves the dense family only
(``model.check_trainable``).  ``--ckpt PATH`` saves the trained weights
in the JAX package's format (``training/checkpoint.py``; at tp > 1 the
shards gathered first), which either package restores.  ``main(argv)``
returns the logged history (world rank 0's).
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import torch

from repro_torch.configs import ParallelConfig, get_config
from repro_torch.core import collectives as cc
from repro_torch.launch import mesh
from repro_torch.models import model as M
from repro_torch.models.common import Dist, resolve_device
from repro_torch.training import checkpoint, data
from repro_torch.training.train_loop import (AdamWConfig, init_state, init_tree, local_batch,
                                             make_train_step)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="yi-9b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--dp", type=int, default=1)
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--zero1", action="store_true")
    ap.add_argument("--full", action="store_true",
                    help="use the full (not reduced) architecture config")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the arch to its first N layers (0: all)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda (the default; raises without a card) or cpu")
    ap.add_argument("--dist-backend", choices=mesh.BACKENDS, default="gloo",
                    help="--tp or --dp > 1: nccl (one card a rank) or gloo (ranks may share "
                         "a card or run on the CPU; collectives staged through host memory)")
    return ap


def config_of(args):
    cfg = get_config(args.arch)
    if not args.full:
        cfg = cfg.reduced()
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    return cfg


@dataclass
class Run:
    """What one rank's run leaves: the logged history, its training tree
    and context, and the seconds of each step (the host's clock, after the
    step's metrics reached it)."""
    history: List[Dict[str, float]]
    tree: Dict[str, torch.Tensor]
    ctx: M.ModelCtx
    step_s: List[float]


def gather_tree(tree: Dict[str, torch.Tensor], ctx: M.ModelCtx) -> Dict[str, torch.Tensor]:
    """This rank's training tree -> the whole model's (every rank of the
    replica gets it): each split leaf gathered along its split axis
    (tag ``ckpt_gather``).  The layouts ``check_trainable`` admits split
    each leaf once, without padding."""
    if ctx.dist.tp == 1:
        return tree
    sharded = checkpoint.model_sharded(ctx.cfg, ctx.plan)
    layout = checkpoint.tree_layout(ctx.cfg)
    out = {}
    for key, t in tree.items():
        leaf = layout[key]
        if sharded[key]:
            (sp,) = M._split(leaf.name, ctx.cfg, ctx.plan, ctx.dist.rank, leaf.family)
            t = cc.all_gather(t.detach().contiguous(), ctx.dist, t.dim() + sp.axis,
                              tag="ckpt_gather")
        out[key] = t
    return out


def train(args, dist: Dist = Dist(), device=None) -> Run:
    """One rank's run of the parsed ``args``."""
    device = resolve_device(device or args.device)
    cfg = config_of(args)
    par = ParallelConfig(tp=args.tp, dp=args.dp, remat=True)
    M.check_trainable(cfg, par)
    ctx = M.ModelCtx.make(cfg, par, dist)
    talk = dist.world_rank == 0
    tree = init_tree(cfg, ctx, seed=0, device=device)
    if talk:
        sharded = checkpoint.model_sharded(cfg, ctx.plan)
        n_params = sum(t.numel() * (dist.tp if sharded[k] else 1) for k, t in tree.items())
        print(f"arch={cfg.name} params={n_params/1e6:.1f}M mesh=({args.dp},{args.tp})")
    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=max(5, args.steps // 20),
                          total_steps=args.steps)
    opt = init_state(tree, ctx, zero1=args.zero1)
    dc = data.DataConfig(global_batch=args.global_batch, seq_len=args.seq_len)
    step_fn = make_train_step(ctx, opt_cfg, zero1=args.zero1)

    t0 = time.time()
    history, step_s = [], []
    for step, batch in enumerate(data.iter_batches(cfg, dc)):
        if step >= args.steps:
            break
        ts = time.perf_counter()
        tree, opt, metrics = step_fn(tree, opt, local_batch(batch, dist, device))
        if step % args.log_every == 0 or step == args.steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            history.append({"step": step, **m})
            if talk:
                print(f"step {step:5d} loss {m['loss']:.4f} aux {m['aux']:.3f} "
                      f"gnorm {m['grad_norm']:.2f} ({time.time()-t0:.0f}s)", flush=True)
        step_s.append(time.perf_counter() - ts)
    if args.ckpt:
        whole = gather_tree(tree, ctx)
        if talk:
            checkpoint.save_tree(args.ckpt, whole, step=args.steps,
                                 meta={"arch": cfg.name, "history": history[-5:]})
            print("saved", args.ckpt)
    return Run(history, tree, ctx, step_s)


def _rank(dist: Dist, device, args) -> List[Dict[str, float]]:
    return train(args, dist, device).history


def main(argv: Optional[list] = None) -> List[Dict[str, float]]:
    """Train; -> the logged history ({"step", "loss", "total_loss", "aux",
    "grad_norm"} each logged step; world rank 0's over more than one
    rank)."""
    args = build_parser().parse_args(argv)
    if args.tp == 1 and args.dp == 1:
        return train(args).history
    # refuse what the ranks would before spawning them
    M.check_trainable(config_of(args), ParallelConfig(tp=args.tp, dp=args.dp))
    mesh.check_backend(args.dp * args.tp, args.dist_backend, args.device)
    if args.device == "cuda" and config_of(args).moe is not None:
        from repro_torch.kernels import build
        build.build_all()          # the router's topk, once, before the ranks load it
    return mesh.spawn(_rank, args.tp, args, backend=args.dist_backend, device=args.device,
                      dp=args.dp)[0]


if __name__ == "__main__":
    main()
