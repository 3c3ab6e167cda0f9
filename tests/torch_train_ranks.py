"""What each rank runs for tests/test_torch_train_ranks.py: the port only
(torch, numpy, repro_torch), so the spawned rank processes import no jax.
Every function takes (dist, device, ...) as ``launch.mesh.spawn`` calls it
and returns plain data."""
import torch

from repro_torch import bridge
from repro_torch.configs import ParallelConfig, get_config
from repro_torch.core import collectives as cc
from repro_torch.launch.train import gather_tree
from repro_torch.models import model as M
from repro_torch.training import data as D
from repro_torch.training import train_loop as TL
from repro_torch.training.optimizer import AdamWConfig


def train_case(dist, device, arch, tree, kw=None):
    return _train_case(dist, device, arch, tree, **(kw or {}))


def _train_case(dist, device, arch, tree, *, zero1=False, steps=2, global_batch=4, seq_len=32,
                opt=None, records=False):
    """``steps`` train steps of reduced ``arch`` from the numpy JAX tree
    ``tree`` on this rank's shard -> {"params": the whole model's updated
    tree as numpy fp32, "metrics": each step's, "records": the first
    step's collectives as (kind, tag, bytes)}."""
    cfg = get_config(arch).reduced()
    par = ParallelConfig(tp=dist.tp, dp=dist.dp)
    ctx = M.ModelCtx.make(cfg, par, dist)
    flat = bridge.tree_from_jax(tree, cfg, device, dist)
    step_fn = TL.make_train_step(ctx, AdamWConfig(**(opt or {})), zero1=zero1)
    state = TL.init_state(flat, ctx, zero1=zero1)
    dc = D.DataConfig(global_batch=global_batch, seq_len=seq_len)
    metrics, recs = [], []
    for i in range(steps):
        with cc.comm_stats() as st:
            flat, state, m = step_fn(flat, state, TL.local_batch(D.make_batch(cfg, dc, i), dist,
                                                                 device))
        metrics.append({k: float(v) for k, v in m.items()})
        if i == 0 and records:
            recs = [(r.kind, r.tag, r.bytes) for r in st.records]
    whole = gather_tree(flat, ctx)
    return {"params": {k: t.detach().float().cpu().numpy() for k, t in whole.items()},
            "metrics": metrics, "records": recs}


def backward_in_thread(dist, device):
    """The differentiable collectives' records when the backward runs in
    another thread (as autograd runs a CUDA graph's): a gather, a
    reduce-scatter and an all-reduce of a (2, 6, 3) chunk, summed and
    differentiated -> [(kind, tag)] and the input's gradient."""
    import threading

    x = torch.arange(36, dtype=torch.float32).reshape(2, 6, 3).requires_grad_(True)
    with cc.comm_stats() as st:
        y = cc.all_gather_ad(x, dist, 1, tag="t_ag")
        y = cc.reduce_scatter_ad(y * 2.0, dist, 1, tag="t_rs")
        loss = cc.all_reduce_ad(y, dist, tag="t_ar").sum()
        t = threading.Thread(target=loss.backward)
        t.start()
        t.join()
    return [(r.kind, r.tag) for r in st.records], x.grad.numpy()


def train_cases(dist, device, cases):
    """name -> (arch, numpy JAX tree, ``train_case`` options) -> name ->
    ``train_case``'s result, every case on this rank in turn; and
    ``backward_in_thread``'s under "thread"."""
    out = {name: train_case(dist, device, arch, tree, kw)
           for name, (arch, tree, kw) in cases.items()}
    out["thread"] = backward_in_thread(dist, device)
    return out
