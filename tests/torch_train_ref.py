"""Shared by the port's training tests (tests/test_torch_train*.py): one
config's train steps through the JAX package's ``make_train_step`` (in
``shard_map`` over a 1 x 1 mesh, as its own tests run it) and through the
port's, on the same weights bridged bit for bit, and their comparison.

The reference's gradients of step 1 are read off its own AdamW state: from
zero moments its first step leaves m = (1 - b1) * g * clip, and the
metrics give the clip's norm, so g = m / ((1 - b1) * clip), exact to an
fp32 rounding or two.  The port's are its train step's own
(``train_step.grads``, before the update)."""

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from repro import compat
from repro.configs import ParallelConfig as JParallel
from repro.configs import get_config as jget_config
from repro.launch.mesh import make_local_mesh
from repro.models import model as JM
from repro.training import data as JD
from repro.training.train_loop import AdamWConfig as JAdamW
from repro.training.train_loop import init_opt_state as jinit_opt_state
from repro.training.train_loop import make_train_step as jmake_train_step
from repro_torch import bridge
from repro_torch.configs import ParallelConfig, get_config
from repro_torch.models import model as M
from repro_torch.training import data as D
from repro_torch.training import train_loop as TL
from repro_torch.training.optimizer import AdamWConfig

OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)
BATCH = dict(global_batch=2, seq_len=32)


def jax_params(arch: str, fp32: bool = True):
    """The JAX package's seeded reduced tree (fp32 leaves where ``fp32``,
    as ``tests/dist_checks._fp32`` widens them)."""
    ctx = JM.ModelCtx.make(jget_config(arch).reduced(), JParallel())
    params = JM.init_params(ctx, jax.random.key(0))
    if fp32:
        params = jax.tree.map(lambda x: x.astype(jnp.float32) if x.dtype == jnp.bfloat16 else x,
                              params)
    return params


def _np_flat(tree) -> dict:
    return {k: np.asarray(v, np.float32)
            for k, v in bridge.flatten(jax.tree.map(np.asarray, tree)).items()}


def jax_steps(arch: str, params, *, steps: int = 2, remat: bool = True, grad_accum: int = 1,
              zero1: bool = False, state: bool = False):
    """The reference's ``steps`` train steps -> (each step's metrics, step
    1's gradients (flat keys, numpy fp32; AdamW only), the parameters
    after the last step (flat, numpy fp32)[, its optimizer state after
    them, flat: "m/<leaf>", "v/<leaf>" or ZeRO-1's "moments/<leaf>/m"])."""
    from repro.models.common import specs_of
    from repro.training.zero import init_zero_state, zero_state_defs

    cfg = jget_config(arch).reduced()
    ctx = JM.ModelCtx.make(cfg, JParallel(tp=1, dp=1, remat=remat))
    c = JAdamW(**OPT)
    dc = JD.DataConfig(**BATCH)
    b0 = JD.make_batch(cfg, dc, 0)
    bspecs = {k: P("data", *(None,) * (v.ndim - 1)) for k, v in b0.items()}
    pspecs = JM.param_specs(ctx)
    if zero1:
        opt = init_zero_state(JM.model_defs(ctx), ctx.dist)
        ospecs = specs_of(zero_state_defs(JM.model_defs(ctx), ctx.dist))
    else:
        opt = jinit_opt_state(params)
        ospecs = {"m": pspecs, "v": pspecs, "step": P()}
    step = jax.jit(compat.shard_map(jmake_train_step(ctx, c, grad_accum=grad_accum, zero1=zero1),
                                    mesh=make_local_mesh(1, 1),
                                    in_specs=(pspecs, ospecs, bspecs),
                                    out_specs=(pspecs, ospecs, P()), check_vma=False))
    metrics, grads = [], None
    for i in range(steps):
        params, opt, m = step(params, opt, {k: jnp.asarray(v)
                                            for k, v in JD.make_batch(cfg, dc, i).items()})
        metrics.append({k: float(v) for k, v in m.items()})
        if i == 0 and not zero1:
            clip = min(1.0, c.grad_clip / max(metrics[0]["grad_norm"], 1e-9))
            grads = {k: g / (np.float32(1 - c.b1) * np.float32(clip))
                     for k, g in _np_flat(opt["m"]).items()}
    out = metrics, grads, _np_flat(params)
    return out + (_np_flat({k: v for k, v in opt.items() if k != "step"}),) if state else out


def port_steps(arch: str, params, *, steps: int = 2, remat: bool = True, grad_accum: int = 1,
               zero1: bool = False, state: bool = False):
    """The port's steps on the bridged ``params`` -> (metrics, step 1's
    gradients, the parameters after the last step[, the optimizer state
    bridged back to the JAX package's nesting, flat]), as ``jax_steps``."""
    cfg = get_config(arch).reduced()
    ctx = M.ModelCtx.make(cfg, ParallelConfig(remat=remat))
    tree = bridge.tree_from_jax(jax.tree.map(np.asarray, params), cfg, "cpu")
    fn = TL.make_train_step(ctx, AdamWConfig(**OPT), grad_accum=grad_accum, zero1=zero1)
    opt = TL.init_state(tree, ctx, zero1=zero1)
    dc = D.DataConfig(**BATCH)
    batch = lambda i: TL.local_batch(D.make_batch(cfg, dc, i), ctx.dist, "cpu")
    for t in tree.values():
        t.requires_grad_(True)
    grads = {k: g.float().numpy() for k, g in fn.grads(tree, batch(0))[1].items()}
    metrics = []
    for i in range(steps):
        tree, opt, m = fn(tree, opt, batch(i))
        metrics.append({k: float(v) for k, v in m.items()})
    out = metrics, grads, {k: t.detach().float().numpy() for k, t in tree.items()}
    if not state:
        return out
    if zero1:
        flat = {f"moments/{k}/{w}": t for k, mv in opt["moments"].items() for w, t in mv.items()}
    else:
        flat = {f"{w}/{k}": t for w in ("m", "v") for k, t in opt[w].items()}
    return out + (bridge.flatten(bridge.tree_to_jax(flat)),)


def worst_grad(port: dict, ref: dict) -> dict:
    """key -> |port - ref| max over the leaf, over the leaf's max |ref|."""
    assert set(port) == set(ref)
    return {k: float(np.abs(port[k] - ref[k]).max()) / max(float(np.abs(ref[k]).max()), 1e-30)
            for k in ref}


def assert_step_matches(port, ref, *, metric_tol=1e-4, grad_tol=1e-4, param_tol=5e-4,
                        grad_tols=None):
    """Metrics within ``metric_tol`` relative, every gradient within
    ``grad_tol`` of its leaf's max |g| (``grad_tols``: key -> another
    tolerance), the parameters after the steps within ``param_tol``."""
    (pm, pg, pp), (jm, jg, jp) = port, ref
    for a, b in zip(pm, jm):
        for k in ("loss", "total_loss", "aux", "grad_norm"):
            assert abs(a[k] - b[k]) <= metric_tol * max(abs(b[k]), 1e-6), (k, a, b)
    if grad_tol is not None:
        bad = {k: e for k, e in worst_grad(pg, jg).items()
               if e > (grad_tols or {}).get(k, grad_tol)}
        assert not bad, bad
    if param_tol is not None:
        worst = {k: float(np.abs(pp[k] - jp[k]).max()) for k in jp}
        assert max(worst.values()) <= param_tol, {k: e for k, e in worst.items()
                                                  if e > param_tol}
