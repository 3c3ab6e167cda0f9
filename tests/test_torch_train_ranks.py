"""The port's training over ranks against the JAX package (reduced
configs, fp32 parameters as ``tests/dist_checks.py`` runs them; gloo rank
processes on the CPU through ``launch/mesh.spawn``, tests/torch_train_ranks.py).

* The dense family at dp 2 x tp 2, AdamW (qwen2.5-14b, as
  ``check_train_grads``) and ZeRO-1 (yi-9b, as ``check_zero1_multidev``):
  the whole model after 2 steps equals the port's dp = 1 run and the JAX
  package's dp = 1 run within 5e-4 (AdamW) and 1e-3 (ZeRO-1), the
  reference's own tolerances.
* The step's collectives tagged ``grad_reduce``, ``xent_*`` and ``zero_*``
  equal the JAX package's ``comm_stats`` of the same layout (its step
  traced in a subprocess with 4 virtual devices), in count and bytes.
  The port also records what the JAX package does not: the loss's max
  (kind ``all_reduce_max``), the backward's collectives (tags ending
  ``.grad``), a checkpointed layer's forward run again (``.remat``), the
  data mean of the MoE loss (``aux_mean``) and the clip's norm (``gnorm``).
* deepseek-moe-16b at dp 2 equals the JAX package's own dp 2 run (loss,
  aux, parameters after 2 steps): each replica's load-balance loss is its
  own tokens', averaged over the replicas, so dp 2 is not dp 1's step.
  The reference's gradient norm there is twice the port's, which is the
  loss's (its ``xent_mean`` psum transposes to a psum).
* The driver at dp 2 x tp 2 logs dp 1's losses.
"""
import json
import os
import subprocess
import sys
import tempfile
from collections import Counter
from pathlib import Path

import numpy as np
import pytest

import torch_threads  # noqa: F401  (caps torch's threads under xdist)
import torch_train_ranks as R
from repro_torch.launch import mesh
from repro_torch.launch import train as T
from repro_torch.models.common import Dist

OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)
DENSE = {"adamw": ("qwen2.5-14b", False, 5e-4), "zero1": ("yi-9b", True, 1e-3)}
MOE = "deepseek-moe-16b"
TAGS = ("grad_reduce", "xent_sumexp", "xent_label", "xent_mean", "zero_grad_tp",
        "zero_grad_rs", "zero_gnorm", "zero_param_ag")

JAX_TRAIN = r"""
import json, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro import compat
from repro.configs import ParallelConfig, get_config
from repro.core import collectives as cc
from repro.launch.mesh import make_local_mesh
from repro.models import model as M
from repro.models.common import specs_of
from repro.training import data as D
from repro.training.train_loop import AdamWConfig, init_opt_state, make_train_step
from repro.training.zero import init_zero_state, zero_state_defs

def fp32(t):
    return jax.tree.map(lambda x: x.astype(jnp.float32) if x.dtype == jnp.bfloat16 else x, t)

def flat(t, pre=""):
    if isinstance(t, dict):
        it = t.items()
    elif isinstance(t, (list, tuple)):
        it = enumerate(t)
    else:
        return {pre: np.asarray(t, np.float32)}
    out = {}
    for k, v in it:
        out.update(flat(v, f"{pre}/{k}" if pre else str(k)))
    return out

def step_fn(arch, dp, tp, zero1):
    cfg = get_config(arch).reduced()
    ctx = M.ModelCtx.make(cfg, ParallelConfig(tp=tp, dp=dp, remat=True))
    params = fp32(M.init_params(ctx, jax.random.key(0)))
    pspecs = M.param_specs(ctx)
    if zero1:
        opt = init_zero_state(M.model_defs(ctx), ctx.dist)
        ospecs = specs_of(zero_state_defs(M.model_defs(ctx), ctx.dist))
    else:
        opt = init_opt_state(params)
        ospecs = {"m": pspecs, "v": pspecs, "step": P()}
    fn = make_train_step(ctx, AdamWConfig(**OPT), zero1=zero1)
    f = jax.jit(compat.shard_map(fn, mesh=make_local_mesh(dp, tp),
                                 in_specs=(pspecs, ospecs, {"tokens": P("data", None),
                                                            "labels": P("data", None)}),
                                 out_specs=(pspecs, ospecs, P()), check_vma=False))
    return cfg, params, opt, f

spec = json.loads(sys.argv[1])
OPT = spec["opt"]
out, arrays = {}, {}
for name, c in spec["cases"].items():
    cfg, params, opt, f = step_fn(c["arch"], c["dp"], c["tp"], c["zero1"])
    dc = D.DataConfig(global_batch=4, seq_len=32)
    batch = lambda i: {k: jnp.asarray(v) for k, v in D.make_batch(cfg, dc, i).items()}
    if c["trace"]:
        with cc.comm_stats() as st:
            f.lower(params, opt, batch(0))
        out[name] = [(r.kind, r.tag, r.bytes) for r in st.records]
        continue
    metrics = []
    for i in range(2):
        params, opt, m = f(params, opt, batch(i))
        metrics.append({k: float(v) for k, v in m.items()})
    out[name] = metrics
    arrays.update({f"{name}:{k}": v for k, v in flat(params).items()})
np.savez(spec["npz"], **arrays)
print(json.dumps(out))
"""


def _jax_tree(arch):
    """The JAX package's seeded reduced tree, fp32, as numpy."""
    import jax
    import jax.numpy as jnp
    from repro.configs import ParallelConfig, get_config
    from repro.models import model as JM

    ctx = JM.ModelCtx.make(get_config(arch).reduced(), ParallelConfig())
    params = JM.init_params(ctx, jax.random.key(0))
    return jax.tree.map(lambda x: np.asarray(x.astype(jnp.float32)
                                             if x.dtype == jnp.bfloat16 else x), params)


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX package's runs (dp = 1 and deepseek's dp 2) and its traced
    dp 2 x tp 2 steps, in one subprocess with 4 virtual devices, started
    at once and read when needed."""
    tests = Path(__file__).resolve().parent
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=f"{tests.parent / 'src'}{os.pathsep}{tests}", JAX_PLATFORMS="cpu")
    with tempfile.TemporaryDirectory() as tmp:
        cases = {f"{k} dp1": dict(arch=a, dp=1, tp=1, zero1=False, trace=False)
                 for k, (a, _, _) in DENSE.items()}
        cases.update({f"{k} trace": dict(arch=a, dp=2, tp=2, zero1=z, trace=True)
                      for k, (a, z, _) in DENSE.items()})
        cases[f"{MOE} dp2"] = dict(arch=MOE, dp=2, tp=1, zero1=False, trace=False)
        spec = {"opt": OPT, "cases": cases, "npz": os.path.join(tmp, "params.npz")}
        proc = subprocess.Popen([sys.executable, "-c", JAX_TRAIN, json.dumps(spec)],
                                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                                env=env)
        result = {}

        def read():
            if not result:
                out, err = proc.communicate(timeout=600)
                assert proc.returncode == 0, err[-3000:]
                result.update(json.loads(out))
                with np.load(spec["npz"]) as z:
                    for key in z.files:
                        name, _, leaf = key.partition(":")
                        result.setdefault(f"{name} params", {})[leaf] = z[key]
            return result

        yield read
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


@pytest.fixture(scope="module")
def trees():
    return {a: _jax_tree(a) for a in ("qwen2.5-14b", "yi-9b", MOE)}


@pytest.fixture(scope="module")
def ranks(jax_runs, trees):
    """The port: dp 2 x tp 2 (the dense cases, one world of 4 ranks),
    deepseek at dp 2 (2 ranks), and every case at dp = 1 in this process."""
    dense = {k: (a, trees[a], dict(opt=OPT, zero1=z, records=True))
             for k, (a, z, _) in DENSE.items()}
    out = {"dp2tp2": mesh.spawn(R.train_cases, 2, dense, device="cpu", dp=2),
           "moe dp2": mesh.spawn(R.train_cases, 1, {MOE: (MOE, trees[MOE], dict(opt=OPT))},
                                 device="cpu", dp=2)}
    for k, (a, z, _) in DENSE.items():
        for zero1 in {False, z}:
            out[(k, zero1)] = R.train_case(Dist(), "cpu", a, trees[a], dict(opt=OPT, zero1=zero1))
    return out


def _close(a: dict, b: dict, tol: float):
    assert set(a) == set(b)
    worst = max(float(np.abs(a[k] - b[k]).max()) for k in a)
    assert worst <= tol, worst


@pytest.mark.parametrize("case", list(DENSE))
def test_dense_dp2_tp2_equals_dp1(ranks, jax_runs, case):
    """Every rank's whole model after 2 steps equals the port's dp = 1 run
    and the JAX package's, and the losses agree."""
    arch, zero1, tol = DENSE[case]
    base = ranks[(case, zero1)]
    ref = jax_runs()[f"{case} dp1 params"]
    _close(base["params"], ref, tol)
    for r in ranks["dp2tp2"]:
        got = r[case]
        _close(got["params"], base["params"], tol)
        _close(got["params"], ref, tol)
        for m, b in zip(got["metrics"], base["metrics"]):
            assert abs(m["loss"] - b["loss"]) <= 1e-5 * abs(b["loss"]), (m, b)


def _by_tag(records):
    c = Counter()
    for kind, tag, nbytes in records:
        if tag in TAGS and kind != "all_reduce_max":
            c[(kind, tag, "count")] += 1
            c[(kind, tag, "bytes")] += nbytes
    return dict(c)


@pytest.mark.parametrize("case", list(DENSE))
def test_train_records_equal_jax_comm_stats(ranks, jax_runs, case):
    """The grad_reduce, xent_* and zero_* records of one step equal the JAX
    package's for the same layout, in count and bytes, on every rank."""
    ref = _by_tag(jax_runs()[f"{case} trace"])
    assert ref
    for r in ranks["dp2tp2"]:
        assert _by_tag(r[case]["records"]) == ref


def test_backward_records_from_another_thread(ranks):
    """A backward run in autograd's own thread (a CUDA graph's) records its
    collectives into the forward's ``comm_stats``, each under its forward's
    tag with ``.grad``; the gradient is the sum over the model ranks'
    shares."""
    for r in ranks["dp2tp2"]:
        records, grad = r["thread"]
        assert records == [("all_gather", "t_ag"), ("reduce_scatter", "t_rs"),
                           ("all_reduce", "t_ar"), ("all_reduce", "t_ar.grad"),
                           ("all_gather", "t_rs.grad"), ("reduce_scatter", "t_ag.grad")]
        # the doubling, times the two ranks' copies the reduce-scatter sums,
        # times the all-reduce's gradient sum (its result's gradient held
        # as partial sums, grad_sum)
        assert np.all(grad == 2.0 * 2 * 2)


def test_zero1_dp1_equals_adamw(ranks):
    """ZeRO-1 at dp = 1 is AdamW (the reference's test_zero1_equals_adamw_dp1)."""
    _close(ranks[("zero1", True)]["params"], ranks[("zero1", False)]["params"], 1e-6)


def test_moe_dp2_equals_jax_dp2(ranks, jax_runs):
    """deepseek-moe-16b at dp 2: loss, aux and the model after 2 steps equal
    the JAX package's dp 2 run."""
    ref = jax_runs()
    for r in ranks["moe dp2"]:
        got = r[MOE]
        for m, j in zip(got["metrics"], ref[f"{MOE} dp2"]):
            for k in ("loss", "aux"):
                assert abs(m[k] - j[k]) <= 1e-4 * abs(j[k]), (k, m, j)
            # the reference's gradient at dp 2 is twice the loss's: the
            # transpose of its xent_mean psum is a psum over the replicas,
            # and reduce_grads sums them again (AdamW's step does not see
            # the factor; its norm does)
            assert abs(2 * m["grad_norm"] - j["grad_norm"]) <= 1e-4 * j["grad_norm"], (m, j)
        _close(got["params"], ref[f"{MOE} dp2 params"], 5e-4)


def test_driver_dp2_tp2_logs_dp1_losses():
    """``python -m repro_torch.launch.train --dp 2 --tp 2`` (bf16, as the
    driver runs) logs the losses of the dp = 1 run within 2e-2."""
    argv = ["--arch", "yi-9b", "--device", "cpu", "--steps", "3", "--global-batch", "4",
            "--seq-len", "32", "--log-every", "1"]
    one = T.main(argv)
    four = T.main(argv + ["--dp", "2", "--tp", "2", "--zero1"])
    assert len(one) == len(four) == 3
    for a, b in zip(one, four):
        assert abs(a["loss"] - b["loss"]) <= 2e-2 * a["loss"], (a, b)
