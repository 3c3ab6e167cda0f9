"""The port's training path against the JAX package (reduced configs): the
data stream, AdamW and its schedule, the vocab-parallel losses, the
kernel wrappers' gradient guard, checkpoints across the two packages, one
train step of each dense config and the driver.

Tolerances: batches bit-equal; the schedule and the global norm within
1e-6 relative; one AdamW update within 1e-6; the losses within 1e-5
relative and their gradients within 1e-4 of the leaf's max |g|; a train
step in fp32 parameters (as ``tests/dist_checks._fp32`` runs them) within
1e-4 relative on loss, aux and grad norm, every gradient within 1e-4 of
its leaf's max |g|, the parameters after 2 steps within 5e-4 (the
reference's ``check_train_grads`` tolerance); in bf16, as the driver
runs, the loss and grad norm within 2e-2; the driver's logged losses
within 2e-2 at every step.  The other dense configs' steps and
microbatching are in tests/test_torch_train_dense.py, the other families'
in tests/test_torch_train_families*.py, the rank layouts in
tests/test_torch_train_ranks.py.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

import torch_threads  # noqa: F401  (caps torch's threads under xdist)
import torch_train_ref as TR
from repro import compat
from repro.configs import get_config as jget_config
from repro.launch import train as jtrain
from repro.models.common import Dist as JDist
from repro.models.common import ShardPlan as JShardPlan
from repro.training import checkpoint as jcheckpoint
from repro.training import data as jdata
from repro.training import optimizer as jopt
from repro.training.loss import chunked_vocab_parallel_xent as jchunked
from repro.training.loss import vocab_parallel_xent as jxent
from repro_torch import bridge
from repro_torch.configs import ParallelConfig, get_config
from repro_torch.kernels import ops
from repro_torch.launch import train as T
from repro_torch.models import model as M
from repro_torch.models.common import Dist, ShardPlan
from repro_torch.training import checkpoint, data, loss, optimizer

DENSE = ["yi-9b", "qwen2.5-14b", "qwen2.5-32b", "qwen-72b", "gptj-parallel"]


# ---------------------------------------------------------------------------
# Data, optimizer, loss
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["yi-9b", "internvl2-26b", "musicgen-medium"])
def test_batches_bit_equal(arch):
    """make_batch equals the reference's bit for bit: tokens, labels, the
    frontend's features, the codebook frames."""
    for step in range(3):
        a = data.make_batch(get_config(arch).reduced(), data.DataConfig(3, 24, seed=1), step)
        b = jdata.make_batch(jget_config(arch).reduced(), jdata.DataConfig(3, 24, seed=1), step)
        assert set(a) == set(b)
        for k in b:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
            np.testing.assert_array_equal(a[k], b[k])


def test_lr_schedule_and_global_norm():
    c = optimizer.AdamWConfig(lr=2e-3, warmup_steps=10, total_steps=100, min_lr_frac=0.1)
    jc = jopt.AdamWConfig(lr=2e-3, warmup_steps=10, total_steps=100, min_lr_frac=0.1)
    for s in (0, 1, 9, 10, 11, 55, 99, 100, 200):
        got = float(optimizer.lr_schedule(torch.tensor(s, dtype=torch.int32), c))
        want = float(jopt.lr_schedule(jnp.int32(s), jc))
        assert abs(got - want) <= 1e-6 * want, (s, got, want)
    rng = np.random.default_rng(0)
    tree = {f"w{i}": rng.standard_normal(shape).astype(np.float32)
            for i, shape in enumerate([(3, 5), (7,), (2, 4, 6)])}
    got = float(optimizer.global_norm({k: torch.from_numpy(v) for k, v in tree.items()}))
    want = float(jopt.global_norm({k: jnp.asarray(v) for k, v in tree.items()}))
    assert abs(got - want) <= 1e-6 * want


@pytest.mark.parametrize("clip", [1.0, 100.0])
def test_adamw_update_matches(clip):
    """One update from a state two steps in: params and moments within 1e-6,
    clipped (grad norm > clip) and not."""
    rng = np.random.default_rng(1)
    shapes = {"a": (16, 8), "b": (8,), "c": (4, 3, 5)}
    p = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    g = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    m = {k: 0.1 * rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    v = {k: 0.01 * rng.random(s).astype(np.float32) for k, s in shapes.items()}
    kw = dict(lr=1e-2, warmup_steps=3, total_steps=20, grad_clip=clip)
    t = lambda d: {k: torch.from_numpy(x.copy()) for k, x in d.items()}
    j = lambda d: {k: jnp.asarray(x) for k, x in d.items()}
    pp, ps, pn = optimizer.adamw_update(t(p), t(g), {"m": t(m), "v": t(v),
                                                     "step": torch.tensor(2, dtype=torch.int32)},
                                        optimizer.AdamWConfig(**kw))
    jp, js, jn = jopt.adamw_update(j(p), j(g), {"m": j(m), "v": j(v), "step": jnp.int32(2)},
                                   jopt.AdamWConfig(**kw))
    assert abs(float(pn) - float(jn)) <= 1e-6 * float(jn) and int(ps["step"]) == 3
    for k in shapes:
        for got, want in ((pp[k], jp[k]), (ps["m"][k], js["m"][k]), (ps["v"][k], js["v"][k])):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)


def _xent_case(ncb: int = 1):
    rng = np.random.default_rng(2)
    b, s, d, v = 2, 512, 16, 40
    hidden = rng.standard_normal((b, s, d)).astype(np.float32)
    w = (0.3 * rng.standard_normal((ncb, d, v))).astype(np.float32)
    labels = rng.integers(0, v, (b, s) if ncb == 1 else (b, s, ncb)).astype(np.int32)
    cfg = dataclasses.replace(get_config("yi-9b").reduced(), vocab_size=v)
    jcfg = dataclasses.replace(jget_config("yi-9b").reduced(), vocab_size=v)
    return hidden, w, labels, ShardPlan.make(cfg, 1), JShardPlan.make(jcfg, 1)


def _head(w, h, lib):
    logits = lib.einsum("bsd,cdv->bscv", h, w)
    return logits[:, :, 0] if w.shape[0] == 1 else logits


@pytest.mark.parametrize("ncb", [1, 4])
@pytest.mark.parametrize("chunk", [512, 64, 8])
def test_xent_matches(mesh11, chunk, ncb):
    """vocab_parallel_xent and the chunked loss: values within 1e-5
    relative, their gradients (hidden states and head) within 1e-4 of the
    leaf's max |g|; a codebook head folds its codebooks into the sequence."""
    hidden, w, labels, plan, jplan = _xent_case(ncb)
    jd = JDist(tp=1, dp=1)

    def jf(w, h, lab):
        head = lambda x: _head(w, x, jnp).astype(jnp.float32)
        return (jchunked(h, head, lab, jplan, jd, chunk=chunk)
                + 0.5 * jxent(head(h), lab, jplan, jd))

    jval, jgrads = jax.jit(compat.shard_map(
        jax.value_and_grad(jf, argnums=(0, 1)), mesh=mesh11, in_specs=(P(), P(), P()),
        out_specs=(P(), (P(), P())), check_vma=False))(w, hidden, labels)
    tw, th = torch.from_numpy(w).requires_grad_(), torch.from_numpy(hidden).requires_grad_()
    tl = torch.from_numpy(labels)
    head = lambda x: _head(tw, x, torch)
    val = (loss.chunked_vocab_parallel_xent(th, head, tl, plan, Dist(), chunk=chunk)
           + 0.5 * loss.vocab_parallel_xent(head(th), tl, plan, Dist()))
    val.backward()
    assert abs(float(val.detach()) - float(jval)) <= 1e-5 * abs(float(jval))
    for got, want in ((tw.grad, jgrads[0]), (th.grad, jgrads[1])):
        want = np.asarray(want)
        assert np.abs(got.numpy() - want).max() <= 1e-4 * np.abs(want).max()


# ---------------------------------------------------------------------------
# The kernel wrappers' gradient guard
# ---------------------------------------------------------------------------


def _guard_cases():
    """wrapper -> (a call of it on small CPU inputs, the float input that
    the guard test makes require grad)."""
    gen = torch.Generator().manual_seed(0)
    r = lambda *s, dt=torch.float32: torch.randn(*s, generator=gen).to(dt)
    b, hq, hkv, s, hd = 1, 2, 1, 4, 64
    q, k, v = r(b, hq, s, hd), r(b, hkv, s, hd), r(b, hkv, s, hd)
    q1 = r(b, hq, 1, hd)
    qpos = torch.arange(s, dtype=torch.int32)[None]
    pool_k, pool_v = r(2, hkv, s, hd), r(2, hkv, s, hd)
    bt = torch.tensor([[1]], dtype=torch.int32)
    kb, vb = r(b, hkv, s, hd, dt=torch.bfloat16), r(b, hkv, s, hd, dt=torch.bfloat16)
    cache = lambda: torch.zeros((1, hkv, s, hd), dtype=torch.int8)
    scales = lambda: torch.zeros((1, hkv, s), dtype=torch.bfloat16)
    rows = torch.zeros(s, dtype=torch.int32)
    idx = torch.arange(s, dtype=torch.int32)
    a, bx, h0 = r(1, 4, 8).sigmoid(), r(1, 4, 8), r(1, 8)
    x = r(2, 16, dt=torch.bfloat16)
    qw, sc = torch.randint(-8, 8, (16, 8), generator=gen, dtype=torch.int8), r(8, dt=torch.bfloat16)
    fa, fwa, fb, fwb = r(2, 8), r(8, 4), r(2, 6), r(6, 4)
    return {
        "flash_prefill": (lambda q: ops.flash_prefill(q, k, v, qpos, 0.125), q),
        "flash_verify": (lambda q: ops.flash_verify(q, k, v, qpos, 0.125), q),
        "decode_attention_partial": (
            lambda q: ops.decode_attention_partial(q, k, v, torch.ones(s, dtype=torch.bool),
                                                   0.125), q1),
        "paged_decode_attention_partial": (
            lambda q: ops.paged_decode_attention_partial(
                q, pool_k, pool_v, bt, torch.ones((b, s), dtype=torch.bool), 0.125), q1),
        "paged_flash_prefill": (
            lambda q: ops.paged_flash_prefill(q, pool_k, pool_v, bt, qpos, 0.125), q),
        "kv_quant_write": (
            lambda kb: ops.kv_quant_write(kb, vb, cache(), cache(), scales(), scales(), rows,
                                          idx), kb),
        "lru_scan": (lambda a: ops.lru_scan(a, bx, h0), a),
        "topk": (lambda x: ops.topk(x, 2), r(2, 16)),
        "dequant_matmul": (lambda x: ops.dequant_matmul(x, qw, sc, mode="int8", group=0), x),
        "fused_dual_matmul": (lambda fa: ops.fused_dual_matmul(fa, fwa, fb, fwb), fa),
    }


@pytest.mark.parametrize("name", sorted(_guard_cases()))
def test_kernel_wrappers_refuse_grad(name):
    """Every wrapper raises on an input that requires grad while grad is
    enabled (on the CPU as on the card: its kernel's output would carry no
    gradient), and serves a plain call, with grad enabled, under no_grad
    and in inference mode."""
    call, t = _guard_cases()[name]
    call(t)
    with torch.inference_mode():
        call(t)
    t = t.detach().clone().requires_grad_(True)
    with torch.no_grad():
        call(t)
    with pytest.raises(RuntimeError, match="requires grad"):
        call(t)


# ---------------------------------------------------------------------------
# Checkpoints across the two packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["yi-9b", "deepseek-moe-16b", "mamba2-1.3b",
                                  "recurrentgemma-9b"])
def test_checkpoint_round_trips_across_packages(tmp_path, arch):
    """The port's tree (bf16 with the reference's fp32 leaves) saved by the
    port restores in the JAX package bit for bit, and the JAX package's
    save restores in the port; ``params_to_flat`` of the served layout
    (--wq-cache's) writes the JAX package's keys and values."""
    cfg = get_config(arch).reduced()
    params = TR.jax_params(arch, fp32=False)
    np_tree = jax.tree.map(np.asarray, params)
    tree = bridge.tree_from_jax(np_tree, cfg, "cpu")
    want = bridge.flatten(np_tree)
    assert list(tree) == list(want)
    path = str(tmp_path / "port.npz")
    checkpoint.save_tree(path, tree, step=7, meta={"arch": cfg.name})
    restored, step = jcheckpoint.restore(path, params)
    assert step == 7
    for key, a in bridge.flatten(jax.tree.map(np.asarray, restored)).items():
        assert a.dtype == want[key].dtype
        np.testing.assert_array_equal(a.astype(np.float32), want[key].astype(np.float32))
    jpath = str(tmp_path / "jax.npz")
    jcheckpoint.save(jpath, params, step=3)
    back, step = checkpoint.restore(jpath, tree)
    assert step == 3 and list(back) == list(tree)
    for key, t in tree.items():
        assert back[key].dtype == t.dtype
        assert torch.equal(back[key], t)
    flat = checkpoint.params_to_flat(bridge.params_from_jax(np_tree, cfg, "cpu"), cfg)
    assert set(flat) == set(want)
    for key, a in want.items():
        np.testing.assert_array_equal(flat[key], a.astype(np.float32))


# ---------------------------------------------------------------------------
# Train steps of the dense family, the driver
# ---------------------------------------------------------------------------


def test_dense_train_step_matches():
    """yi-9b, two steps in fp32: metrics, step 1's gradients and the
    parameters after step 2 against the reference's make_train_step (the
    other dense configs: tests/test_torch_train_dense.py)."""
    params = TR.jax_params("yi-9b")
    TR.assert_step_matches(TR.port_steps("yi-9b", params), TR.jax_steps("yi-9b", params))


def test_dense_train_step_bf16():
    """In bf16, as the driver runs: loss and grad norm within 2e-2 (AdamW
    moves every parameter by about lr at step 1 whatever |g| is, so the
    parameters are held through their gradients, within 5e-2 of each
    leaf's max |g|)."""
    params = TR.jax_params("yi-9b", fp32=False)
    TR.assert_step_matches(TR.port_steps("yi-9b", params), TR.jax_steps("yi-9b", params),
                           metric_tol=2e-2, grad_tol=5e-2, param_tol=None)


def test_driver_losses_match_jax_driver(tmp_path, capsys, monkeypatch):
    """The driver's losses (bf16, reduced yi-9b, 6 steps), started from the
    JAX driver's weights (its seed-0 ``jax.random`` draws, bridged), equal
    the JAX driver's within 2e-2 at every step, both print the same lines,
    and its --ckpt restores in the JAX package."""
    argv = ["--arch", "yi-9b", "--steps", "6", "--global-batch", "4", "--seq-len", "64",
            "--log-every", "1"]
    want = jtrain.main(argv)
    jlines = capsys.readouterr().out.splitlines()
    np_tree = jax.tree.map(np.asarray, TR.jax_params("yi-9b", fp32=False))
    monkeypatch.setattr(T, "init_tree", lambda cfg, ctx, **kw: bridge.tree_from_jax(
        np_tree, cfg, "cpu"))
    path = str(tmp_path / "ckpt.npz")
    got = T.main(argv + ["--device", "cpu", "--ckpt", path])
    lines = capsys.readouterr().out.splitlines()
    assert [h["step"] for h in got] == [h["step"] for h in want] == list(range(6))
    for a, b in zip(got, want):
        assert set(a) == set(b)
        assert abs(a["loss"] - b["loss"]) <= 2e-2 * b["loss"], (a, b)
    assert lines[0] == jlines[0]
    assert [ln.split(" (")[0].split(" loss")[0] for ln in lines[1:7]] == \
        [ln.split(" (")[0].split(" loss")[0] for ln in jlines[1:7]]
    params = TR.jax_params("yi-9b", fp32=False)
    restored, step = jcheckpoint.restore(path, params)
    assert step == 6 and checkpoint.load_meta(path)["meta"]["arch"] == "yi-9b-smoke"


def test_driver_defaults_to_the_card():
    """Without --device the driver runs on cuda, and raises without a card."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        T.main(["--steps", "1"])


def test_check_trainable_refuses_by_name():
    """tp > 1 trains the dense family only; the serving layouts and padded
    heads are refused by name."""
    for arch, what in (("recurrentgemma-9b", "rglru layers at tp>1"),
                       ("deepseek-moe-16b", "moe layers at tp>1"),
                       ("minicpm3-4b", "mla layers at tp>1"),
                       ("mamba2-1.3b", "ssd layers at tp>1"),
                       ("internvl2-26b", "a frontend at tp>1"),
                       ("musicgen-medium", "a multi-codebook head at tp>1")):
        with pytest.raises(NotImplementedError, match=what):
            M.check_trainable(get_config(arch), ParallelConfig(tp=2))
        M.check_trainable(get_config(arch).reduced(), ParallelConfig(dp=2))
    with pytest.raises(NotImplementedError, match="padded heads"):
        M.check_trainable(get_config("yi-9b").reduced(), ParallelConfig(tp=8))
    with pytest.raises(NotImplementedError, match="serving layouts"):
        M.check_trainable(get_config("yi-9b"), ParallelConfig(weight_quant="int8"))
    for arch in DENSE:
        M.check_trainable(get_config(arch), ParallelConfig(tp=8, dp=2))
