"""The port's weight-only quantization against ``repro.core.wquant`` and the
JAX package's dequant matmul, on the same numpy inputs.

Quantization is held bit for bit: packed bytes, bf16 scales, dequantized
weights, the bridge's carrying of a quantized tree, and the port's own
quantization of a bridged bf16 tree against the JAX engine's.  The plain
dequant matmul is held against the Pallas kernel (interpret mode) and the
jnp oracle within the JAX tests' own tolerance, rtol = atol = 2e-5: every
product is exact in fp32 and only the order of the sums differs.  A bf16
output is held to that plus one bf16 ulp of the fp32 oracle, since sums
that differ in their last fp32 bits can round to neighbouring bf16 values.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ParallelConfig as JParallelConfig
from repro.configs import get_config as jget_config
from repro.core import wquant as jwq
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import model as JM
from repro_torch import bridge
from repro_torch.configs import ParallelConfig, get_config
from repro_torch.core import wquant
from repro_torch.core.wquant import QuantWeight
from repro_torch.kernels import ops, ref
from repro_torch.models import model as TM
from test_torch_model import jax_engine

MODES = ("int8", "int4")
# (shape, group): a leading batch axis, a K the group clamp shortens (96 over
# 64 -> 48), the reduced configs' K of 64, 256 and 512, a ragged N
QUANT_SHAPES = [((3, 256, 40), 64), ((96, 33), 64), ((64, 17), 128),
                ((256, 48), 128), ((512, 70), 128), ((2, 4, 64, 256), 128)]


def _bf16(a: np.ndarray):
    """The same bf16 values as a jax array and a torch CPU tensor."""
    j = jnp.asarray(a, jnp.bfloat16)
    return j, bridge.to_torch(np.asarray(j))


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _jbits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shape,group", QUANT_SHAPES)
def test_quantize_matches_jax_bit_for_bit(shape, group, mode):
    jw, tw = _bf16(np.random.default_rng(sum(shape)).normal(0, 0.05, shape))
    a, b = jwq.quantize(jw, mode, group), wquant.quantize(tw, mode, group)
    assert (b.mode, b.group, b.k) == (a.mode, a.group, a.k)
    np.testing.assert_array_equal(_bits(b.q), _jbits(a.q))
    np.testing.assert_array_equal(_bits(b.scale), _jbits(a.scale))
    for jdt, tdt in ((jnp.bfloat16, torch.bfloat16), (jnp.float32, torch.float32)):
        np.testing.assert_array_equal(_bits(wquant.dequantize(b, tdt)),
                                      _jbits(jwq.dequantize(a, jdt)))


def test_pack4_and_unpack4_match_jax():
    q4 = np.random.default_rng(0).integers(-8, 8, (2, 10, 7)).astype(np.int8)
    packed = wquant.pack4(torch.from_numpy(q4))
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jwq.pack4(jnp.asarray(q4))))
    np.testing.assert_array_equal(wquant.unpack4(packed).numpy(), q4)
    assert packed.dtype == torch.uint8 and wquant.unpack4(packed).dtype == torch.int8


@pytest.mark.parametrize("mode", MODES)
def test_quant_bytes_and_predicates_match_jax(mode):
    for shape, group in QUANT_SHAPES + [((80, 8192, 24576), 128), ((1, 8192, 151936), 128),
                                        ((5, 7), 128), ((3,), 128)]:
        assert wquant.quantizable(shape, mode, group) == jwq.quantizable(shape, mode, group)
        if wquant.quantizable(shape, mode, group):
            assert wquant.quant_bytes(shape, mode, group) == jwq.quant_bytes(shape, mode, group)
        assert wquant.effective_group(shape[-1], group) == jwq.effective_group(shape[-1], group)


@functools.lru_cache(maxsize=None)
def _dq_case(T, K, N, mode):
    """Inputs (torch x, port QuantWeight) and the JAX oracle's and Pallas
    kernel's fp32 outputs, computed once for both out dtypes."""
    rng = np.random.default_rng(T + K)
    jw, tw = _bf16(rng.normal(0, 0.05, (K, N)))
    jx, tx = _bf16(rng.normal(0, 1, (T, K)))
    a, b = jwq.quantize(jw, mode, 64), wquant.quantize(tw, mode, 64)
    oracle = np.asarray(jref.dequant_matmul_ref(jx, a.q, a.scale, a.mode, a.group or 1))
    kernel = np.asarray(jops.dequant_matmul(jx, a.q, a.scale, mode=a.mode, group=a.group,
                                            out_dtype=jnp.float32))
    return tx, b, oracle, kernel


@pytest.mark.parametrize("out", ["fp32", "bf16"])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("T,K,N", [(3, 256, 384), (40, 512, 256), (9, 64, 512), (130, 320, 96)])
def test_dequant_matmul_plain_matches_jax(T, K, N, mode, out):
    """The GEMV and GEMM shapes of tests/test_wquant.py, group 64."""
    tx, b, oracle, kernel = _dq_case(T, K, N, mode)
    plain = ref.dequant_matmul_ref(tx, b.q, b.scale, b.mode, b.group)
    assert plain.dtype == torch.float32 and plain.shape == (T, N)
    tdt = torch.float32 if out == "fp32" else torch.bfloat16
    got = ops.dequant_matmul(tx, b.q, b.scale, mode=b.mode, group=b.group, out_dtype=tdt)
    assert got.dtype == tdt and got.shape == (T, N)
    np.testing.assert_allclose(plain.numpy(), oracle, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(plain.numpy(), kernel, rtol=2e-5, atol=2e-5)
    if out == "fp32":
        np.testing.assert_allclose(got.numpy(), kernel, rtol=2e-5, atol=2e-5)
    else:   # one bf16 ulp (the spacing of bf16 values at |oracle|) beyond that
        ulp = np.ldexp(1.0, np.frexp(oracle)[1] - 8) + 2e-5 * np.maximum(1, np.abs(oracle))
        assert (np.abs(got.float().numpy() - oracle) <= ulp).all()
    wrapped = wquant.matmul(tx.reshape(T, 1, K), b, out_dtype=tdt)       # (..., K) routing
    np.testing.assert_array_equal(_bits(wrapped.reshape(T, N)), _bits(got))


def test_dequant_matmul_wrapper_checks_its_arguments():
    x = torch.zeros(2, 64, dtype=torch.bfloat16)
    w8 = wquant.quantize(torch.ones(64, 16, dtype=torch.bfloat16), "int8", 128)
    w4 = wquant.quantize(torch.ones(64, 16, dtype=torch.bfloat16), "int4", 32)
    with pytest.raises(ValueError, match="mode"):
        ops.dequant_matmul(x, w8.q, w8.scale, mode="int2", group=0)
    with pytest.raises(ValueError, match="takes q"):
        ops.dequant_matmul(x[:, :32], w8.q, w8.scale, mode="int8", group=0)
    with pytest.raises(ValueError, match="takes q"):
        ops.dequant_matmul(x, w4.q, w4.scale, mode="int8", group=0)
    with pytest.raises(ValueError, match="even groups"):
        ops.dequant_matmul(x, w4.q, w4.scale, mode="int4", group=48)
    with pytest.raises(ValueError, match="2-D"):
        wquant.matmul(x, QuantWeight(w4.q[None], w4.scale[None], "int4", 32, 64))
    assert ops.dequant_matmul(x, w4.q, w4.scale, mode="int4", group=32).shape == (2, 16)


@pytest.mark.parametrize("arch", ["yi-9b", "qwen-72b"])
@pytest.mark.parametrize("mode", ("none",) + MODES)
def test_decode_weight_bytes_match_jax(arch, mode):
    """Full-size configs, from shapes alone on both sides (no allocation)."""
    jctx = JM.ModelCtx.make(jget_config(arch), JParallelConfig(tp=1, dp=1, remat=False,
                                                               weight_quant=mode))
    got = TM.decode_weight_bytes(get_config(arch), ParallelConfig(weight_quant=mode))
    assert got == JM.decode_weight_bytes(jctx)
    if mode == "int4" and arch == "qwen-72b":
        assert round(got["swept"] / 1e9, 1) == 36.6


def _quant_leaf_names(layer: dict) -> set:
    return {k for k, v in layer.items() if isinstance(v, QuantWeight) or hasattr(v, "group")}


def _jax_layer(tree) -> dict:
    sub = tree["groups"][0]["sub0"]
    return {**sub["mixer"], **sub["ffn"]}


def _assert_same_bytes(a: QuantWeight, b: QuantWeight):
    assert (a.mode, a.group, a.k) == (b.mode, b.group, b.k)
    np.testing.assert_array_equal(_bits(a.q), _bits(b.q))
    np.testing.assert_array_equal(_bits(a.scale), _bits(b.scale))


@pytest.mark.parametrize("mode", MODES)
def test_bridge_carries_a_quantized_tree_and_port_quantization_matches(mode):
    """qwen-72b reduced (MHA, QKV bias; w_o's K of 64 gets its own group)."""
    jcfg, tcfg = jget_config("qwen-72b").reduced(), get_config("qwen-72b").reduced()
    _, qtree = jax_engine(jcfg, max_len=16, weight_quant=mode)
    _, btree = jax_engine(jcfg, max_len=16)
    carried = bridge.params_from_jax(qtree, tcfg, device="cpu")
    mine = TM.quantize_params(bridge.params_from_jax(btree, tcfg, device="cpu"),
                              ParallelConfig(weight_quant=mode))
    jlayer = _jax_layer(qtree)
    names = _quant_leaf_names(jlayer)
    assert names == {"w_q", "w_k", "w_v", "w_o", "w_up", "w_gate", "w_down"}
    for i in range(tcfg.n_layers):
        assert _quant_leaf_names(carried["layers"][i]) == names
        assert _quant_leaf_names(mine["layers"][i]) == names
        for name in names:
            a = carried["layers"][i][name]
            np.testing.assert_array_equal(_bits(a.q), _jbits(jlayer[name].q[i]))
            np.testing.assert_array_equal(_bits(a.scale), _jbits(jlayer[name].scale[i]))
            _assert_same_bytes(a, mine["layers"][i][name])
        for name in ("b_q", "norm1"):
            np.testing.assert_array_equal(_bits(carried["layers"][i][name]),
                                          _bits(mine["layers"][i][name]))
    np.testing.assert_array_equal(_bits(carried["lm_head"].q), _jbits(qtree["lm_head"].q))
    _assert_same_bytes(carried["lm_head"], mine["lm_head"])
    assert carried["embed"]["table"].dtype == torch.bfloat16
    # quantize_params passes a quantized tree through untouched
    again = TM.quantize_params(carried, ParallelConfig(weight_quant=mode))
    assert again["layers"][0]["w_up"].q is carried["layers"][0]["w_up"].q


@pytest.mark.parametrize("mode", MODES)
def test_init_params_draws_straight_into_packed_leaves(mode):
    """The quantized draw packs exactly the leaves ``_map_wq_leaves`` names
    (the projections and the lm_head, not embed, norms or biases) and equals
    quantizing the bf16 draw of the same seed."""
    cfg = dataclasses.replace(get_config("qwen-72b").reduced(), n_layers=3)
    par = ParallelConfig(weight_quant=mode, wq_group_size=64)
    qp = TM.init_params(cfg, par, seed=4, device="cpu")
    ref_p = TM.quantize_params(TM.init_params(cfg, seed=4, device="cpu"), par)
    dtype = torch.int8 if mode == "int8" else torch.uint8
    for layer, want in zip(qp["layers"], ref_p["layers"]):
        assert _quant_leaf_names(layer) == set(TM.WQ_SITES) - {"lm_head"}
        for name, leaf in layer.items():
            if isinstance(leaf, QuantWeight):
                assert leaf.q.dtype == dtype and leaf.scale.dtype == torch.bfloat16
                _assert_same_bytes(leaf, want[name])
            else:
                assert leaf.dtype == torch.bfloat16
                np.testing.assert_array_equal(_bits(leaf), _bits(want[name]))
    assert isinstance(qp["lm_head"], QuantWeight) and qp["lm_head"].q.dtype == dtype
    _assert_same_bytes(qp["lm_head"], ref_p["lm_head"])
    assert qp["embed"]["table"].dtype == qp["final_norm"].dtype == torch.bfloat16
    # every layer's packed leaf is a view of one stacked tensor
    base = qp["layers"][0]["w_q"].q
    assert all(layer["w_q"].q.untyped_storage().data_ptr() == base.untyped_storage().data_ptr()
               for layer in qp["layers"])
