"""Weight-quantized serving, port against the JAX package on the same
quantized weights.

The JAX engines run with ``use_pallas=True`` and ``weight_quant`` set, so
every projection and the lm_head go through its Pallas ``dequant_matmul``
in interpret mode; the port runs the kernel's plain version on the CPU.
Logits of a prefill and 8 teacher-forced decode steps agree within the
5e-2 of tests/test_torch_model.py (bf16 activations rounded after sums in
another order), for int8 and int4, on a GQA yi-9b at head_dim 128 and on
qwen-72b (MHA with QKV bias), both reduced.  Wave greedy tokens under int4
match the JAX ``WaveScheduler`` up to near-ties certified as in
tests/test_torch_serve.py.
"""
import dataclasses

import numpy as np
import pytest

from repro.configs import get_config as jget_config
from repro.runtime.scheduler import WaveScheduler as JWaveScheduler
from repro_torch import bridge
from repro_torch.configs import ParallelConfig, SamplingConfig, get_config
from repro_torch.core.wquant import QuantWeight
from repro_torch.launch import serve
from repro_torch.runtime.engine import Engine
from repro_torch.runtime.scheduler import WaveScheduler
from test_torch_model import GQA, assert_logits_match, jax_engine
from test_torch_serve import BATCH, MAX_LEN, TIE_GAP, _certify_tie, _run, _workload

ARCHS = {"yi-9b-gqa": ("yi-9b", GQA), "qwen-72b": ("qwen-72b", {})}


def _configs(name):
    arch, over = ARCHS[name]
    return (dataclasses.replace(jget_config(arch).reduced(), **over),
            dataclasses.replace(get_config(arch).reduced(), **over))


@pytest.mark.parametrize("mode", ["int8", "int4"])
@pytest.mark.parametrize("name", list(ARCHS))
def test_quantized_logits_match_jax(name, mode):
    jcfg, tcfg = _configs(name)
    eng, tree = jax_engine(jcfg, max_len=32, use_pallas=True, weight_quant=mode)
    params = bridge.params_from_jax(tree, tcfg, device="cpu")
    assert isinstance(params["lm_head"], QuantWeight)
    assert_logits_match(eng, tcfg, params)


def test_int4_wave_tokens_match_jax():
    jcfg, tcfg = _configs("yi-9b-gqa")
    jeng, tree = jax_engine(jcfg, MAX_LEN, use_pallas=True, weight_quant="int4")
    # the bridged tree is quantized already: the engine passes it through
    teng = Engine(tcfg, parallel=ParallelConfig(weight_quant="int4"),
                  sampling=SamplingConfig(top_k=1), max_len=MAX_LEN,
                  params=bridge.params_from_jax(tree, tcfg, device="cpu"), device="cpu")
    assert teng.head_f32 is None
    work = [(p, min(m, 6)) for p, m in _workload(tcfg.vocab_size)]
    port = _run(WaveScheduler(teng, BATCH), work, [None] * 7)
    ref = _run(JWaveScheduler(jeng, batch_size=BATCH), work, [None] * 7)
    flips = 0
    for rid in range(7):
        a, b = port[rid].output, ref[rid].output
        assert len(a) == work[rid][1] and ((a >= 0) & (a < tcfg.vocab_size)).all()
        if np.array_equal(a, b):
            continue
        t = int(np.argmax(a != b))
        gap = _certify_tie(teng, work, rid, b, t)
        assert gap < TIE_GAP, f"request {rid} differs at step {t} with top-2 gap {gap}"
        flips += 1
    assert flips <= 2


def test_serve_main_int4_on_cpu(capsys):
    argv = ["--device", "cpu", "--weight-quant", "int4", "--top-k", "1", "--arch", "qwen-72b",
            "--requests", "3", "--batch", "2", "--prompt-len", "8", "--max-new", "5"]
    done = serve.main(argv)
    out = capsys.readouterr().out
    assert "weight quant int4-g128: " in out and "MiB swept/token vs " in out and "x less)" in out
    again = serve.main(argv)
    assert [len(r.output) for r in done] == [5] * 3
    for r1, r2 in zip(done, again):
        np.testing.assert_array_equal(r1.output, r2.output)       # greedy repeats
