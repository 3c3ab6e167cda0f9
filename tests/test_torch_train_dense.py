"""One train step of each dense config but yi-9b (tests/test_torch_train.py)
against the JAX package's make_train_step (reduced; fp32 parameters as
``tests/dist_checks._fp32`` runs them): qwen2.5-14b and qwen2.5-32b (QKV
bias), qwen-72b (the paper's model: MHA with a QKV bias) and gptj-parallel
(the parallel residual: the attention and FFN partials of one layer summed
unfused, where serving fuses them in one kernel), and two microbatches
against the reference's ``grad_accum=2``; the optimizer state (AdamW's,
ZeRO-1's) bridged back to the JAX package's tree.  Loss, aux and grad norm within
1e-4 relative, every gradient within 1e-4 of its leaf's max |g|, the
parameters after 2 steps within 5e-4."""
import numpy as np
import pytest

import torch_threads  # noqa: F401  (caps torch's threads under xdist)
import torch_train_ref as TR


@pytest.mark.parametrize("arch", ["qwen2.5-14b", "qwen2.5-32b", "qwen-72b", "gptj-parallel"])
def test_dense_train_step_matches(arch):
    params = TR.jax_params(arch)
    TR.assert_step_matches(TR.port_steps(arch, params), TR.jax_steps(arch, params))


def test_grad_accum_matches_jax():
    """Two microbatches, their gradients summed in fp32, against the
    reference's grad_accum=2 (yi-9b)."""
    params = TR.jax_params("yi-9b")
    TR.assert_step_matches(TR.port_steps("yi-9b", params, grad_accum=2),
                           TR.jax_steps("yi-9b", params, grad_accum=2))


@pytest.mark.parametrize("zero1", [False, True])
def test_optimizer_state_bridges_to_jax(zero1):
    """AdamW's moments, and ZeRO-1's in the JAX package's (n_data, chunk)
    layout, bridged back to the JAX package's tree (``bridge.tree_to_jax``),
    equal the reference's after 2 steps, leaf by leaf, within 1e-4 of each
    leaf's max (the moments follow the gradients); ZeRO-1's parameters as
    AdamW's (within 5e-4)."""
    params = TR.jax_params("yi-9b")
    port = TR.port_steps("yi-9b", params, zero1=zero1, state=True)
    ref = TR.jax_steps("yi-9b", params, zero1=zero1, state=True)
    TR.assert_step_matches(port[:3], ref[:3], grad_tol=None if zero1 else 1e-4)
    assert set(port[3]) == set(ref[3])
    for k, want in ref[3].items():
        got = np.asarray(port[3][k], np.float32)
        assert got.shape == want.shape, k
        assert np.abs(got - want).max() <= 1e-4 * max(np.abs(want).max(), 1e-30), k
