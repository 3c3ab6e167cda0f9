"""One train step of each MoE and MLA config of the port against the JAX
package's make_train_step (reduced; fp32 parameters as
``tests/dist_checks._fp32`` runs them): deepseek-moe-16b (a dense layer 0
beside the MoE layers, shared experts, the load-balance loss), mixtral-8x7b
(MoE over a sliding window) and minicpm3-4b (latent attention).  Loss, aux
and grad norm within 1e-4 relative, every gradient within 1e-4 of its
leaf's max |g|, the parameters after 2 steps within 5e-4; in bf16, as the
driver runs, the loss and grad norm within 2e-2 (deepseek).

Reduced mixtral routes each token over 4 experts top 2, where router
near-ties are common (tests/test_torch_mixtral.py): its steps replay the
reference's expert choices through ``moe.ROUTE_REPLAY``, every token the
port's own router ranks apart certified a near-tie, both packages without
activation checkpointing (so each forward routes once)."""
import numpy as np
import pytest

import torch_threads  # noqa: F401  (caps torch's threads under xdist)
import torch_train_ref as TR
from test_torch_mixtral import jax_routes


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "minicpm3-4b"])
def test_train_step_matches(arch):
    params = TR.jax_params(arch)
    TR.assert_step_matches(TR.port_steps(arch, params), TR.jax_steps(arch, params))


def test_mixtral_train_step_matches_replaying_routes(monkeypatch):
    """mixtral-8x7b: the reference's routes replayed in the port's steps."""
    arch = "mixtral-8x7b"
    params = TR.jax_params(arch)
    with jax_routes(monkeypatch) as replay:
        ref = TR.jax_steps(arch, params, remat=False)
        routes = [np.asarray(r) for r in replay.log]
        # the reference routes its 2 layers once a step; the port routes
        # step 1's batch a first time for its gradients
        assert len(routes) == 4
        port = replay(lambda: TR.port_steps(arch, params, remat=False),
                      routes=routes[:2] + routes)
    TR.assert_step_matches(port, ref)
    print(f"mixtral: {len(replay.ties)} tokens ranked apart, each a certified near-tie")


def test_moe_train_step_bf16():
    """deepseek-moe-16b in bf16: loss and grad norm within 2e-2 (a router
    near-tie may route a token elsewhere; no gradient is held)."""
    params = TR.jax_params("deepseek-moe-16b", fp32=False)
    TR.assert_step_matches(TR.port_steps("deepseek-moe-16b", params),
                           TR.jax_steps("deepseek-moe-16b", params),
                           metric_tol=2e-2, grad_tol=None, param_tol=None)
