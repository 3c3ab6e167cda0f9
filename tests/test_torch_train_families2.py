"""One train step of each recurrent and modality config of the port against
the JAX package's make_train_step (reduced; fp32 parameters as
``tests/dist_checks._fp32`` runs them): recurrentgemma-9b (the RG-LRU's
associative scan beside windowed attention), mamba2-1.3b (the SSD, the
tied head), internvl2-26b (the modality prefix, dropped before the loss)
and musicgen-medium (codebook frames); and remat off against on.  Loss,
aux and grad norm within 1e-4 relative, every gradient within 1e-4 of its
leaf's max |g|, the parameters after 2 steps within 5e-4; in bf16
(recurrentgemma-9b), the loss and grad norm within 2e-2.

internvl2-26b's projector norm is the one leaf held at 1e-3 of its max
|g|: the normed features are rounded to bf16 before the projector in both
packages (``multimodal.project_features``), so that leaf's gradient passes
a bf16 rounding of its cotangent even in fp32 runs; a one-ulp difference
upstream moves it by ~5e-4 (measured 5.5e-4)."""
import numpy as np
import pytest

import torch_threads  # noqa: F401  (caps torch's threads under xdist)
import torch_train_ref as TR

GRAD_TOLS = {"internvl2-26b": {"frontend/norm": 1e-3}}


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "mamba2-1.3b", "internvl2-26b",
                                  "musicgen-medium"])
def test_train_step_matches(arch):
    params = TR.jax_params(arch)
    TR.assert_step_matches(TR.port_steps(arch, params), TR.jax_steps(arch, params),
                           grad_tols=GRAD_TOLS.get(arch))


def test_recurrent_train_step_bf16():
    params = TR.jax_params("recurrentgemma-9b", fp32=False)
    TR.assert_step_matches(TR.port_steps("recurrentgemma-9b", params),
                           TR.jax_steps("recurrentgemma-9b", params),
                           metric_tol=2e-2, grad_tol=None, param_tol=None)


def test_remat_off_equals_on():
    """Activation checkpointing changes no number: within 1e-6."""
    params = TR.jax_params("recurrentgemma-9b")
    on, off = TR.port_steps("recurrentgemma-9b", params), TR.port_steps(
        "recurrentgemma-9b", params, remat=False)
    for a, b in zip(on[0], off[0]):
        assert all(abs(a[k] - b[k]) <= 1e-6 * max(abs(b[k]), 1e-6) for k in a), (a, b)
    for i in (1, 2):
        assert max(float(np.abs(on[i][k] - off[i][k]).max()) for k in on[i]) <= 1e-6
