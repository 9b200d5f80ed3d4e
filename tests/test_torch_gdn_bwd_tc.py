"""K3, the bf16 mode's GDN backward, on the CPU: its plain version (the
function the tensor-core kernel of ``csrc/gdn_bf16_tc.cu`` is held to on
the card) against the Pallas kernel in interpret mode at C = 3, 128 and
130 (below, at and past the kernel's resident layout), and what the
kernel's wrapper refuses.  The kernel itself runs only on the card
(``chip_smoke.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cnn_autoencoder_tpu.ops.pallas.gdn_kernel import _gdn_train_bwd_pallas
from cnn_autoencoder_tpu_torch.ops.kernels.gdn_kernel import (
    gdn_train_bwd_cuda, gdn_train_bwd_plain)

BF16 = torch.bfloat16


def _ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest distance in bf16 ulps between two bf16 tensors whose
    elements share their signs."""
    return int((a.view(torch.int16).int() - b.view(torch.int16).int())
               .abs().max())


@pytest.mark.parametrize("c", [3, 128, 130])
@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gdn_train_bwd_plain_matches_pallas(c, inverse, dtype):
    """dnb within one bf16 ulp (both compute dnorm in the TPU kernel's
    order and round once); dx to 1e-5 relative plus 1e-5 of max |dx|
    (float32 g: the two sum the C products in another order) or one bf16
    ulp (bf16 g: one rounding of the float32 result)."""
    rng = np.random.RandomState(100 + c + 2 * inverse)
    rows = 77
    gamma = (0.1 * np.eye(c) + 0.01 * rng.rand(c, c)).astype(np.float32)
    tdt = getattr(torch, dtype)
    g = torch.from_numpy(rng.randn(rows, c).astype(np.float32)).to(tdt)
    xb = torch.from_numpy((rng.randn(rows, c) * 1.5).astype(np.float32)) \
        .to(BF16)
    rb = torch.from_numpy((0.3 + rng.rand(rows, c)).astype(np.float32)) \
        .to(BF16)

    def j(t, dt):
        return jnp.asarray(t.float().numpy()).astype(dt)

    dx_j, dnb_j = _gdn_train_bwd_pallas(
        j(g, getattr(jnp, dtype)), j(xb, jnp.bfloat16), j(rb, jnp.bfloat16),
        jnp.asarray(gamma), inverse, True)
    dx_t, dnb_t = gdn_train_bwd_plain(g, xb, rb, torch.from_numpy(gamma),
                                      inverse)
    assert dx_t.dtype == tdt and dnb_t.dtype == BF16
    assert dx_t.shape == dnb_t.shape == (rows, c)
    dnb_ref = torch.from_numpy(np.array(dnb_j, np.float32)).to(BF16)
    assert _ulps(dnb_t, dnb_ref) <= 1
    dx_j = np.array(dx_j, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(dx_t.numpy(), dx_j, rtol=1e-5,
                                   atol=1e-5 * np.abs(dx_j).max())
    else:
        assert _ulps(dx_t, torch.from_numpy(dx_j).to(BF16)) <= 1


@pytest.mark.parametrize("case", ["cpu", "float16", "xb_float32", "strided",
                                  "rb_rows", "gamma"])
def test_gdn_train_bwd_cuda_refuses(case):
    """The K3 wrapper raises ValueError on what it does not take, before it
    needs a card: CPU rows, g in another type than bf16 or float32, xb or
    rb not bf16, non-contiguous rows, residuals of other rows than g, a
    gamma that does not match C."""
    c, n = 8, 4
    g = torch.ones((n, c), dtype=torch.float16 if case == "float16"
                   else BF16)
    if case == "strided":
        g = torch.ones((c, n), dtype=BF16).t()
    xb = torch.ones((n, c), dtype=torch.float32 if case == "xb_float32"
                    else BF16)
    rb = torch.ones((n + (case == "rb_rows"), c), dtype=BF16)
    gamma = torch.zeros((c, c + (case == "gamma")))
    match = {"cpu": "CUDA tensors", "float16": "rows of",
             "xb_float32": "rows of", "strided": "contiguous",
             "rb_rows": "does not match", "gamma": "do not match"}[case]
    with pytest.raises(ValueError, match=match):
        gdn_train_bwd_cuda(g, xb, rb, gamma)
