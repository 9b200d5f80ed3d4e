"""K2, the bf16 mode's GDN forward, on the CPU: its plain version (the
function the tensor-core kernel of ``csrc/gdn_fwd_bf16_tc.cu`` and, for
float32 rows, K1's kernel with r in ``csrc/gdn_tc.cu`` are held to on the
card) against the Pallas kernel in interpret mode at C = 3, 128, 130 and
256 (below, at and past the kernel's resident layout), and what the two
wrappers refuse.  The kernels themselves run only on the card
(``chip_smoke.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cnn_autoencoder_tpu.ops.pallas.gdn_kernel import _gdn_train_fwd_pallas
from cnn_autoencoder_tpu_torch.ops.kernels.gdn_kernel import (
    gdn_train_fwd_cuda, gdn_train_fwd_f32_cuda, gdn_train_fwd_plain)
from tests.test_torch_train_kernels import _y_float32_rel_bound, _y_float64

BF16 = torch.bfloat16


def _ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest distance in bf16 ulps between two bf16 tensors whose
    elements share their signs."""
    return int((a.view(torch.int16).int() - b.view(torch.int16).int())
               .abs().max())


@pytest.mark.parametrize("c", [3, 128, 130, 256])
@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gdn_train_fwd_plain_matches_pallas(c, inverse, dtype):
    """r within one bf16 ulp everywhere, bf16 y within one bf16 ulp (the
    bf16 pool rounds x^2 and gamma to bf16 as the TPU's DEFAULT precision
    does, which the interpreter on the CPU does not: a relative change of
    the norm below 2^-8, so r and y move by less than one ulp before they
    round); float32 y on each side within what float32 can promise of a
    float64 evaluation (``_y_float32_rel_bound``) and the port within
    twice that of JAX."""
    rng = np.random.RandomState(200 + c + 2 * inverse)
    rows = 77
    x = (rng.randn(rows, c) * 1.5).astype(np.float32)
    gamma = (0.1 * np.eye(c) + 0.01 * rng.rand(c, c)).astype(np.float32)
    beta = (1.0 + rng.rand(c)).astype(np.float32)
    tdt = getattr(torch, dtype)
    x_t = torch.from_numpy(x).to(tdt)
    x_j = jnp.array(x_t.float().numpy(), copy=True).astype(getattr(jnp,
                                                                   dtype))

    y_j, rb_j = _gdn_train_fwd_pallas(x_j, jnp.array(gamma, copy=True),
                                      jnp.array(beta, copy=True), inverse,
                                      True)
    y_t, rb_t = gdn_train_fwd_plain(x_t, torch.from_numpy(gamma),
                                    torch.from_numpy(beta), inverse)
    assert y_t.dtype == tdt and rb_t.dtype == BF16
    assert y_t.shape == rb_t.shape == (rows, c)
    assert _ulps(rb_t, torch.from_numpy(np.array(rb_j, np.float32))
                 .to(BF16)) <= 1
    y_j = np.array(y_j, np.float32)
    if dtype == "bfloat16":
        assert _ulps(y_t, torch.from_numpy(y_j).to(BF16)) <= 1
    else:
        x_in = x_t.numpy()
        ref = _y_float64(x_in, gamma, beta, inverse)
        bound = _y_float32_rel_bound(c)
        for side, got in (("port", y_t.numpy()), ("jax", y_j)):
            rel = np.abs(got.astype(np.float64) - ref) / np.abs(ref)
            assert rel.max() <= bound, (side, rel.max(), bound)
        rel = np.abs(y_t.numpy().astype(np.float64) - y_j) / np.abs(ref)
        assert rel.max() <= 2 * bound, (rel.max(), 2 * bound)


@pytest.mark.parametrize("case", ["cpu", "float16", "strided", "gamma",
                                  "beta"])
def test_gdn_train_fwd_cuda_refuses(case):
    """The K2 wrapper raises ValueError on what it does not take, before it
    needs a card: CPU rows, rows in another type than bf16 (float32 rows
    have their own wrapper, ``gdn_train_fwd_f32_cuda``), non-contiguous
    rows, a gamma or a beta that does not match C."""
    c, n = 8, 4
    x = torch.ones((n, c), dtype=torch.float16 if case == "float16"
                   else BF16)
    if case == "strided":
        x = torch.ones((c, n), dtype=BF16).t()
    gamma = torch.zeros((c, c + (case == "gamma")))
    beta = torch.ones(c + (case == "beta"))
    match = {"cpu": "CUDA tensors", "float16": "rows of",
             "strided": "contiguous", "gamma": "do not match",
             "beta": "do not match"}[case]
    with pytest.raises(ValueError, match=match):
        gdn_train_fwd_cuda(x, gamma, beta)


@pytest.mark.parametrize("case", ["cpu", "bf16", "float16", "strided",
                                  "gamma", "beta"])
def test_gdn_train_fwd_f32_cuda_refuses(case):
    """The wrapper of K2 on float32 rows raises ValueError on what it does
    not take, before it needs a card: CPU rows, bf16 rows (which take
    ``gdn_train_fwd_cuda``) and float16 rows, non-contiguous rows, a gamma
    or a beta that does not match C."""
    c = 8
    dtype = {"bf16": torch.bfloat16, "float16": torch.float16}.get(
        case, torch.float32)
    x = torch.ones((4, c), dtype=dtype)
    if case == "strided":
        x = torch.ones((c, 4)).t()
    gamma = torch.zeros((c, c + (case == "gamma")))
    beta = torch.ones(c + (case == "beta"))
    match = {"cpu": "CUDA tensors", "bf16": "rows of", "float16": "rows of",
             "strided": "contiguous", "gamma": "do not match",
             "beta": "do not match"}[case]
    with pytest.raises(ValueError, match=match):
        gdn_train_fwd_f32_cuda(x, gamma, beta)
