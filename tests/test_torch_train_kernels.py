"""The port's training kernels' plain versions and their autograd wrappers
(on the CPU) against the JAX package: K2/K3 against the Pallas training
kernels in interpret mode, ``gdn_mixed`` and the K1 wrapper against
``jax.grad``, K4's ``want_y`` variant against the Pallas kernel and its
backward against ``jax.grad(fused_conv_gdn)``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cnn_autoencoder_tpu.ops import convops as jax_convops
from cnn_autoencoder_tpu.ops.gdn import gdn_mixed as jax_gdn_mixed
from cnn_autoencoder_tpu.ops.pallas import conv_gdn_kernel as jax_cg
from cnn_autoencoder_tpu.ops.pallas.gdn_kernel import (
    _gdn_train_bwd_pallas, _gdn_train_fwd_pallas)
from cnn_autoencoder_tpu.ops.pallas.gdn_kernel import \
    fused_gdn as jax_fused_gdn
from cnn_autoencoder_tpu_torch.ops.gdn import gdn_mixed
from cnn_autoencoder_tpu_torch.ops.kernels.conv_gdn_kernel import (
    conv_gdn_train, fused_conv_gdn)
from cnn_autoencoder_tpu_torch.ops.kernels.gdn_kernel import (fused_gdn,
                                                              gdn_train_bwd,
                                                              gdn_train_fwd)

BF16 = torch.bfloat16


def _params(c, rng):
    gamma = (0.1 * np.eye(c) + 0.01 * rng.rand(c, c)).astype(np.float32)
    beta = (1.0 + rng.rand(c)).astype(np.float32)
    return gamma, beta


def _to_bf16(a) -> torch.Tensor:
    """A JAX or numpy array as a torch bf16 tensor (rounded to nearest
    even, as both packages round)."""
    return torch.from_numpy(np.array(a, np.float32)).to(BF16)


def _ulps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Distance in bf16 ulps between two bf16 tensors of the same signs."""
    return (a.view(torch.int16).int() - b.view(torch.int16).int()).abs()


def _y_float64(x, gamma, beta, inverse):
    """K2's y in float64 on float32 inputs."""
    x64 = x.astype(np.float64)
    norm = (x64 * x64) @ gamma.astype(np.float64).T + beta
    return x64 * (np.sqrt(norm) if inverse else 1.0 / np.sqrt(norm))


def _y_float32_rel_bound(c):
    """Relative error a float32 evaluation of K2's y can have against the
    float64 one, in any order of summation (u = 2^-24): x^2 and each
    product x^2 gamma round once (2u a term); beta and the C terms, all
    non-negative, sum in float32 within C u; so norm is within (C + 2) u.
    The root halves that and rounds (a library rsqrt or sqrt within 2 ulp),
    and x r rounds once: ((C + 2) / 2 + 3) u, 1.67e-6 at C = 48."""
    return ((c + 2) / 2 + 3) * 2.0 ** -24


@pytest.mark.parametrize("c", [48, 128])
@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gdn_train_kernels_plain_match_pallas(c, inverse, dtype):
    """K2 then K3: float32 y on each side within what float32 can promise
    of a float64 evaluation of the same function (``_y_float32_rel_bound``:
    the two sides sum the pool in another order, so a fixed 1e-6 between
    them sat at C = 48 below that) and the port within twice that of JAX,
    bf16 y to one bf16 ulp, r and dnb to
    one bf16 ulp everywhere (the bf16 pool rounds x^2 and gamma as the
    TPU's DEFAULT precision does, which the interpreter on the CPU does
    not), dx to 1e-5 of max |dx|."""
    rng = np.random.RandomState(c + 2 * inverse)
    x = (rng.randn(300, c) * 1.5).astype(np.float32)
    gamma, beta = _params(c, rng)
    g = rng.randn(300, c).astype(np.float32)
    tdt = getattr(torch, dtype)
    x_t = torch.from_numpy(x).to(tdt)
    # the JAX side gets arrays of its own (no buffer shared with torch's)
    x_j = jnp.array(x_t.float().numpy(), copy=True).astype(getattr(jnp,
                                                                   dtype))

    y_j, rb_j = _gdn_train_fwd_pallas(x_j, jnp.array(gamma, copy=True),
                                      jnp.array(beta, copy=True), inverse,
                                      True)
    y_j, rb_j = jax.block_until_ready((y_j, rb_j))
    y_t, rb_t = gdn_train_fwd(x_t, torch.from_numpy(gamma),
                              torch.from_numpy(beta), inverse)
    assert y_t.dtype == tdt and rb_t.dtype == BF16
    if dtype == "float32":
        ref = _y_float64(x, gamma, beta, inverse)
        bound = _y_float32_rel_bound(c)
        for side, got in (("port", y_t.numpy()), ("jax", np.asarray(y_j))):
            rel = np.abs(got.astype(np.float64) - ref) / np.abs(ref)
            assert rel.max() <= bound, (side, rel.max(), bound,
                                        float(np.mean(rel > bound)))
        # and the port against JAX directly, within both sides' bounds
        rel = (np.abs(y_t.numpy().astype(np.float64) - np.asarray(y_j))
               / np.abs(ref))
        assert rel.max() <= 2 * bound, (rel.max(), 2 * bound)
    else:
        assert int(_ulps(y_t, _to_bf16(y_j)).max()) <= 1
    assert int(_ulps(rb_t, _to_bf16(rb_j)).max()) <= 1

    g_t = torch.from_numpy(g).to(tdt)
    g_j = jnp.asarray(g_t.float().numpy()).astype(getattr(jnp, dtype))
    xb_t = x_t.to(BF16)
    dx_j, dnb_j = _gdn_train_bwd_pallas(
        g_j, jnp.asarray(xb_t.float().numpy()).astype(jnp.bfloat16),
        jnp.asarray(rb_t.float().numpy()).astype(jnp.bfloat16),
        jnp.asarray(gamma), inverse, True)
    dx_t, dnb_t = gdn_train_bwd(g_t, xb_t, rb_t, torch.from_numpy(gamma),
                                inverse)
    assert dx_t.dtype == tdt and dnb_t.dtype == BF16
    assert int(_ulps(dnb_t, _to_bf16(dnb_j)).max()) <= 1
    dx_j = np.asarray(dx_j, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(dx_t.numpy(), dx_j, rtol=1e-5,
                                   atol=1e-5 * np.abs(dx_j).max())
    else:
        assert int(_ulps(dx_t, _to_bf16(dx_j)).max()) <= 1


@pytest.mark.parametrize("inverse", [False, True])
def test_gdn_mixed_gradients_match_jax(inverse):
    """The port's gdn_mixed (K2/K3 plain versions, dbeta from dnb) against
    jax.grad of the JAX package's gdn_mixed (its XLA path) on bf16
    activations: values to one bf16 ulp, gradients to 2e-2 of their max
    (the tolerance of tests/test_gdn.py:172)."""
    rng = np.random.RandomState(7 + inverse)
    c = 48
    x = _to_bf16(rng.randn(2, 9, 9, c) * 2)
    gamma, beta = _params(c, rng)
    cot = rng.randn(2, 9, 9, c).astype(np.float32)

    def loss_j(x, gamma, beta):
        y = jax_gdn_mixed(x, gamma, beta, inverse)
        return jnp.vdot(y.astype(jnp.float32), cot)

    x_j = jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
    g_j = jax.grad(loss_j, argnums=(0, 1, 2))(x_j, jnp.asarray(gamma),
                                              jnp.asarray(beta))
    y_j = jax_gdn_mixed(x_j, jnp.asarray(gamma), jnp.asarray(beta), inverse)

    x_t = x.reshape(-1, c).requires_grad_()
    gamma_t = torch.from_numpy(gamma).requires_grad_()
    beta_t = torch.from_numpy(beta).requires_grad_()
    y_t = gdn_mixed(x_t, gamma_t, beta_t, inverse)
    assert y_t.dtype == BF16
    assert int(_ulps(y_t.detach(), _to_bf16(y_j).reshape(-1, c)).max()) <= 1
    (y_t.float() * torch.from_numpy(cot).reshape(-1, c)).sum().backward()
    assert x_t.grad.dtype == BF16
    for got, ref in zip((x_t.grad.reshape(x.shape), gamma_t.grad,
                         beta_t.grad), g_j):
        ref = np.asarray(ref, np.float32)
        err = np.abs(got.float().numpy() - ref).max()
        assert err / np.abs(ref).max() < 2e-2, (inverse, err)


@pytest.mark.parametrize("inverse", [False, True])
def test_k1_autograd_wrapper_matches_jax_grad(inverse):
    """fused_gdn (K1 forward, recomputed plain backward) against
    jax.grad(fused_gdn), float32, to 1e-5."""
    rng = np.random.RandomState(3 + inverse)
    c = 32
    x = rng.randn(200, c).astype(np.float32)
    gamma, beta = _params(c, rng)
    cot = rng.randn(200, c).astype(np.float32)
    g_j = jax.grad(lambda *a: jnp.vdot(jax_fused_gdn(*a, inverse), cot),
                   argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(gamma),
                                      jnp.asarray(beta))
    ts = [torch.from_numpy(a).requires_grad_() for a in (x, gamma, beta)]
    (fused_gdn(*ts, inverse) * torch.from_numpy(cot)).sum().backward()
    for t, ref in zip(ts, g_j):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(ref),
                                   rtol=1e-5, atol=1e-5)


def _conv_case(seed, cin=64, cout=48, hw=8):
    rng = np.random.RandomState(seed)
    x = (rng.randn(2, hw, hw, cin) * 0.5).astype(np.float32)
    k = (rng.randn(3, 3, cin, cout) * 0.05).astype(np.float32)
    gamma = (rng.rand(cout, cout) * 0.05).astype(np.float32)
    beta = (rng.rand(cout) + 0.5).astype(np.float32)
    return x, k, gamma, beta


@pytest.mark.parametrize("mode", ["float32", "bf16"])
def test_conv_gdn_want_y_plain_matches_pallas(mode):
    """K4's training variant: out and the float32 pre-GDN y against the
    Pallas kernel (interpret, want_y=True), in float32 and under
    set_default_precision("bf16").  x holds bf16 values, so both packages
    multiply the same numbers; y to 1e-5 of max |y|, out to 1e-5 of max
    |out| (float32) or one bf16 ulp."""
    x, k, gamma, beta = _conv_case(5)
    x = torch.from_numpy(x).to(BF16).float().numpy()
    if mode == "bf16":
        jax_convops.set_default_precision("bf16")
    try:
        out_j, y_j = jax_cg._fused_conv_gdn_pallas(
            *[jnp.asarray(a) for a in (x, k, gamma, beta)], interpret=True,
            want_y=True)
    finally:
        jax_convops.set_default_precision("highest")
    x_t = torch.from_numpy(x).to(BF16 if mode == "bf16" else torch.float32)
    out_t, y_t = conv_gdn_train(x_t, torch.from_numpy(k),
                                torch.from_numpy(gamma),
                                torch.from_numpy(beta))
    assert y_t.dtype == torch.float32 and out_t.dtype == x_t.dtype
    y_j, out_j = np.asarray(y_j), np.asarray(out_j)
    np.testing.assert_allclose(y_t.numpy(), y_j, rtol=0,
                               atol=1e-5 * np.abs(y_j).max())
    if mode == "bf16":
        assert int(_ulps(out_t, _to_bf16(out_j)).max()) <= 1
    else:
        np.testing.assert_allclose(out_t.numpy(), out_j, rtol=0,
                                   atol=1e-5 * np.abs(out_j).max())


def test_conv_gdn_backward_matches_jax_grad(monkeypatch):
    """The analytic backward of fused_conv_gdn against
    jax.grad(fused_conv_gdn) with the Pallas kernel in interpret mode
    (the pattern of tests/test_pallas_kernels.py:232-249), float32."""
    monkeypatch.setenv("CAE_TPU_PALLAS_INTERPRET", "1")
    args = _conv_case(2)
    g_j = jax.grad(lambda *a: jnp.sum(jax_cg.fused_conv_gdn(*a) ** 2),
                   argnums=(0, 1, 2, 3))(*[jnp.asarray(a) for a in args])
    ts = [torch.from_numpy(a).requires_grad_() for a in args]
    (fused_conv_gdn(*ts) ** 2).sum().backward()
    for t, ref in zip(ts, g_j):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(ref),
                                   rtol=1e-4, atol=1e-5)


def test_conv_gdn_backward_bf16_mode():
    """bf16 compute: the JAX package's own bf16 backward of fused_conv_gdn
    does not run (its transpose meets a float32 cotangent against a bf16
    kernel), so the port's is held to jax.grad of the float32 function on
    the same bf16-valued inputs, to 2e-2 of each gradient's max (bf16
    cotangents and operands in the conv backward)."""
    x, k, gamma, beta = _conv_case(9)
    x = torch.from_numpy(x).to(BF16)
    k = torch.from_numpy(k).to(BF16).float().numpy()
    ref = jax.grad(lambda *a: jnp.sum(jax_cg._conv_gdn_xla(*a) ** 2),
                   argnums=(0, 1, 2, 3))(
        jnp.asarray(x.float().numpy()), jnp.asarray(k), jnp.asarray(gamma),
        jnp.asarray(beta))
    ts = [x.requires_grad_()] + [torch.from_numpy(a).requires_grad_()
                                 for a in (k, gamma, beta)]
    out = fused_conv_gdn(*ts)
    assert out.dtype == BF16
    (out.float() ** 2).sum().backward()
    assert ts[0].grad.dtype == BF16
    for t, r in zip(ts, ref):
        r = np.asarray(r)
        err = np.abs(t.grad.float().numpy() - r).max()
        assert err / np.abs(r).max() < 2e-2, err
