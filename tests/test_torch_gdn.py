"""The port's GDN and fused conv+GDN (plain versions, on the CPU) against
the JAX package's modules and Pallas kernels (interpret mode)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cnn_autoencoder_tpu.ops.gdn import GDN as JaxGDN
from cnn_autoencoder_tpu.ops.pallas.conv_gdn_kernel import (
    _conv_gdn_xla, _fused_conv_gdn_pallas)
from cnn_autoencoder_tpu.ops.pallas.gdn_kernel import _gdn_pallas
from cnn_autoencoder_tpu_torch.ops.bounds import nonneg_param
from cnn_autoencoder_tpu_torch.ops.gdn import GDN
from cnn_autoencoder_tpu_torch.ops.kernels.conv_gdn_kernel import \
    conv_gdn_plain
from cnn_autoencoder_tpu_torch.ops.kernels.gdn_kernel import (fused_gdn,
                                                              gdn_plain)


def _stored_params(c, seed):
    """Non-trivial stored (reparameterized) GDN parameters."""
    rng = np.random.RandomState(seed)
    beta = (1.0 + 0.5 * rng.rand(c)).astype(np.float32)
    gamma = (0.3 * rng.rand(c, c)).astype(np.float32)
    return beta, gamma


@pytest.mark.parametrize("c", [3, 16, 48, 128, 130, 256])
@pytest.mark.parametrize("inverse", [False, True])
def test_gdn_matches_jax(c, inverse):
    rng = np.random.RandomState(c + inverse)
    x = rng.randn(2, 8, 8, c).astype(np.float32)
    beta_s, gamma_s = _stored_params(c, c)

    j_mod = JaxGDN(c, inverse=inverse)
    j_vars = {"params": {"beta": jnp.asarray(beta_s),
                         "gamma": jnp.asarray(gamma_s)}}
    j_out = np.asarray(j_mod.apply(j_vars, jnp.asarray(x)))

    t_mod = GDN(c, inverse=inverse)
    with torch.no_grad():
        t_mod.beta.copy_(torch.from_numpy(beta_s))
        t_mod.gamma.copy_(torch.from_numpy(gamma_s))
        t_out = t_mod(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(t_out, j_out, rtol=1e-5, atol=1e-6)

    # the plain version against the Pallas kernel on effective parameters
    gamma = nonneg_param(torch.from_numpy(gamma_s), 0.0)
    beta = nonneg_param(torch.from_numpy(beta_s), 1e-6)
    x2d = x.reshape(-1, c)
    k_out = np.asarray(_gdn_pallas(jnp.asarray(x2d), jnp.asarray(gamma),
                                   jnp.asarray(beta), inverse, True))
    p_out = gdn_plain(torch.from_numpy(x2d), gamma, beta, inverse).numpy()
    np.testing.assert_allclose(p_out, k_out, rtol=1e-5, atol=1e-6)
    d_out = fused_gdn(torch.from_numpy(x2d), gamma, beta, inverse).numpy()
    np.testing.assert_array_equal(d_out, p_out)


def test_nonneg_param_matches_jax():
    from cnn_autoencoder_tpu.ops.bounds import nonneg_param as jax_nonneg
    s = np.random.RandomState(0).randn(1000).astype(np.float32)
    for minimum in (0.0, 1e-6):
        np.testing.assert_array_equal(
            nonneg_param(torch.from_numpy(s), minimum).numpy(),
            np.asarray(jax_nonneg(jnp.asarray(s), minimum)))


def test_conv_gdn_plain_matches_pallas_and_xla():
    rng = np.random.RandomState(7)
    x = rng.rand(2, 16, 16, 64).astype(np.float32)
    kernel = (rng.randn(3, 3, 64, 64) * 0.05).astype(np.float32)
    gamma = (0.1 * rng.rand(64, 64)).astype(np.float32)
    beta = (1.0 + rng.rand(64)).astype(np.float32)
    args = [jnp.asarray(a) for a in (x, kernel, gamma, beta)]
    ref_kernel = np.asarray(_fused_conv_gdn_pallas(*args, interpret=True))
    with jax.default_matmul_precision("highest"):
        ref_xla = np.asarray(_conv_gdn_xla(*args))
    got = conv_gdn_plain(*[torch.from_numpy(a) for a in
                           (x, kernel, gamma, beta)]).numpy()
    assert got.shape == (2, 8, 8, 64)
    np.testing.assert_allclose(got, ref_kernel, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, ref_xla, rtol=1e-5, atol=1e-5)
