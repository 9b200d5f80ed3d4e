"""The port's SSIM and MS-SSIM (``cnn_autoencoder_tpu_torch/ops/msssim.py``)
against the JAX package's ``ops/msssim.py`` on seeded NHWC pairs, at rtol
1e-5.  Sizes walk the pyramid through odd sides mid-way, where the 2x pool
pads symmetrically and counts the pads."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cnn_autoencoder_tpu.ops import msssim as J
from cnn_autoencoder_tpu_torch.ops import msssim as T


def _pair(shape, seed, noise=0.08):
    rng = np.random.default_rng(seed)
    x = rng.random(shape).astype(np.float32)
    y = np.clip(x + rng.normal(0, noise, shape), 0, 1).astype(np.float32)
    return x, y


@pytest.mark.parametrize("win,sigma", [(11, 1.5), (9, 0.75), (7, 0.375)])
def test_ssim_matches_jax(win, sigma):
    x, y = _pair((2, 40, 37, 3), 1)
    want = float(J.ssim(jnp.asarray(x), jnp.asarray(y), win_size=win,
                        win_sigma=sigma))
    got = float(T.ssim(torch.from_numpy(x), torch.from_numpy(y),
                       win_size=win, win_sigma=sigma))
    np.testing.assert_allclose(got, want, rtol=1e-5)


# (shape, win, sigma, data range): 178 x 166 pools to 89, 45, 23 / 83, 42,
# 21; 99 x 101 (win 7) to 50, 25, 13 / 51, 26, 13
MS_CASES = [((2, 178, 166, 3), 11, 1.5, 1.0),
            ((3, 99, 101, 2), 7, 0.375, 1.0),
            ((1, 170, 163, 3), 11, 1.5, 2.0)]


@pytest.mark.parametrize("shape,win,sigma,data_range", MS_CASES)
def test_ms_ssim_matches_jax(shape, win, sigma, data_range):
    x, y = _pair(shape, 7)
    want = float(J.ms_ssim(jnp.asarray(x), jnp.asarray(y),
                           data_range=data_range, win_size=win,
                           win_sigma=sigma))
    got = float(T.ms_ssim(torch.from_numpy(x), torch.from_numpy(y),
                          data_range=data_range, win_size=win,
                          win_sigma=sigma))
    np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("h,w", [(89, 83), (45, 42), (23, 21), (2, 3)])
def test_avg_pool2_windows_match_jax(h, w):
    """``F.avg_pool2d`` with the odd sides' padding and the pads counted
    gives the JAX pool's windows and divisor."""
    x = np.random.default_rng(h * w).random((2, h, w, 3)).astype(np.float32)
    want = np.asarray(J._avg_pool2(jnp.asarray(x)))
    got = T._avg_pool2(torch.from_numpy(x).permute(0, 3, 1, 2))
    got = got.permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_ms_ssim_rejects_too_small_images():
    """The same assert as the JAX function: the smaller side must exceed
    (win - 1) * 2**(levels - 1)."""
    x = np.zeros((1, 160, 200, 1), np.float32)
    with pytest.raises(AssertionError):
        J.ms_ssim(jnp.asarray(x), jnp.asarray(x))
    with pytest.raises(AssertionError):
        T.ms_ssim(torch.from_numpy(x), torch.from_numpy(x))
    ok = np.zeros((1, 161, 161, 1), np.float32)
    assert float(T.ms_ssim(torch.from_numpy(ok), torch.from_numpy(ok))) \
        == pytest.approx(1.0)


def test_bf16_inputs_widened_to_float32():
    """A bf16 reconstruction against the float32 batch: the port widens it
    before the first blur and equals the JAX function on the widened
    values; the JAX function itself raises on the bf16 input."""
    x, y = _pair((2, 178, 166, 3), 3)
    yb = torch.from_numpy(y).to(torch.bfloat16)
    widened = yb.float().numpy()
    want = float(J.ms_ssim(jnp.asarray(widened), jnp.asarray(x)))
    got = float(T.ms_ssim(yb, torch.from_numpy(x)))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    got_ssim = float(T.ssim(yb, torch.from_numpy(x)))
    np.testing.assert_allclose(
        got_ssim, float(J.ssim(jnp.asarray(widened), jnp.asarray(x))),
        rtol=1e-5)
    with pytest.raises(TypeError):
        J.ms_ssim(jnp.asarray(widened, jnp.bfloat16), jnp.asarray(x))


def test_ms_ssim_gradient_matches_jax():
    """d(MS-SSIM)/d(x) against ``jax.grad``'s, as relative L2 error: each
    float32 gradient lies about 6e-5 from the float64 one (the blurred
    second moments cancel), so the two are held to 2e-4 of each other."""
    x, y = _pair((1, 99, 101, 1), 11)
    want = np.asarray(jax.grad(lambda a: J.ms_ssim(
        a, jnp.asarray(y), win_size=7, win_sigma=0.375))(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    T.ms_ssim(xt, torch.from_numpy(y), win_size=7, win_sigma=0.375) \
        .backward()
    got = xt.grad.numpy()
    assert np.linalg.norm(got - want) <= 2e-4 * np.linalg.norm(want)
