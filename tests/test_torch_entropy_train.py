"""The port's straight-through bounds, the bottleneck's training functions
and the rate/distortion loss (on the CPU) against the JAX package."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cnn_autoencoder_tpu.criteria.loss import setup_loss as jax_setup_loss
from cnn_autoencoder_tpu.models import entropy as jax_entropy
from cnn_autoencoder_tpu.ops import bounds as jax_bounds
from cnn_autoencoder_tpu.training.checkpoint import \
    load_checkpoint as jax_load_checkpoint
from cnn_autoencoder_tpu_torch.criteria.loss import setup_loss
from cnn_autoencoder_tpu_torch.models import entropy
from cnn_autoencoder_tpu_torch.ops import bounds

FIXTURES = ["benchmarks/bench_flagship.msgpack",
            "benchmarks/bench_flagship_lam002.msgpack",
            "benchmarks/bench_flagship_lam05.msgpack"]


def _fact_ent(path):
    params = jax_load_checkpoint(path)["fact_ent"]["params"]
    return ({k: jnp.asarray(v) for k, v in params.items()},
            {k: torch.from_numpy(np.array(v)) for k, v in params.items()})


@pytest.mark.parametrize("which", ["lower", "upper"])
def test_bounds_gradients_match_jax(which):
    """Values and the straight-through gradients, on both sides of the
    bound and with both signs of the incoming gradient; exact."""
    rng = np.random.RandomState(0)
    x = rng.randn(400).astype(np.float32)
    x[:8] = 0.25                                   # exactly at the bound
    cot = rng.randn(400).astype(np.float32)
    fn_j = getattr(jax_bounds, f"{which}_bound")
    fn_t = getattr(bounds, f"{which}_bound")
    y_j, vjp = jax.vjp(lambda v: fn_j(v, 0.25), jnp.asarray(x))
    (g_j,) = vjp(jnp.asarray(cot))
    x_t = torch.from_numpy(x).requires_grad_()
    y_t = fn_t(x_t, 0.25)
    y_t.backward(torch.from_numpy(cot))
    np.testing.assert_array_equal(y_t.detach().numpy(), np.asarray(y_j))
    np.testing.assert_array_equal(x_t.grad.numpy(), np.asarray(g_j))
    # the rule differs from clamp's: gradient passes below the bound when
    # it pushes the value back toward it
    assert np.any(x_t.grad.numpy()[(x < 0.25) if which == "lower"
                                   else (x > 0.25)] != 0)


@pytest.mark.parametrize("minimum", [0.0, 1e-6])
def test_nonneg_param_gradient_matches_jax(minimum):
    rng = np.random.RandomState(1)
    s = rng.randn(500).astype(np.float32) * 0.01
    cot = rng.randn(500).astype(np.float32)
    g_j = jax.grad(lambda v: jnp.vdot(jax_bounds.nonneg_param(v, minimum),
                                      cot))(jnp.asarray(s))
    s_t = torch.from_numpy(s).requires_grad_()
    (bounds.nonneg_param(s_t, minimum) * torch.from_numpy(cot)).sum() \
        .backward()
    np.testing.assert_allclose(s_t.grad.numpy(), np.asarray(g_j),
                               rtol=1e-6, atol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_likelihood_and_gradients_match_jax(dtype):
    """likelihood_fn (unrolled chain, stop-gradient sign, bounded) and its
    gradients with respect to v and every chain parameter, on the flagship
    bottleneck; float32 and bf16 latents (v +- 0.5 round in v's dtype in
    both packages).  Values to 1e-5 relative, gradients to 1e-4 of their
    max (the two chains round at about 1e-7)."""
    p_j, p_t = _fact_ent(FIXTURES[0])
    rng = np.random.RandomState(2)
    c = p_t["quantiles"].shape[0]
    v = torch.from_numpy(rng.randn(2, 4, 4, c).astype(np.float32) * 3)
    v = v.to(getattr(torch, dtype))
    v_j = jnp.asarray(v.float().numpy()).astype(getattr(jnp, dtype))
    cot = rng.rand(2, 4, 4, c).astype(np.float32)
    names = [k for k in p_t if k != "quantiles"]

    def loss_j(v, chain):
        params = dict(p_j, **chain)
        return jnp.vdot(jax_entropy.likelihood_fn(params, v, 4), cot)

    lik_j = jax_entropy.likelihood_fn(p_j, v_j, 4)
    gv_j, gp_j = jax.grad(loss_j, argnums=(0, 1))(
        v_j, {k: p_j[k] for k in names})

    v_t = v.clone().requires_grad_()
    chain = {k: p_t[k].clone().requires_grad_() for k in names}
    lik_t = entropy.likelihood_fn(dict(p_t, **chain), v_t, 4)
    assert lik_t.dtype == torch.float32
    np.testing.assert_allclose(lik_t.detach().numpy(), np.asarray(lik_j),
                               rtol=1e-5, atol=1e-9)
    (lik_t * torch.from_numpy(cot)).sum().backward()
    pairs = [(v_t.grad.float(), gv_j)] + [(chain[k].grad, gp_j[k])
                                          for k in names]
    for got, ref in pairs:
        ref = np.asarray(ref, np.float32)
        np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                   atol=1e-4 * np.abs(ref).max() + 1e-12)


def test_aux_loss_moves_only_the_quantiles():
    """aux_loss_fn and its gradient: the quantiles' gradient matches JAX's
    to 1e-5 relative, and no chain parameter gets one."""
    p_j, p_t = _fact_ent(FIXTURES[1])
    rng = np.random.RandomState(3)
    q = p_t["quantiles"] + torch.from_numpy(
        rng.randn(*p_t["quantiles"].shape).astype(np.float32))
    val_j, g_j = jax.value_and_grad(
        lambda qq: jax_entropy.aux_loss_fn(dict(p_j, quantiles=qq), 4))(
        jnp.asarray(q.numpy()))
    params = {k: v.clone().requires_grad_() for k, v in p_t.items()}
    params["quantiles"] = q.clone().requires_grad_()
    val_t = entropy.aux_loss_fn(params, 4)
    val_t.backward()
    np.testing.assert_allclose(float(val_t.detach()), float(val_j),
                               rtol=1e-5)
    np.testing.assert_allclose(params["quantiles"].grad.numpy(),
                               np.asarray(g_j), rtol=1e-5, atol=1e-6)
    assert all(params[k].grad is None for k in params if k != "quantiles")


@pytest.mark.parametrize("path", FIXTURES)
def test_fit_quantiles_bisect_matches_jax(path):
    """The bisection lands within 1e-5 of JAX's (a few float32 ulps at the
    fixtures' |q| <= 64: the einsum chains round differently in the last
    bits, which moves where f(mid) crosses the target), and the integer
    supports the CDF tables are baked from are identical."""
    p_j, p_t = _fact_ent(path)
    q_j = np.asarray(jax_entropy.fit_quantiles_bisect(p_j, 4))
    q_t = entropy.fit_quantiles_bisect(p_t, 4).numpy()
    assert q_t.dtype == np.float32 and q_t.shape == q_j.shape
    np.testing.assert_allclose(q_t, q_j, rtol=0, atol=1e-5)

    def support(q):
        med = q[:, 0, 1]
        return (np.ceil(med - q[:, 0, 0]), np.ceil(q[:, 0, 2] - med))
    for a, b in zip(support(q_t), support(q_j)):
        np.testing.assert_array_equal(a, b)


def test_bottleneck_module_noise_and_eval():
    """forward(training=True) adds the given noise; eval rounds to the
    medians; both return the likelihood of y_q."""
    _, p_t = _fact_ent(FIXTURES[0])
    c = p_t["quantiles"].shape[0]
    mod = entropy.FactorizedEntropyBottleneck(c)
    mod.load_state_dict(p_t)
    rng = np.random.RandomState(4)
    y = torch.from_numpy(rng.randn(1, 3, 3, c).astype(np.float32) * 4)
    noise = torch.from_numpy(rng.uniform(-0.5, 0.5, y.shape)
                             .astype(np.float32))
    y_q, p_y = mod(y, training=True, noise=noise)
    torch.testing.assert_close(y_q, y + noise, rtol=0, atol=0)
    torch.testing.assert_close(p_y, entropy.likelihood_fn(
        mod.params(), y_q, 4), rtol=0, atol=0)
    y_e, _ = mod(y)
    med = p_t["quantiles"][:, 0, 1]
    torch.testing.assert_close(y_e, torch.round(y - med) + med)
    gen = torch.Generator().manual_seed(0)
    y_n, _ = mod(y, training=True, generator=gen)
    assert float((y_n - y).abs().max()) <= 0.5


def test_rate_mse_loss_matches_jax():
    """RateMSE with the aux loss, on the same outputs, to 1e-6 relative;
    what is not ported raises."""
    p_j, p_t = _fact_ent(FIXTURES[0])
    rng = np.random.RandomState(5)
    # quantiles away from their fit, so the aux loss is not rounding noise
    q = np.asarray(p_j["quantiles"]) + rng.randn(48, 1, 3).astype(np.float32)
    p_j = dict(p_j, quantiles=jnp.asarray(q))
    p_t = dict(p_t, quantiles=torch.from_numpy(q))
    x = rng.rand(2, 16, 16, 3).astype(np.float32)
    x_r = rng.rand(2, 16, 16, 3).astype(np.float32)
    p_y = rng.uniform(1e-6, 1, (2, 2, 2, 48)).astype(np.float32)
    crit_j = jax_setup_loss("RateMSE", distortion_lambda=0.01)
    crit_t = setup_loss("RateMSE", distortion_lambda=0.01)
    ref = crit_j(jnp.asarray(x), {"x_r": [jnp.asarray(x_r)],
                                  "p_y": jnp.asarray(p_y)},
                 net={"fact_ent_params": p_j, "num_filters": 4})
    got = crit_t(torch.from_numpy(x), {"x_r": [torch.from_numpy(x_r)],
                                       "p_y": torch.from_numpy(p_y)},
                 net={"fact_ent_params": p_t, "num_filters": 4})
    for key in ("loss", "dist_loss", "rate_loss", "entropy_loss"):
        np.testing.assert_allclose(float(got[key]), float(ref[key]),
                                   rtol=1e-6, err_msg=key)
    np.testing.assert_allclose(float(got["dist"][0]), float(ref["dist"][0]),
                               rtol=1e-6)
    for crit in ("RateMSSSIM", "MultiscaleRateMSE", "RateMSEPenaltyA",
                 "RateMSEPenaltyB", "RateMSECrossEntropy"):
        with pytest.raises(ValueError, match="not ported"):
            setup_loss(crit)
