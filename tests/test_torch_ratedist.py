"""The port's rate, distortion and energy-penalty losses
(``criteria/ratedist.py``, ``criteria/loss.py``) against the JAX package's
on the same seeded arrays and the same decoder weights: the target
pyramid, MS-SSIM at scales 0-2, the pyramid losses, penalties A and B, the
composed criteria and their gradients, at 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cnn_autoencoder_tpu.criteria import ratedist as JR
from cnn_autoencoder_tpu.criteria.loss import setup_loss as jax_setup_loss
from cnn_autoencoder_tpu.models.factory import build_model as jax_build_model
from cnn_autoencoder_tpu_torch.criteria import ratedist as TR
from cnn_autoencoder_tpu_torch.criteria.loss import setup_loss
from cnn_autoencoder_tpu_torch.models.factory import CAEModel
from cnn_autoencoder_tpu_torch.utils.weights import (state_from_jax,
                                                     state_to_jax)

PATCH, LEVEL, BN = 64, 3, 8
CONFIG = dict(channels_org=3, channels_net=8, channels_bn=BN,
              compression_level=LEVEL, K=4, r=3, act_layer_type="GDN",
              multiscale_analysis=True)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(got, want, rtol=1e-5, atol=0.0, msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rtol,
                               atol=atol, err_msg=msg)


@pytest.fixture(scope="module")
def models():
    """(JAX model, port model) with one set of weights, color layers
    included."""
    j = jax_build_model(jax.random.PRNGKey(3), input_size=(16, 16),
                        **CONFIG)
    t = CAEModel(CONFIG)
    t.load_state_dict(state_from_jax(j.variables, CONFIG), strict=True)
    return j, t


def _batch(b=2, seed=0):
    """x, the x_r pyramid (finest first), y and p_y of a batch."""
    rng = np.random.RandomState(seed)
    x = rng.rand(b, PATCH, PATCH, 3).astype(np.float32)
    x_r = [np.clip(x[:, ::2 ** s, ::2 ** s] + rng.randn(
        b, PATCH >> s, PATCH >> s, 3) * 0.1, 0, 1).astype(np.float32)
        for s in range(LEVEL)]
    y = (rng.randn(b, PATCH >> LEVEL, PATCH >> LEVEL, BN)
         * rng.uniform(0.2, 3, BN)).astype(np.float32)
    p_y = rng.uniform(1e-4, 1, y.shape).astype(np.float32)
    return x, x_r, y, p_y


@pytest.mark.parametrize("h,w", [(64, 64), (33, 47)])
def test_downsample_pyramid_matches_jax(h, w):
    x = np.random.RandomState(h).rand(2, h, w, 3).astype(np.float32)
    want = np.asarray(JR.downsample_pyramid(jnp.asarray(x)))
    got = TR.downsample_pyramid(_t(x))
    assert not got.requires_grad and tuple(got.shape) == want.shape
    _close(got, want, atol=1e-7)


@pytest.mark.parametrize("scale", [0, 1, 2])
def test_dist_msssim_matches_jax(scale):
    """The scale-adaptive window (11 / 9 / 7) and padding (56 / 56 / 48 at
    a 64^2 patch) and 1 - MS-SSIM."""
    x, x_r, _, _ = _batch()
    xs = x[:, ::2 ** scale, ::2 ** scale]
    jd = JR.DistMSSSIM(patch_size=PATCH, scale=scale)
    td = TR.DistMSSSIM(patch_size=PATCH, scale=scale)
    assert (td.win_size, td.win_sigma, td.padding) == \
        (jd.win_size, jd.win_sigma, jd.padding)
    want = float(jd(jnp.asarray(xs), [jnp.asarray(x_r[scale])])["dist"][0])
    got = float(td(_t(xs), [_t(x_r[scale])])["dist"][0])
    # MS-SSIM itself to 1e-5: 1 - MS-SSIM near 0 keeps its float32 ulps
    _close(1.0 - got, 1.0 - want)


@pytest.mark.parametrize("kind", ["mse", "msssim"])
def test_pyramid_losses_match_jax(kind):
    x, x_r, _, _ = _batch()
    if kind == "mse":
        jl, tl = (JR.dist_mse_pyramid(compression_level=LEVEL),
                  TR.dist_mse_pyramid(compression_level=LEVEL))
    else:
        jl, tl = (JR.dist_msssim_pyramid(PATCH, compression_level=LEVEL),
                  TR.dist_msssim_pyramid(PATCH, compression_level=LEVEL))
    want = jl(jnp.asarray(x), [jnp.asarray(a) for a in x_r])["dist"]
    got = tl(_t(x), [_t(a) for a in x_r])["dist"]
    assert len(got) == len(want) == LEVEL
    got, want = [float(g) for g in got], [float(w) for w in want]
    if kind == "msssim":     # the MS-SSIM values, as above
        got, want = [1.0 - g for g in got], [1.0 - w for w in want]
    _close(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_penalty_a_matches_jax(dtype):
    x, _, y, _ = _batch(b=3)
    jy = jnp.asarray(y).astype(dtype)
    ty = _t(y).to(getattr(torch, dtype))
    want = JR.penalty_a(jnp.asarray(x), jy)
    got = TR.penalty_a(_t(x), ty)
    for key in ("weighted_penalty", "penalty", "energy", "channel_e"):
        assert str(got[key].dtype).split(".")[-1] == \
            str(want[key].dtype), key
        _close(float(got[key]), float(want[key]), msg=key)


def test_penalty_a_median_of_an_even_batch():
    """Batch 4 whose largest shares sit in channels 1, 2, 5 and 7: the
    medians are the two middle values' means (channel_e 3.5), as
    ``jnp.median`` gives them; ``torch.median`` would give 2 and the
    lower share."""
    rng = np.random.RandomState(1)
    x = rng.rand(4, 16, 16, 3).astype(np.float32)
    scales = np.full((4, BN), 0.5, np.float32)
    for b, (c, s) in enumerate([(1, 3.0), (2, 4.0), (5, 5.0), (7, 6.0)]):
        scales[b, c] = s
    y = (rng.randn(4, 4, 4, BN) * scales[:, None, None, :]).astype(
        np.float32)
    want = JR.penalty_a(jnp.asarray(x), jnp.asarray(y))
    got = TR.penalty_a(_t(x), _t(y))
    assert float(want["channel_e"]) == 3.5
    assert float(got["channel_e"]) == float(want["channel_e"])
    _close(float(got["energy"]), float(want["energy"]))
    shares = y.var(axis=(1, 2))
    shares = np.sort(shares.max(1) / shares.sum(1))
    assert list(y.var(axis=(1, 2)).argmax(1)) == [1, 2, 5, 7]
    _close(float(got["energy"]), (shares[1] + shares[2]) / 2)


@pytest.mark.parametrize("channel_e", [0, 5])
def test_penalty_b_matches_jax(models, channel_e):
    j, t = models
    _, _, y, _ = _batch()
    params = j.variables["decoder"]
    want = JR.penalty_b(jnp.asarray(y), lambda c: j.modules["decoder"].apply(
        params, c)[0], channel_e=channel_e)
    got = TR.penalty_b(_t(y), lambda c: t.decoder(c)[0], channel_e=channel_e)
    for key in ("weighted_penalty", "penalty", "energy"):
        _close(float(got[key].detach()), float(want[key]), msg=key)
    assert int(got["channel_e"]) == int(want["channel_e"]) == channel_e
    assert got["weighted_penalty"].requires_grad
    assert not got["penalty"].requires_grad
    assert not got["energy"].requires_grad


CRITERIA = ["MultiscaleRateMSSSIM", "MultiscaleRateMSE", "RateMSSSIM",
            "RateMSEPA", "RateMSEPB"]


def _criteria(name):
    kw = dict(distortion_lambda=[0.01, 0.02, 0.03], patch_size=PATCH,
              compression_level=LEVEL, penalty_beta=0.5, channel_e=2)
    return jax_setup_loss(name, **kw), setup_loss(name, **kw)


def _jax_loss(j, crit, x, x_r, y, p_y, params):
    """The JAX composer's loss dict; ``params`` are the decoder's."""
    fe = j.variables["fact_ent"]["params"]
    net = {"fact_ent_params": fe, "num_filters": 4,
           "decoder_fn": lambda c: j.modules["decoder"].apply(
               {"params": params}, c)[0]}
    return crit(x, {"x_r": x_r, "y": y, "p_y": p_y}, net=net)


def _port_loss(t, crit, x, x_r, y, p_y):
    net = {"fact_ent_params": t.fact_ent.params(), "num_filters": 4,
           "decoder_fn": lambda c: t.decoder(c)[0]}
    return crit(x, {"x_r": x_r, "y": y, "p_y": p_y}, net=net)


@pytest.mark.parametrize("name", CRITERIA)
def test_setup_loss_matches_jax(models, name):
    """Every component of the composed loss dict, the 255^2 multiplier for
    MSE names, the lambdas zipped against the scales, penalty last."""
    j, t = models
    jc, tc = _criteria(name)
    x, x_r, y, p_y = _batch()
    want = _jax_loss(j, jc, jnp.asarray(x), [jnp.asarray(a) for a in x_r],
                     jnp.asarray(y), jnp.asarray(p_y),
                     j.variables["decoder"]["params"])
    got = _port_loss(t, tc, _t(x), [_t(a) for a in x_r], _t(y), _t(p_y))
    assert set(got) == set(want)
    for key, w in want.items():
        if key == "dist":
            assert len(got[key]) == len(w)
            _close([float(d) for d in got[key]], [float(d) for d in w],
                   msg=key)
        else:
            _close(float(got[key].detach()), float(w), msg=key)


def _close_grad(got, want, msssim, msg):
    """Elementwise within 1e-5 of the largest; through MS-SSIM, whose
    float32 gradients lie about 6e-5 from the float64 one in either package
    (``test_torch_msssim.py``), relative L2 error within 2e-4."""
    if msssim:
        assert np.linalg.norm(got - want) <= 2e-4 * np.linalg.norm(want), msg
    else:
        _close(got, want, atol=1e-5 * max(np.abs(want).max(), 1e-30),
               msg=msg)


@pytest.mark.parametrize("name", CRITERIA)
def test_loss_gradients_match_jax(models, name):
    """d(loss)/d(x_r, y) and, for PenaltyB, d(loss)/d(decoder weights)
    against ``jax.grad``'s."""
    j, t = models
    jc, tc = _criteria(name)
    x, x_r, y, p_y = _batch(b=1, seed=4)
    dparams = j.variables["decoder"]["params"]

    def jloss(xr, yy, dp):
        return _jax_loss(j, jc, jnp.asarray(x), xr, yy, jnp.asarray(p_y),
                         dp)["loss"]
    jg_xr, jg_y, jg_dec = jax.grad(jloss, argnums=(0, 1, 2))(
        [jnp.asarray(a) for a in x_r], jnp.asarray(y), dparams)

    t.zero_grad()
    txr = [_t(a).requires_grad_(True) for a in x_r]
    ty = _t(y).requires_grad_(True)
    _port_loss(t, tc, _t(x), txr, ty, _t(p_y))["loss"].backward()
    msssim = "MSSSIM" in name
    for s, (g, w) in enumerate(zip(txr, jg_xr)):
        w = np.asarray(w)
        got = np.zeros_like(w) if g.grad is None else g.grad.numpy()
        _close_grad(got, w, msssim, f"x_r[{s}]")
    w = np.asarray(jg_y)
    _close(np.zeros_like(w) if ty.grad is None else ty.grad.numpy(), w,
           atol=1e-5 * max(np.abs(w).max(), 1e-30), msg="y")
    grads = {f"decoder.{n}": (torch.zeros_like(p) if p.grad is None
                              else p.grad)
             for n, p in t.decoder.named_parameters()}
    got_dec = state_to_jax(grads, t.config)["decoder"]["params"]
    flat_w = jax.tree_util.tree_flatten_with_path(jg_dec)[0]
    for path, w in flat_w:
        node = got_dec
        for p in path:
            node = node[p.key]
        w = np.asarray(w)
        _close(node, w, atol=1e-5 * max(np.abs(w).max(), 1e-30),
               msg=jax.tree_util.keystr(path))
    if name.endswith("PB"):
        assert any(np.abs(np.asarray(w)).max() > 0 for _, w in flat_w)
