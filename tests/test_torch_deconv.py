"""The port's transposed convolution (``ops/convops.py:ConvTranspose2dTorch``)
on the CPU: its polyphase form (3x3, stride 2, padding 1, output padding
1; one product per output phase, or one product against all nine taps
where the outputs are narrow) and its dilated form (any other geometry),
which add in a fixed order, against ``F.conv_transpose2d`` and against the
JAX package's layer with the same weights, values and gradients, float32
and bf16; and the flagship decoder against the JAX decoder under the
``test_rd_parity`` rules.  On the card, ``chip_smoke.py`` holds three
decodes of the same symbols bit-equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from cnn_autoencoder_tpu.models.factory import \
    autoencoder_from_state_dict as jax_from_state_dict
from cnn_autoencoder_tpu.ops.convops import \
    ConvTranspose2dTorch as JaxConvTranspose
from cnn_autoencoder_tpu_torch.models.factory import \
    autoencoder_from_state_dict
from cnn_autoencoder_tpu_torch.ops.convops import ConvTranspose2dTorch
from cnn_autoencoder_tpu_torch.utils.weights import _deconv
from tests.test_torch_autoencoder import FLAGSHIP, _image

# (kernel, stride, padding, output padding): every deconv_up (polyphase),
# every deconv_pre (stride 1), and a 5x5 stride-2 layer (dilated)
GEOMETRIES = {"up": (3, 2, 1, 1), "pre": (3, 1, 1, 0), "k5": (5, 2, 2, 1)}
# (Cin, Cout): 9 Cout <= 4 Cin takes the one-product form, else one product
# per phase
CHANNELS = {"narrow": (16, 3), "wide": (8, 16)}


def _layer(geometry, channels, bias, seed):
    k, s, p, op = GEOMETRIES[geometry]
    cin, cout = CHANNELS[channels]
    layer = ConvTranspose2dTorch(cin, cout, k, s, p, op, bias=bias)
    gen = torch.Generator().manual_seed(seed)
    layer.reset_parameters(gen)
    if bias:
        with torch.no_grad():
            layer.bias.copy_(torch.randn(cout, generator=gen) * 0.1)
    return layer


def _reference(x, layer):
    """F.conv_transpose2d on the layer's operands, NHWC in and out,
    float32 sums (bf16 operands upcast exactly)."""
    k, s, p, op = (layer.weight.shape[-1], layer.stride, layer.padding,
                   layer.output_padding)
    weight = layer.weight.to(x.dtype).float()
    bias = None if layer.bias is None else layer.bias.to(x.dtype).float()
    return F.conv_transpose2d(x.float().permute(0, 3, 1, 2), weight, bias,
                              stride=s, padding=p,
                              output_padding=op).permute(0, 2, 3, 1)


def _bf16_ulp(ref: torch.Tensor) -> torch.Tensor:
    """bf16's spacing at |ref| (8 significant bits)."""
    e = torch.floor(torch.log2(ref.abs().clamp_min(2.0 ** -126)))
    return torch.pow(2.0, e - 7)


@pytest.mark.parametrize("channels", sorted(CHANNELS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hw", [(5, 7), (6, 4)])
@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
def test_deconv_matches_conv_transpose2d(geometry, hw, dtype, channels):
    """float32 to rtol = atol = 1e-5; bf16 within one bf16 ulp of the
    float32-summed result, with and without a bias."""
    for bias in (False, True):
        layer = _layer(geometry, channels, bias, seed=10 * hw[0] + hw[1])
        rng = np.random.RandomState(7 + hw[0])
        x = torch.from_numpy(rng.randn(2, *hw, CHANNELS[channels][0])
                             .astype(np.float32)).to(getattr(torch, dtype))
        with torch.no_grad():
            got = layer(x)
            ref = _reference(x, layer)
        assert got.dtype == x.dtype and got.shape == ref.shape
        if dtype == "float32":
            np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5,
                                       atol=1e-5)
        else:
            err = (got.float() - ref).abs()
            assert bool((err <= _bf16_ulp(ref)).all()), float(err.max())


@pytest.mark.parametrize("hw", [(5, 7), (6, 4)])
@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
def test_deconv_matches_jax_layer(geometry, hw):
    """The JAX package's ConvTranspose2dTorch (float32, its dilated form)
    with the same weights, carried by ``utils/weights.py``: the
    test_rd_parity tolerance, rtol = atol = 1e-4."""
    k, s, p, op = GEOMETRIES[geometry]
    for channels in sorted(CHANNELS):
        cin, cout = CHANNELS[channels]
        rng = np.random.RandomState(hw[0] + cin)
        x = rng.randn(2, *hw, cin).astype(np.float32)
        jlayer = JaxConvTranspose(features=cout, kernel_size=k, stride=s,
                                  padding=p, output_padding=op)
        variables = jlayer.init(jax.random.PRNGKey(cin), jnp.asarray(x))
        params = jax.tree_util.tree_map(np.asarray, variables["params"])
        params["bias"] = (rng.randn(cout) * 0.1).astype(np.float32)
        want = np.asarray(jlayer.apply({"params": params}, jnp.asarray(x)))
        layer = ConvTranspose2dTorch(cin, cout, k, s, p, op)
        layer.load_state_dict({
            "weight": torch.from_numpy(_deconv(params["kernel"]).copy()),
            "bias": torch.from_numpy(params["bias"])})
        with torch.no_grad():
            got = layer(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("channels", sorted(CHANNELS))
@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
def test_deconv_gradients_match(geometry, channels):
    """Training runs the same formulation: the gradients of x, the weight
    and the bias against F.conv_transpose2d's, float32, to 1e-5 of the
    largest."""
    layer = _layer(geometry, channels, True, seed=3)
    rng = np.random.RandomState(11)
    x = torch.from_numpy(rng.randn(2, 5, 6, CHANNELS[channels][0])
                         .astype(np.float32))
    grads = []
    for fn in (layer, lambda t: _reference(t, layer)):
        xr = x.clone().requires_grad_()
        out = fn(xr)
        cot = torch.from_numpy(np.random.RandomState(5).randn(*out.shape)
                               .astype(np.float32))
        grads.append(torch.autograd.grad(
            out, (xr, layer.weight, layer.bias), cot))
    for got, want in zip(*grads):
        scale = float(want.abs().max())
        assert float((got - want).abs().max()) <= 1e-5 * scale


def test_flagship_decoder_matches_jax():
    """The flagship's decoder (polyphase up_0 and up_1, the one-product
    up_2) on a 96^2 tile's quantized latent against the JAX decoder: float
    reconstructions to rtol = atol = 1e-4, u8 pixels differing < 0.5 %, by
    at most 1 (tests/test_rd_parity.py:75-85)."""
    j_model = jax_from_state_dict(FLAGSHIP)
    t_model = autoencoder_from_state_dict(FLAGSHIP, device="cpu")
    medians = np.asarray(
        j_model.variables["fact_ent"]["params"]["quantiles"][:, 0, 1])
    x = _image(96, 96, seed=4)[None].astype(np.float32) / 255.0
    y_j = np.asarray(j_model.encode(jnp.asarray(x)))
    y_q = (np.round(y_j - medians) + medians).astype(np.float32)
    rec_j = np.asarray(j_model.decode(jnp.asarray(y_q))[0][0])
    with torch.no_grad():
        rec_t = t_model.decoder(torch.from_numpy(y_q))[0][0].numpy()
    assert rec_t.shape == rec_j.shape == (1, 96, 96, 3)
    np.testing.assert_allclose(rec_t, rec_j, rtol=1e-4, atol=1e-4)
    u8_j = np.clip(rec_j * 255.0, 0, 255).astype(np.uint8)
    u8_t = np.clip(rec_t * 255.0, 0, 255).astype(np.uint8)
    diff = np.abs(u8_t.astype(int) - u8_j.astype(int))
    assert np.mean(diff != 0) < 5e-3 and diff.max() <= 1
