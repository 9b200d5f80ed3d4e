"""The JAX package's precisions and precision switches in the port, on the
CPU: the bf16 mode's default route (faults 11 and 12: the conv's bf16
output, the bias added after it, the border form's roundings, the fused
stage's pool on bf16 rows), the switches that change the function
(``CAE_TPU_PALLAS``, ``CAE_TPU_NATIVE_CONV_OUT``, ``CAE_TPU_BORDER_CONV``,
``CAE_TPU_POLYPHASE_DECONV``, ``CAE_TPU_BF16_ACTIVATIONS``,
``CAE_TPU_GDN_FAST``, ``CAE_TPU_ANALYTIC_ENT``), the "default" and "high"
precisions, and what raises.  JAX on the CPU computes its DEFAULT and HIGH
precisions (and the bf16 pool's DEFAULT) in float32, so those functions of
the port are held to float64 functions of the bf16-rounded (or split)
operands; the rest to the JAX package on the same inputs.  The kernels
themselves run only on the card (``chip_smoke.py`` phase 15)."""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from cnn_autoencoder_tpu.models import entropy as jax_entropy
from cnn_autoencoder_tpu.models.factory import \
    autoencoder_from_state_dict as jax_from_state_dict
from cnn_autoencoder_tpu.models.factory import \
    setup_modules as jax_setup_modules
from cnn_autoencoder_tpu.ops import convops as jc
from cnn_autoencoder_tpu.storage import cae_codec as jcodec
from cnn_autoencoder_tpu_torch.criteria.loss import setup_loss
from cnn_autoencoder_tpu_torch.models import entropy as t_entropy
from cnn_autoencoder_tpu_torch.models.factory import (
    autoencoder_from_state_dict, build_model)
from cnn_autoencoder_tpu_torch.ops import convops as tc
from cnn_autoencoder_tpu_torch.ops.kernels import conv_gdn_kernel as cg
from cnn_autoencoder_tpu_torch.ops.kernels import gdn_kernel as gk
from cnn_autoencoder_tpu_torch.storage import cae_codec as tcodec
from cnn_autoencoder_tpu_torch.training.loop import make_train_step
from cnn_autoencoder_tpu_torch.training.optim import setup_optimizers
from cnn_autoencoder_tpu_torch.utils.weights import state_from_jax
from tests.test_torch_autoencoder import FLAGSHIP, _image

BF16 = torch.bfloat16
SWITCHES = ("CAE_TPU_PALLAS", "CAE_TPU_PALLAS_INTERPRET",
            "CAE_TPU_NATIVE_CONV_OUT", "CAE_TPU_BORDER_CONV",
            "CAE_TPU_POLYPHASE_CONV", "CAE_TPU_POLYPHASE_DECONV",
            "CAE_TPU_BF16_ACTIVATIONS", "CAE_TPU_GDN_FAST",
            "CAE_TPU_FUSED_CONV", "CAE_TPU_ANALYTIC_ENT",
            "CAE_TPU_GDN_TRAIN_KERNEL")


@pytest.fixture(autouse=True)
def _clean_switches(monkeypatch):
    for name in SWITCHES:
        monkeypatch.delenv(name, raising=False)
    yield
    jc.set_default_precision("highest")
    tc.set_default_precision("highest")


@pytest.fixture(scope="module")
def models():
    return (jax_from_state_dict(FLAGSHIP),
            autoencoder_from_state_dict(FLAGSHIP, device="cpu"))


def _bf16(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(jnp.asarray(a).astype(jnp.float32))
                            .copy()).to(BF16)


def _ulps(a: torch.Tensor, b: torch.Tensor):
    """(most bf16 ulps apart, share of values that differ)."""
    d = (a.contiguous().view(torch.int16).int()
         - b.contiguous().view(torch.int16).int()).abs()
    return int(d.max()), float((d != 0).float().mean())


# -- fault 12: the bf16 latent is JAX's default route's --------------------


def _jax_latent(j_model, tiles, env):
    """The JAX package's bf16 latent of uint8 tiles with ``env`` set while
    its core traces."""
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        jc.set_default_precision("bf16")
        core = jcodec.CAECodecCore(j_model)
        return np.asarray(core._latent(jnp.asarray(tiles)))
    finally:
        jc.set_default_precision("highest")
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _differ(a, b, medians):
    """(share of values that differ, share of rounded values that
    differ)."""
    return (float(np.mean(a != b)),
            float(np.mean(np.round(a - medians) != np.round(b - medians))))


@pytest.mark.parametrize("side,seed", [(64, 3), (256, 5)])
@pytest.mark.parametrize("pallas", [False, True])
def test_bf16_latent_follows_the_jax_route(models, side, seed, pallas,
                                          monkeypatch):
    """The flagship encoder in bf16: with no switch set the port's latent
    is closer to the JAX package's default route than to its Pallas route
    (in its own tests' interpret mode), both in the values that differ and
    in the rounded values that differ; with CAE_TPU_PALLAS=1 the
    reverse."""
    j_model, t_model = models
    tiles = _image(side, side, seed=seed)[None]
    default = _jax_latent(j_model, tiles, {})
    via_pallas = _jax_latent(j_model, tiles,
                             {"CAE_TPU_PALLAS_INTERPRET": "1"})
    if pallas:
        monkeypatch.setenv("CAE_TPU_PALLAS", "1")
    core = tcodec.CAECodecCore(t_model, device="cpu", compute_dtype=BF16)
    port = core.latents(tiles).numpy()
    med = core.medians
    near, far = ((via_pallas, default) if pallas else (default, via_pallas))
    d_near, d_far = _differ(port, near, med), _differ(port, far, med)
    assert d_near[0] < d_far[0] and d_near[1] <= d_far[1], (d_near, d_far)
    assert d_near[1] < d_far[1] or d_far[1] == 0.0, (d_near, d_far)


# -- fault 11: the bf16 convs' rounding points ------------------------------


def _conv_pair(cin, cout, stride, seed):
    rng = np.random.RandomState(seed)
    k = (rng.randn(3, 3, cin, cout) * 0.2).astype(np.float32)
    b = (rng.randn(cout) * 0.3 + 0.2).astype(np.float32)
    layer = tc.Conv2dReflect(cin, cout, 3, stride, True)
    with torch.no_grad():
        layer.weight.copy_(torch.from_numpy(k).permute(3, 2, 0, 1))
        layer.bias.copy_(torch.from_numpy(b))
    return jc.Conv2dReflect(cout, 3, stride, True), k, b, layer


def _deconv_pair(cin, cout, seed):
    rng = np.random.RandomState(seed)
    k = (rng.randn(3, 3, cin, cout) * 0.2).astype(np.float32)
    b = (rng.randn(cout) * 0.3 + 0.2).astype(np.float32)
    layer = tc.ConvTranspose2dTorch(cin, cout)
    with torch.no_grad():  # JAX: flipped HWIO; torch: (in, out, kh, kw)
        layer.weight.copy_(torch.from_numpy(k[::-1, ::-1].copy())
                           .permute(2, 3, 0, 1))
        layer.bias.copy_(torch.from_numpy(b))
    return jc.ConvTranspose2dTorch(cout), k, b, layer


def _apply_bf16(jlayer, k, b, x):
    jc.set_default_precision("bf16")
    try:
        return jlayer.apply({"params": {"kernel": jnp.asarray(k),
                                        "bias": jnp.asarray(b)}},
                            jnp.asarray(x.float().numpy()).astype(
                                jnp.bfloat16))
    finally:
        jc.set_default_precision("highest")


@pytest.mark.parametrize("native", ["1", "0"])
@pytest.mark.parametrize("layer", ["conv_s2", "conv_s1", "deconv"])
def test_biased_bf16_convs_match_jax(layer, native, monkeypatch):
    """A biased bf16 Conv2dReflect (stride 2, the border form, and stride
    1) and a biased bf16 deconv, port against JAX on the same bf16 inputs
    at each CAE_TPU_NATIVE_CONV_OUT setting: at most one bf16 ulp, in under
    0.1 % of the values."""
    monkeypatch.setenv("CAE_TPU_NATIVE_CONV_OUT", native)
    rng = np.random.RandomState(7)
    if layer == "deconv":
        jl, k, b, tl = _deconv_pair(16, 24, 1)
        x = torch.from_numpy(rng.randn(2, 6, 5, 16).astype(np.float32))
    else:
        jl, k, b, tl = _conv_pair(16, 24, 2 if layer == "conv_s2" else 1, 2)
        x = torch.from_numpy(rng.randn(2, 10, 8, 16).astype(np.float32))
    x = x.to(BF16)
    want = _bf16(_apply_bf16(jl, k, b, x))
    with torch.no_grad():
        got = tl(x)
    assert got.dtype == BF16 and got.shape == want.shape
    most, share = _ulps(got, want)
    assert most <= 1 and share < 1e-3, (most, share)


@pytest.mark.parametrize("switch,value", [("CAE_TPU_BORDER_CONV", "0"),
                                          ("CAE_TPU_POLYPHASE_DECONV", "1")])
def test_conv_form_switches_match_jax(switch, value, monkeypatch):
    """CAE_TPU_BORDER_CONV=0 (reflect + VALID, one rounding of the strided
    conv) and CAE_TPU_POLYPHASE_DECONV=1 (the deconv's float32 sums with
    the bias, one rounding), each against JAX with the same switch: at
    most one bf16 ulp in under 0.1 % of the values, and each form differs
    from the default one somewhere."""
    rng = np.random.RandomState(11)
    if switch == "CAE_TPU_BORDER_CONV":
        jl, k, b, tl = _conv_pair(16, 24, 2, 3)
        x = torch.from_numpy(rng.randn(2, 10, 8, 16).astype(np.float32))
    else:
        jl, k, b, tl = _deconv_pair(16, 24, 4)
        x = torch.from_numpy(rng.randn(2, 6, 5, 16).astype(np.float32))
    x = x.to(BF16)
    with torch.no_grad():
        default = tl(x)
    monkeypatch.setenv(switch, value)
    want = _bf16(_apply_bf16(jl, k, b, x))
    with torch.no_grad():
        got = tl(x)
    most, share = _ulps(got, want)
    assert most <= 1 and share < 1e-3, (most, share)
    assert not torch.equal(got, default)


def test_border_form_matches_jax():
    """ops/convops.py:border_form against the JAX package's
    conv_s2_reflect_border with its bf16 native-output conv, bit for bit,
    grouped and not."""
    rng = np.random.RandomState(5)
    for groups in (1, 4):
        x = torch.from_numpy(rng.randn(2, 12, 10, 8).astype(np.float32)
                             ).to(BF16)
        k = (rng.randn(3, 3, 8 // groups, 12) * 0.3).astype(np.float32)
        conv = functools.partial(jc.conv_mixed, native_out=True)
        want = jc.conv_s2_reflect_border(
            jnp.asarray(x.float().numpy()).astype(jnp.bfloat16),
            jnp.asarray(k).astype(jnp.bfloat16), conv,
            feature_group_count=groups)
        w = torch.from_numpy(k).permute(3, 2, 0, 1).to(BF16)
        got = tc.border_form(x.permute(0, 3, 1, 2), w, functools.partial(
            F.conv2d, groups=groups)).permute(0, 2, 3, 1)
        assert torch.equal(got, _bf16(want))


@pytest.mark.parametrize("mode", [cg.ROUND_BF16, cg.BORDER_BF16])
def test_fused_stage_plain_is_the_default_route(mode, monkeypatch):
    """K4's plain version in modes 2 and 3 (one rounding; the border
    form's): y bit-equal to the JAX Conv2dReflect's bf16 output (with
    CAE_TPU_BORDER_CONV=0 for mode 2), out and r within one bf16 ulp of a
    float64 GDN of that y with the pool's operands (y^2, gamma) rounded to
    bf16, as the TPU's DEFAULT rounds them (JAX on the CPU does not)."""
    if mode == cg.ROUND_BF16:
        monkeypatch.setenv("CAE_TPU_BORDER_CONV", "0")
    assert cg.conv_gdn_mode(BF16) == mode
    rng = np.random.RandomState(8)
    x = torch.from_numpy(rng.randn(2, 10, 12, 64).astype(np.float32)
                         ).to(BF16)
    k = (rng.randn(3, 3, 64, 40) * 0.05).astype(np.float32)
    gamma = torch.from_numpy((rng.rand(40, 40) * 0.05).astype(np.float32))
    beta = torch.from_numpy((rng.rand(40) + 0.5).astype(np.float32))
    jl = jc.Conv2dReflect(40, 3, 2, False)
    jc.set_default_precision("bf16")
    try:
        y_j = jl.apply({"params": {"kernel": jnp.asarray(k)}},
                       jnp.asarray(x.float().numpy()).astype(jnp.bfloat16))
    finally:
        jc.set_default_precision("highest")
    out, y, r = cg.conv_gdn_train_plain(x, torch.from_numpy(k), gamma, beta,
                                        mode)
    assert y.dtype == r.dtype == out.dtype == BF16
    assert torch.equal(y, _bf16(y_j))
    y64 = y.double().reshape(-1, 40)
    g64 = gamma.to(BF16).double()
    r64 = torch.rsqrt((y64 * y64).to(BF16).double() @ g64.t()
                      + beta.double())
    assert _ulps(r.reshape(-1, 40), r64.to(BF16))[0] <= 1
    assert _ulps(out.reshape(-1, 40), (y64 * r64).to(BF16))[0] <= 1
    assert torch.equal(cg.conv_gdn_plain(x, torch.from_numpy(k), gamma,
                                         beta, mode), out)


# -- fault 11: the flagship's bf16 decode -----------------------------------


def test_bf16_decode_follows_native_conv_out(models, monkeypatch):
    """The bf16 decode of the symbols of one JAX frame of the flagship, by
    its decoder with a bias on every deconv (the flagship's have none, and
    without a bias the switch does not change the function): at each
    CAE_TPU_NATIVE_CONV_OUT setting the port's u8 reconstruction is closer
    to the JAX package's at the same setting than at the other.  The JAX
    decoder runs op by op, as its layers define it (jitted on the CPU, XLA
    computes the bf16-output convs of the native setting otherwise: 27 % of
    the flagship's first stage differs from the op-by-op values), and the
    port takes CAE_TPU_GDN_FAST=0, the pool JAX computes on the CPU."""
    j_model, _ = models
    tiles = _image(64, 64, seed=9)[None]
    jc.set_default_precision("bf16")
    try:
        core = jcodec.CAECodecCore(j_model)
        sym = np.asarray(core.entropy_decode(core.encode_tiles(tiles))[0])
    finally:
        jc.set_default_precision("highest")
    y = jnp.transpose(jnp.asarray(sym.reshape(1, 48, 8, 8)),
                      (0, 2, 3, 1)).astype(jnp.float32) + core.medians
    config = dict(j_model.config, bias=True)
    params = jax.tree_util.tree_map(
        np.asarray, dict(j_model.variables["decoder"]["params"]))
    rng = np.random.RandomState(12)
    for unit in sorted(params):
        cout = params[unit]["deconv_up"]["kernel"].shape[-1]
        params[unit] = dict(params[unit], deconv_up=dict(
            params[unit]["deconv_up"],
            bias=(rng.randn(cout) * 0.05).astype(np.float32)))
    jdec = jax_setup_modules(**config)["decoder"]
    tdec = build_model(config, device="cpu").decoder
    tdec.load_state_dict({
        k[len("decoder."):]: v for k, v in state_from_jax(
            {"decoder": {"params": params}}, config).items()})

    def u8(x):
        return np.clip(np.asarray(x, np.float32) * 255.0, 0, 255).astype(
            np.uint8)

    jax_rec, port = {}, {}
    monkeypatch.setenv("CAE_TPU_GDN_FAST", "0")
    for native in ("1", "0"):
        monkeypatch.setenv("CAE_TPU_NATIVE_CONV_OUT", native)
        jc.set_default_precision("bf16")
        try:
            with jax.disable_jit():
                x_r = jdec.apply({"params": params},
                                 y.astype(jnp.bfloat16))[0][0]
        finally:
            jc.set_default_precision("highest")
        jax_rec[native] = u8(x_r.astype(jnp.float32))
        with torch.no_grad():
            port[native] = u8(tdec(torch.from_numpy(np.asarray(y)).to(
                BF16))[0][0].float().numpy())
    for native, other in (("1", "0"), ("0", "1")):
        same = np.mean(port[native] != jax_rec[native])
        cross = np.mean(port[native] != jax_rec[other])
        assert same < cross, (native, same, cross)


# -- the float32 activations of the bf16 mode -------------------------------


def _psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return 10.0 * np.log10(255.0 ** 2 / mse)


def test_bf16_activation_flow_off_matches_jax(models, monkeypatch):
    """CAE_TPU_BF16_ACTIVATIONS=0 in the bf16 mode: the flagship round trip
    (tests/test_bf16_rd.py:101-127's) against the JAX package's with the
    same switch: symbols flip < 5e-3, |delta PSNR| <= 0.05 dB; and against
    the port's own bf16 flow, the same budget."""
    j_model, t_model = models
    img = _image(64, 64, seed=13)
    out = {}
    monkeypatch.setenv("CAE_TPU_BF16_ACTIVATIONS", "0")
    jc.set_default_precision("bf16")
    tc.set_default_precision("bf16")
    try:
        j = jcodec.CAECodecCore(j_model)
        frames = j.encode_tiles(img[None])
        out["jax"] = (j.entropy_decode(frames)[0], j.decode_tiles(frames)[0])
        core = tcodec.CAECodecCore(t_model, device="cpu")
        assert core.compute_dtype == torch.float32
        assert core.precision == "bf16"
        frames = core.encode_tiles(img[None])
        out["port"] = (core.entropy_decode(frames)[0],
                       core.decode_tiles(frames)[0])
        monkeypatch.setenv("CAE_TPU_BF16_ACTIVATIONS", "1")
        core = tcodec.CAECodecCore(t_model, device="cpu")
        assert core.compute_dtype == BF16
        frames = core.encode_tiles(img[None])
        out["bf16"] = (core.entropy_decode(frames)[0],
                       core.decode_tiles(frames)[0])
    finally:
        jc.set_default_precision("highest")
        tc.set_default_precision("highest")
    for other in ("jax", "bf16"):
        flips = float(np.mean(np.asarray(out["port"][0])
                              != np.asarray(out[other][0])))
        assert flips < 5e-3, (other, flips)
        dpsnr = _psnr(img, out["port"][1]) - _psnr(img, out[other][1])
        assert abs(dpsnr) <= 0.05, (other, dpsnr)


# -- "default", "high", CAE_TPU_GDN_FAST=0: float64 references --------------


def _f64_conv(x, w, stride, pad):
    """Reflect pad, conv, in float64 (NCHW)."""
    return F.conv2d(F.pad(x.double(), (pad,) * 4, mode="reflect"),
                    w.double(), stride=stride)


def _split(t):
    hi = t.to(BF16).double()
    return hi, (t.double() - hi).to(BF16).double()


@pytest.mark.parametrize("precision", ["default", "high"])
@pytest.mark.parametrize("stride", [1, 2])
def test_low_precision_conv_matches_float64(precision, stride):
    """Conv2dReflect on float32 rows at "default" (bf16-rounded operands)
    and "high" (hi hi + hi lo + lo hi of the bf16 split) against the same
    products in float64: 1e-6 of max |y|; the highest precision's output
    is farther than that from it (the rounding is there)."""
    rng = np.random.RandomState(20 + stride)
    x = torch.from_numpy(rng.randn(2, 8, 10, 12).astype(np.float32))
    layer = tc.Conv2dReflect(12, 16, 3, stride, True)
    with torch.no_grad():
        layer.bias.copy_(torch.from_numpy(rng.randn(16).astype(np.float32)))
        highest = layer(x)
        tc.set_default_precision(precision)
        got = layer(x)
    xc = x.permute(0, 3, 1, 2)
    if precision == "default":
        ref = _f64_conv(xc.to(BF16), layer.weight.to(BF16), stride, 1)
    else:
        (xh, xl), (wh, wl) = _split(xc), _split(layer.weight)
        ref = sum(_f64_conv(a, b, stride, 1)
                  for a, b in ((xh, wh), (xh, wl), (xl, wh)))
    ref = (ref + layer.bias.double()[:, None, None]).permute(0, 2, 3, 1)
    scale = float(ref.abs().max())
    assert float((got.double() - ref).abs().max()) <= 1e-6 * scale
    assert float((highest.double() - ref).abs().max()) > 1e-6 * scale


@pytest.mark.parametrize("precision", ["default", "high"])
def test_low_precision_deconv_matches_float64(precision):
    """ConvTranspose2dTorch (3x3 stride 2, the polyphase form) on float32
    rows at "default" and "high" against F.conv_transpose2d of the same
    products in float64: 1e-6 of max |y|."""
    rng = np.random.RandomState(30)
    x = torch.from_numpy(rng.randn(2, 5, 6, 12).astype(np.float32))
    layer = tc.ConvTranspose2dTorch(12, 16)
    with torch.no_grad():
        tc.set_default_precision(precision)
        got = layer(x)

    def deconv(a, b):
        return F.conv_transpose2d(a.double(), b.double(), stride=2,
                                  padding=1, output_padding=1)

    xc = x.permute(0, 3, 1, 2)
    if precision == "default":
        ref = deconv(xc.to(BF16), layer.weight.to(BF16))
    else:
        (xh, xl), (wh, wl) = _split(xc), _split(layer.weight)
        ref = deconv(xh, wh) + deconv(xh, wl) + deconv(xl, wh)
    ref = (ref + layer.bias.double()[:, None, None]).permute(0, 2, 3, 1)
    scale = float(ref.abs().max())
    assert float((got.double() - ref).abs().max()) <= 1e-6 * scale


@pytest.mark.parametrize("mode", [cg.F32_BF16X1, cg.F32_BF16X3])
def test_fused_stage_low_precision_matches_float64(mode):
    """K4's plain version in modes 4 (one bf16 pass) and 5 (bf16_3x) on
    float32 rows against a float64 reflect conv of the same products and a
    float64 GDN (the pool float32-accurate): 1e-5 of max |out|; the mode is
    the one conv_gdn_mode picks at "default", "high" and for the bf16
    mode's float32 rows."""
    tc.set_default_precision("default" if mode == cg.F32_BF16X1 else "high")
    assert cg.conv_gdn_mode(torch.float32) == mode
    tc.set_default_precision("highest")
    assert cg.conv_gdn_mode(torch.float32, BF16) == cg.F32_BF16X1
    assert cg.conv_gdn_mode(torch.float32) == cg.F32
    rng = np.random.RandomState(40 + mode)
    x = torch.from_numpy(rng.randn(2, 8, 10, 64).astype(np.float32))
    k = torch.from_numpy((rng.randn(3, 3, 64, 40) * 0.05).astype(np.float32))
    gamma = torch.from_numpy((rng.rand(40, 40) * 0.05).astype(np.float32))
    beta = torch.from_numpy((rng.rand(40) + 0.5).astype(np.float32))
    out = cg.conv_gdn_plain(x, k, gamma, beta, mode)
    xc, w = x.permute(0, 3, 1, 2), k.permute(3, 2, 0, 1)
    if mode == cg.F32_BF16X1:
        y = _f64_conv(xc.to(BF16), w.to(BF16), 2, 1)
    else:
        (xh, xl), (wh, wl) = _split(xc), _split(w)
        y = sum(_f64_conv(a, b, 2, 1)
                for a, b in ((xh, wh), (xh, wl), (xl, wh)))
    y = y.permute(0, 2, 3, 1).reshape(-1, 40)
    ref = y * torch.rsqrt((y * y) @ gamma.double().t() + beta.double())
    assert float((out.reshape(-1, 40).double() - ref).abs().max()) <= \
        1e-5 * float(ref.abs().max())


@pytest.mark.parametrize("inverse", [False, True])
def test_gdn_fast_off_train_forward_matches_float64(inverse, monkeypatch):
    """CAE_TPU_GDN_FAST=0: K2's plain version on bf16 rows, y and r within
    one bf16 ulp of a float64 GDN of the same rows with the full pool; the
    default pool (bf16 operands) is held to the same rows' bf16-operand
    function."""
    rng = np.random.RandomState(50 + inverse)
    x = torch.from_numpy((rng.randn(300, 48) * 1.5).astype(np.float32)
                         ).to(BF16)
    gamma = torch.from_numpy((0.1 * np.eye(48) + 0.01 * rng.rand(48, 48))
                             .astype(np.float32))
    beta = torch.from_numpy((1.0 + rng.rand(48)).astype(np.float32))
    x64 = x.double()
    for fast, x2, g in (("0", x64 * x64, gamma.double()),
                        ("1", (x64 * x64).to(BF16).double(),
                         gamma.to(BF16).double())):
        monkeypatch.setenv("CAE_TPU_GDN_FAST", fast)
        norm = x2 @ g.t() + beta.double()
        r = torch.sqrt(norm) if inverse else torch.rsqrt(norm)
        y, rb = gk.gdn_train_fwd_plain(x, gamma, beta, inverse)
        assert _ulps(y, (x64 * r).to(BF16))[0] <= 1
        assert _ulps(rb, r.to(BF16))[0] <= 1


def test_gdn_fast_off_runs_the_stage_unfused(models, monkeypatch):
    """Under CAE_TPU_GDN_FAST=0 the bf16 mode's down stage runs unfused
    (no fused mode computes its float32 pool on bf16 y): conv_gdn_mode
    gives None, and the encoder's latent equals Conv2dReflect then the GDN
    with the float32 pool."""
    _, t_model = models
    monkeypatch.setenv("CAE_TPU_GDN_FAST", "0")
    assert cg.conv_gdn_mode(BF16) is None
    x = torch.from_numpy(_image(32, 32, seed=2)[None].astype(np.float32)
                         / 255.0).to(BF16)
    unit = t_model.encoder.down_1
    with torch.no_grad():
        h = t_model.encoder.down_0(x)
        got = unit(h)
        want = unit.gdn_down(unit.conv_down(h))
    assert torch.equal(got, want)


# -- what raises, and what no longer does -----------------------------------


def test_switches_that_raise(models, monkeypatch):
    """bf16 training under CAE_TPU_PALLAS=1 raises ValueError (the JAX
    package's raises a TypeError there); what raised until training at the
    low precisions was ported computes finite values now: the bf16 encoder
    under CAE_TPU_POLYPHASE_CONV=1, a low-precision layer's gradient, and a
    train step at "default" and at "high"."""
    _, t_model = models
    x = torch.rand(1, 8, 8, 3)
    monkeypatch.setenv("CAE_TPU_POLYPHASE_CONV", "1")
    with torch.no_grad():
        for rows in (x, x.to(BF16)):
            assert bool(torch.isfinite(t_model.encoder(rows).float()).all())
    monkeypatch.delenv("CAE_TPU_POLYPHASE_CONV")
    monkeypatch.setenv("CAE_TPU_PALLAS", "1")
    xb = torch.zeros(1, 8, 8, 128, dtype=BF16)
    unit = t_model.encoder.down_1
    gamma, beta = unit.gdn_down.effective_params()
    with pytest.raises(ValueError, match="TypeError"):
        cg.fused_conv_gdn(xb.requires_grad_(), unit.conv_down.kernel_hwio(),
                          gamma, beta)
    monkeypatch.delenv("CAE_TPU_PALLAS")
    config = dict(channels_org=3, channels_net=8, channels_bn=8,
                  compression_level=2, K=4, r=3, act_layer_type="GDN")
    criterion = setup_loss("RateMSE", distortion_lambda=0.01)
    batch = torch.rand(2, 16, 16, 3)
    for name in ("default", "high"):
        tc.set_default_precision(name)
        layer = tc.Conv2dReflect(3, 4, 3, 1)
        xg = torch.rand(1, 4, 4, 3, requires_grad=True)
        (dx,) = torch.autograd.grad(layer(xg).sum(), xg)
        assert bool(torch.isfinite(dx).all()) and float(dx.abs().max()) > 0
        model = build_model(config, torch.Generator().manual_seed(0),
                            device="cpu")
        step = make_train_step(model, criterion,
                               setup_optimizers(model, ["encoder"]),
                               trainable_modules=["encoder"])
        stats, grads = step(batch, {"encoder": 1e-4}, 1,
                            generator=torch.Generator().manual_seed(0))
        assert np.isfinite(float(stats["loss"])), name
        assert all(bool(torch.isfinite(g).all())
                   for g in grads["encoder"].values()), name
    tc.set_default_precision("highest")


def test_pallas_gdn_training_takes_the_recomputed_backward(monkeypatch):
    """bf16 GDN training under CAE_TPU_PALLAS=1 takes fused_gdn (the JAX
    layer's Pallas entry comes before its compute mode), gdn_mixed
    without it."""
    from cnn_autoencoder_tpu_torch.ops import gdn as gdn_mod
    calls = []
    for name in ("fused_gdn", "gdn_mixed"):
        real = getattr(gdn_mod, name)
        monkeypatch.setattr(gdn_mod, name, lambda *a, _n=name, _f=real:
                            calls.append(_n) or _f(*a))
    layer = gdn_mod.GDN(8)
    x = torch.rand(2, 3, 3, 8).to(BF16).requires_grad_()
    layer(x)
    monkeypatch.setenv("CAE_TPU_PALLAS", "1")
    layer(x)
    assert calls == ["gdn_mixed", "fused_gdn"]


@pytest.mark.parametrize("inverse", [False, True])
def test_gdn_mixed_dbeta_is_the_default_routes(inverse, monkeypatch):
    """gdn_mixed's beta gradient against jax.grad of the JAX package's
    gdn_mixed on its default route (training kernels off: dbeta summed
    from the float32 dnorm), to 1e-5 of its max; the bf16 dnb's sum, the
    JAX kernels' opt-in form, is farther than that (fault 13).  The port
    takes CAE_TPU_GDN_FAST=0, the float32 pool that JAX's DEFAULT computes
    on the CPU, so both save the same r."""
    monkeypatch.setenv("CAE_TPU_GDN_FAST", "0")
    from cnn_autoencoder_tpu.ops.gdn import gdn_mixed as jax_gdn_mixed
    from cnn_autoencoder_tpu_torch.ops.gdn import gdn_mixed
    rng = np.random.RandomState(60 + inverse)
    c = 48
    x = torch.from_numpy((rng.randn(300, c) * 2).astype(np.float32)).to(BF16)
    gamma = (0.1 * np.eye(c) + 0.01 * rng.rand(c, c)).astype(np.float32)
    beta = (1.0 + rng.rand(c)).astype(np.float32)
    cot = rng.randn(300, c).astype(np.float32)
    want = np.asarray(jax.grad(lambda b: jnp.vdot(jax_gdn_mixed(
        jnp.asarray(x.float().numpy()).astype(jnp.bfloat16),
        jnp.asarray(gamma), b, inverse).astype(jnp.float32), cot))(
            jnp.asarray(beta)))
    beta_t = torch.from_numpy(beta).requires_grad_()
    y = gdn_mixed(x, torch.from_numpy(gamma), beta_t, inverse)
    g = torch.from_numpy(cot).to(BF16)
    (y.float() * g.float()).sum().backward()
    scale = np.abs(want).max()
    assert np.abs(beta_t.grad.numpy() - want).max() <= 1e-5 * scale
    _, rb = gk.gdn_train_fwd_plain(x, torch.from_numpy(gamma),
                                   torch.from_numpy(beta), inverse)
    _, dnb = gk.gdn_train_bwd_plain(g, x, rb, torch.from_numpy(gamma),
                                    inverse)
    assert np.abs(dnb.float().sum(0).numpy() - want).max() > 1e-5 * scale


@pytest.mark.parametrize("inverse", [False, True])
def test_gdn_train_kernel_dbeta_sums_dnb(inverse, monkeypatch):
    """Under CAE_TPU_GDN_TRAIN_KERNEL=1 gdn_mixed's beta gradient is the
    sum of the bf16 dnb, as jax.grad of the JAX package's gdn_mixed takes
    it with its training kernels on (run in its interpreter), to 1e-5 of
    its max; the default route's sum of the float32 dnorm is farther than
    that.  CAE_TPU_GDN_FAST=0 as in the test above."""
    monkeypatch.setenv("CAE_TPU_GDN_FAST", "0")
    monkeypatch.setenv("CAE_TPU_GDN_TRAIN_KERNEL", "1")
    from cnn_autoencoder_tpu.ops.gdn import gdn_mixed as jax_gdn_mixed
    from cnn_autoencoder_tpu_torch.ops.gdn import gdn_mixed
    rng = np.random.RandomState(70 + inverse)
    c = 48
    x = torch.from_numpy((rng.randn(300, c) * 2).astype(np.float32)).to(BF16)
    gamma = (0.1 * np.eye(c) + 0.01 * rng.rand(c, c)).astype(np.float32)
    beta = (1.0 + rng.rand(c)).astype(np.float32)
    cot = rng.randn(300, c).astype(np.float32)
    monkeypatch.setenv("CAE_TPU_PALLAS_INTERPRET", "1")
    want = np.asarray(jax.grad(lambda b: jnp.vdot(jax_gdn_mixed(
        jnp.asarray(x.float().numpy()).astype(jnp.bfloat16),
        jnp.asarray(gamma), b, inverse).astype(jnp.float32), cot))(
            jnp.asarray(beta)))
    monkeypatch.delenv("CAE_TPU_PALLAS_INTERPRET")
    g = torch.from_numpy(cot).to(BF16)
    scale = np.abs(want).max()
    grads = []
    for flag in ("1", "0"):
        monkeypatch.setenv("CAE_TPU_GDN_TRAIN_KERNEL", flag)
        beta_t = torch.from_numpy(beta).requires_grad_()
        y = gdn_mixed(x, torch.from_numpy(gamma), beta_t, inverse)
        (y.float() * g.float()).sum().backward()
        grads.append(beta_t.grad.numpy())
    assert np.abs(grads[0] - want).max() <= 1e-5 * scale
    assert np.abs(grads[1] - want).max() > 1e-5 * scale


@pytest.mark.parametrize("pallas,interpret,train", [
    ("", "1", "0"), ("0", "1", "1"), ("1", "0", "1"), ("", "1", "2"),
    ("", "0", "0")])
def test_pallas_switches_follow_jax(pallas, interpret, train, monkeypatch):
    """The port reads CAE_TPU_PALLAS, CAE_TPU_PALLAS_INTERPRET and
    CAE_TPU_GDN_TRAIN_KERNEL as the JAX package's pallas_enabled and
    gdn_train_kernels_enabled do on the TPU; under the interpreter, where
    the JAX package's answer does not depend on its backend, the two
    agree."""
    from cnn_autoencoder_tpu.ops.pallas import gdn_kernel as jgk
    from cnn_autoencoder_tpu_torch.ops import switches
    for name, value in (("CAE_TPU_PALLAS", pallas),
                        ("CAE_TPU_PALLAS_INTERPRET", interpret),
                        ("CAE_TPU_GDN_TRAIN_KERNEL", train)):
        if value:
            monkeypatch.setenv(name, value)
    assert switches.pallas() == (pallas != "0"
                                 and "1" in (pallas, interpret))
    assert switches.gdn_train_kernel() == (train != "0" and "1" in (
        train, interpret))
    if interpret == "1":
        assert switches.pallas() == jgk.pallas_enabled()
        assert switches.gdn_train_kernel() == jgk.gdn_train_kernels_enabled()


def test_pallas_interpret_takes_the_pallas_route(models, monkeypatch):
    """CAE_TPU_PALLAS_INTERPRET=1 gives the port's bf16 latent of the
    CAE_TPU_PALLAS=1 route, bit for bit, and CAE_TPU_PALLAS=0 beside it
    the default route's."""
    _, t_model = models
    tiles = _image(64, 64, seed=3)[None]

    def latent(env):
        for name in ("CAE_TPU_PALLAS", "CAE_TPU_PALLAS_INTERPRET"):
            monkeypatch.delenv(name, raising=False)
        for name, value in env.items():
            monkeypatch.setenv(name, value)
        core = tcodec.CAECodecCore(t_model, device="cpu",
                                   compute_dtype=BF16)
        return core.latents(tiles)

    default = latent({})
    via_pallas = latent({"CAE_TPU_PALLAS": "1"})
    assert not torch.equal(default, via_pallas)
    assert torch.equal(latent({"CAE_TPU_PALLAS_INTERPRET": "1"}), via_pallas)
    assert torch.equal(latent({"CAE_TPU_PALLAS_INTERPRET": "1",
                               "CAE_TPU_PALLAS": "0"}), default)


# -- CAE_TPU_ANALYTIC_ENT -----------------------------------------------------


def _ent_params(seed, c=5, k=4):
    rng = np.random.RandomState(seed)
    params = {}
    for i in range(k + 1):
        fi, fo = (1 if i == 0 else 3), (1 if i == k else 3)
        params[f"matrix_{i}"] = (rng.randn(c, fo, fi) * 0.4).astype(
            np.float32)
        params[f"bias_{i}"] = (rng.randn(c, fo, 1) * 0.3).astype(np.float32)
        if i < k:
            params[f"factor_{i}"] = (rng.randn(c, fo, 1) * 0.3).astype(
                np.float32)
    return params, rng.randn(4, 3, 3, c).astype(np.float32) * 2


@pytest.mark.parametrize("mode", ["1", "2", "bf16"])
def test_analytic_entropy_backward_matches_jax(mode, monkeypatch):
    """The rate's gradients (every chain parameter and the latent) with
    CAE_TPU_ANALYTIC_ENT at ``mode`` against the JAX package's with the
    same mode, and against the port's autodiff ("0"), at the tolerances of
    tests/test_entropy.py: rtol 1e-3, atol 5e-4 (mode "2" against both,
    "bf16" against JAX's, whose bf16 stacks are the port's), else 3e-2 of
    each gradient's max (tests/test_entropy.py:275's bf16 tolerance: the
    bf16 stacks against autodiff, and mode "1", which multiplies
    bf16-rounded operands as the TPU's DEFAULT does and JAX on the CPU does
    not)."""
    params, v = _ent_params(3)
    k = 4
    monkeypatch.setenv("CAE_TPU_ANALYTIC_ENT", mode)

    def rate_j(p, v):
        return -jnp.log2(jax_entropy.likelihood_fn(p, v, k)).mean()

    g_p, g_v = jax.grad(rate_j, argnums=(0, 1))(
        {n: jnp.asarray(a) for n, a in params.items()}, jnp.asarray(v))
    grads = {}
    for m in (mode, "0"):
        monkeypatch.setenv("CAE_TPU_ANALYTIC_ENT", m)
        tp = {n: torch.from_numpy(a).requires_grad_()
              for n, a in params.items()}
        tv = torch.from_numpy(v).requires_grad_()
        (-torch.log2(t_entropy.likelihood_fn(tp, tv, k)).mean()).backward()
        grads[m] = {n: t.grad.numpy() for n, t in tp.items()}
        grads[m]["v"] = tv.grad.numpy()
    ref = {n: np.asarray(g) for n, g in g_p.items()}
    ref["v"] = np.asarray(g_v)
    for name, want in ref.items():
        got = grads[mode][name]
        for against, exact in ((want, mode != "1"),
                               (grads["0"][name], mode == "2")):
            if exact:
                np.testing.assert_allclose(got, against, rtol=1e-3,
                                           atol=5e-4, err_msg=name)
            else:
                assert np.abs(got - against).max() <= \
                    3e-2 * max(1e-3, np.abs(against).max()), name


def test_analytic_entropy_train_step(models, monkeypatch):
    """A flagship bf16 train step's loss and gradients under each
    CAE_TPU_ANALYTIC_ENT mode against autodiff's: the same loss, and the
    bottleneck's gradients within 3e-2 of each one's max."""
    _, t_model = models
    x = torch.from_numpy(_image(32, 32, seed=4)[None].astype(np.float32)
                         / 255.0)
    noise = torch.from_numpy(np.random.RandomState(1).uniform(
        -0.5, 0.5, (1, 4, 4, 48)).astype(np.float32))
    runs = {}
    for mode in ("0", "1", "2", "bf16"):
        monkeypatch.setenv("CAE_TPU_ANALYTIC_ENT", mode)
        model = autoencoder_from_state_dict(FLAGSHIP, device="cpu")
        optimizers = setup_optimizers(model, ["fact_ent"])
        step = make_train_step(model, setup_loss("RateMSE",
                                                 distortion_lambda=0.01),
                               optimizers, trainable_modules=["fact_ent"],
                               compute_dtype=BF16)
        stats, grads = step(x, {k: 1e-4 for k in optimizers}, 1,
                            noise=noise)
        runs[mode] = (float(stats["loss"]), grads["fact_ent"])
    loss0, g0 = runs.pop("0")
    for mode, (loss, g) in runs.items():
        assert loss == loss0, mode
        for name, want in g0.items():
            err = float((g[name] - want).abs().max())
            assert err <= 3e-2 * max(1e-6, float(want.abs().max())), \
                (mode, name, err)
