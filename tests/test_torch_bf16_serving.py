"""bf16 serving in the port, on the CPU: K1's plain version on bf16 rows
(the pool at ``norm_pool_precision``) against the Pallas kernel in
interpret mode, the GDN layer's routing, the serving precision switch, and
the bf16 'cae', 'cae_tpu' and 'cae_bn' paths on the flagship fixture
against the JAX package's bf16 serving and against the port's float32,
held to ``tests/test_bf16_rd.py``'s budgets (symbol flips < 5e-3, |delta
PSNR| <= 0.05 dB, |delta bpp| < 1 %).  K1 on bf16 rows itself runs only on
the card (``chip_smoke.py``)."""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cnn_autoencoder_tpu.models.factory import \
    autoencoder_from_state_dict as jax_from_state_dict
from cnn_autoencoder_tpu.ops import convops as jax_convops
from cnn_autoencoder_tpu.ops.pallas.gdn_kernel import _gdn_pallas
from cnn_autoencoder_tpu.storage import cae_codec as jcodec
from cnn_autoencoder_tpu.storage.turbo_codec import \
    CAETurboCore as JaxTurboCore
from cnn_autoencoder_tpu_torch.models.factory import \
    autoencoder_from_state_dict
from cnn_autoencoder_tpu_torch.ops import convops, gdn as gdn_mod
from cnn_autoencoder_tpu_torch.ops.gdn import GDN
from cnn_autoencoder_tpu_torch.ops.kernels.gdn_kernel import gdn_plain
from cnn_autoencoder_tpu_torch.storage import cae_codec as tcodec
from cnn_autoencoder_tpu_torch.storage.turbo_codec import (
    CAETurboCore, ConvolutionalAutoencoderTurbo)
from cnn_autoencoder_tpu_torch.utils.device import full_f32
from tests.test_torch_autoencoder import FLAGSHIP, _image
from tests.test_torch_gdn_fwd_tc import _ulps
from tests.test_torch_turbo import _assert_u8_close

BF16 = torch.bfloat16
STREAMS = 64
SIDE = 96
# tests/test_bf16_rd.py:72-76
MAX_FLIPS, MAX_DPSNR, MAX_DBPP = 5e-3, 0.05, 0.01


def _params(c, rng):
    gamma = (0.1 * np.eye(c) + 0.01 * rng.rand(c, c)).astype(np.float32)
    beta = (1.0 + rng.rand(c)).astype(np.float32)
    return gamma, beta


@pytest.mark.parametrize("c", [3, 48, 128, 130])
@pytest.mark.parametrize("inverse", [False, True])
def test_gdn_plain_bf16_matches_pallas(c, inverse):
    """gdn_plain on bf16 rows against _gdn_pallas(interpret=True) on the
    same rows, within one bf16 ulp: the TPU's DEFAULT precision rounds the
    pool's multiplicands to bf16, as gdn_plain does, and the interpreter on
    the CPU does not (a relative change of the norm below 2^-8)."""
    rng = np.random.RandomState(300 + c + inverse)
    x = torch.from_numpy((rng.randn(77, c) * 1.5).astype(np.float32))
    x = x.to(BF16)
    gamma, beta = _params(c, rng)
    y_j = _gdn_pallas(jnp.asarray(x.float().numpy()).astype(jnp.bfloat16),
                      jnp.asarray(gamma), jnp.asarray(beta), inverse, True)
    y_t = gdn_plain(x, torch.from_numpy(gamma), torch.from_numpy(beta),
                    inverse)
    assert y_t.dtype == BF16 and y_t.shape == (77, c)
    assert _ulps(y_t, torch.from_numpy(np.asarray(y_j, np.float32))
                 .to(BF16)) <= 1


@pytest.mark.parametrize("inverse", [False, True])
def test_gdn_plain_float32_unchanged(inverse):
    """Float32 rows keep the full-float32 pool, bit for bit."""
    rng = np.random.RandomState(40 + inverse)
    x = torch.from_numpy((rng.randn(300, 48) * 1.5).astype(np.float32))
    gamma, beta = (torch.from_numpy(a) for a in _params(48, rng))
    with full_f32():
        norm = torch.matmul(x * x, gamma.t()) + beta
    want = x * (torch.sqrt(norm) if inverse else torch.rsqrt(norm))
    assert torch.equal(gdn_plain(x, gamma, beta, inverse), want)


@pytest.mark.parametrize("inverse", [False, True])
def test_gdn_routes_bf16_by_gradient(inverse, monkeypatch):
    """bf16 rows without a gradient (serving) take fused_gdn, K1's entry;
    with a gradient (training) gdn_mixed, K2 and K3's; both give the same
    y within one bf16 ulp.  Float32 rows take fused_gdn either way."""
    calls = []
    for name in ("fused_gdn", "gdn_mixed"):
        real = getattr(gdn_mod, name)
        monkeypatch.setattr(gdn_mod, name, lambda *a, _n=name, _f=real:
                            calls.append(_n) or _f(*a))
    layer = GDN(16, inverse=inverse)
    with torch.no_grad():
        layer.gamma.add_(0.05)
    x = torch.from_numpy(np.random.RandomState(2).randn(2, 5, 6, 16)
                         .astype(np.float32)).to(BF16)
    with torch.no_grad():
        served = layer(x)
    trained = layer(x.clone().requires_grad_())
    assert calls == ["fused_gdn", "gdn_mixed"]
    assert served.dtype == trained.dtype == BF16
    assert _ulps(served, trained.detach()) <= 1
    frozen = layer(x)  # a gradient for the parameters alone
    assert calls[-1] == "gdn_mixed" and _ulps(served, frozen.detach()) <= 1
    with torch.no_grad():
        layer(x.float())
    layer(x.float().requires_grad_())
    assert calls[-2:] == ["fused_gdn", "fused_gdn"]


def test_precision_switch():
    """The serving precision: "highest", "default", "high" and "bf16" as
    the JAX package names them ("default" and "high" serve float32
    activations); codec objects take the precision set when they are built
    and their config does not change."""
    assert convops.get_default_precision() == "highest"
    assert convops.get_activations_dtype() == torch.float32
    with pytest.raises(ValueError, match="unknown precision"):
        convops.set_default_precision("fp8")
    f32 = ConvolutionalAutoencoderTurbo(FLAGSHIP, num_streams=STREAMS,
                                        device="cpu")
    low = {}
    try:
        for name in ("high", "default"):
            convops.set_default_precision(name)
            assert convops.get_default_precision() == name
            assert convops.get_activations_dtype() == torch.float32
            low[name] = tcodec.ConvolutionalAutoencoder(FLAGSHIP,
                                                        device="cpu")
        convops.set_default_precision("BF16")
        assert convops.get_default_precision() == "bf16"
        assert convops.get_activations_dtype() == BF16
        bf16 = ConvolutionalAutoencoderTurbo(FLAGSHIP, num_streams=STREAMS,
                                             device="cpu")
        host = tcodec.ConvolutionalAutoencoder(FLAGSHIP, device="cpu")
    finally:
        convops.set_default_precision("highest")
    assert f32.core.base.compute_dtype == torch.float32
    assert f32.core.base.precision == "highest"
    assert bf16.core.base.compute_dtype == BF16
    assert host.core.compute_dtype == BF16 and host.core.precision == "bf16"
    for name, codec in low.items():
        assert codec.core.compute_dtype == torch.float32
        assert codec.core.precision == name
    assert bf16.get_config() == f32.get_config()
    assert host.get_config() == {"id": "cae", "checkpoint": FLAGSHIP,
                                 "offset": 0}


@pytest.mark.parametrize("value,out", [("bf16", "bf16 torch.bfloat16"),
                                       ("highest", "highest torch.float32"),
                                       ("high", "high torch.float32"),
                                       ("fp8", "unknown precision")])
def test_precision_from_environment(value, out):
    """CAE_TPU_PRECISION sets the start value when the port is imported;
    an unknown name raises there."""
    code = ("from cnn_autoencoder_tpu_torch.ops import convops as c\n"
            "print(c.get_default_precision(), c.get_activations_dtype())")
    env = dict(os.environ, CAE_TPU_PRECISION=value)
    run = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120,
                         cwd=os.path.dirname(os.path.dirname(
                             os.path.abspath(__file__))))
    assert out in run.stdout + run.stderr
    assert (run.returncode == 0) == (value != "fp8")


@pytest.mark.parametrize("value", [None, "1", "0"])
@pytest.mark.parametrize("switch", ["CAE_TPU_BF16_ACTIVATIONS",
                                    "CAE_TPU_GDN_FAST"])
def test_bf16_switches_raise_where_they_change_the_function(
        switch, value, monkeypatch):
    """The JAX package reads CAE_TPU_BF16_ACTIVATIONS (serving's
    activations) and CAE_TPU_GDN_FAST (the pool on bf16 rows) at call time;
    set to "0" in the bf16 mode they ask for another function, which the
    port computes: float32 activations, and the float32 pool on bf16 rows
    (gdn_plain within one bf16 ulp of a float64 GDN of the same bf16 rows,
    against two ulps with the bf16 pool's rounded operands kept out).
    Unset, "1", or in the highest mode (float32 rows) the defaults hold."""
    if value is None:
        monkeypatch.delenv(switch, raising=False)
    else:
        monkeypatch.setenv(switch, value)
    rng = np.random.RandomState(4)
    x = torch.from_numpy(rng.rand(64, 8).astype(np.float32) * 3)
    gamma = torch.from_numpy(0.1 + rng.rand(8, 8).astype(np.float32) / 7)
    beta = torch.ones(8)
    # the highest mode: float32 activations and rows
    assert convops.get_activations_dtype() == torch.float32
    assert gdn_mod.norm_pool_precision(torch.float32) == torch.float32
    assert torch.isfinite(gdn_plain(x, gamma, beta)).all()
    try:
        convops.set_default_precision("bf16")
        if switch == "CAE_TPU_BF16_ACTIVATIONS":
            want = torch.float32 if value == "0" else BF16
            assert convops.get_activations_dtype() == want
        else:
            pool = torch.float32 if value == "0" else BF16
            assert gdn_mod.norm_pool_precision(BF16) == pool
            xb = x.to(BF16)
            x64 = xb.double()
            norm = (x64 * x64) @ gamma.double().t() + 1.0
            ref = (x64 * torch.rsqrt(norm)).to(BF16)
            got = gdn_plain(xb, gamma, beta)
            assert got.dtype == BF16
            assert _ulps(got, ref) <= (1 if value == "0" else 2)
        # float32 rows in the bf16 mode (after a batch norm) keep theirs
        assert gdn_mod.norm_pool_precision(torch.float32) == torch.float32
    finally:
        convops.set_default_precision("highest")


def _psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return 10.0 * np.log10(255.0 ** 2 / mse)


def _metrics(img, sym, rec, nbytes):
    return dict(sym=np.asarray(sym), psnr=_psnr(img, rec),
                bpp=8.0 * nbytes / (img.shape[0] * img.shape[1]))


@pytest.fixture(scope="module")
def served():
    """The flagship on one 96^2 tile through every CAE path: the JAX
    package's at "bf16", the port's at bf16 and at float32.  Returns
    (image, {side: {path: metrics}}, port objects, JAX objects)."""
    img = _image(SIDE, SIDE, seed=6)
    tiles = img[None]
    j_model = jax_from_state_dict(FLAGSHIP)
    t_model = autoencoder_from_state_dict(FLAGSHIP, device="cpu")
    out, port = {}, {}
    reader = CAETurboCore(t_model, STREAMS, device="cpu",
                          compute_dtype=torch.float32)

    def turbo_symbols(frames):
        return reader.symbols_from_frames(frames, STREAMS, SIDE, SIDE).numpy()

    def paths(host, turbo, bn, latent):
        frames = host.encode_tiles(tiles)
        res = {"cae": _metrics(img, host.entropy_decode(frames)[0],
                               host.decode_tiles(frames)[0],
                               len(frames[0]))}
        tframes = turbo.encode_tiles(tiles)
        res["cae_tpu"] = _metrics(img, turbo_symbols(tframes),
                                  np.asarray(turbo.decode_tiles(tframes))[0],
                                  len(tframes[0]))
        y = latent(tiles)[0]
        buf = bn.encode(y)
        y_q = bn.decode(buf)
        res["cae_bn"] = _metrics(
            img, np.round(y - bn.medians),
            np.asarray(host.decode_latents_device(y_q[None]))[0], len(buf))
        return res, frames, tframes

    j_bn = jcodec.ConvolutionalAutoencoderBottleneck(
        t_model.channels_bn, fact_ent=j_model.variables["fact_ent"])
    try:
        jax_convops.set_default_precision("bf16")
        j_host = jcodec.CAECodecCore(j_model)
        j_turbo = JaxTurboCore(j_model, num_streams=STREAMS)
        out["jax"], _, _ = paths(
            j_host, j_turbo, j_bn,
            lambda t: np.asarray(j_host._latent(jnp.asarray(t))))
    finally:
        jax_convops.set_default_precision("highest")
    t_bn = tcodec.ConvolutionalAutoencoderBottleneck(
        t_model.channels_bn, fact_ent=t_model.fact_ent.params())
    for name, dtype in (("bf16", BF16), ("float32", torch.float32)):
        host = tcodec.CAECodecCore(t_model, device="cpu",
                                   compute_dtype=dtype)
        turbo = CAETurboCore(t_model, STREAMS, device="cpu",
                             compute_dtype=dtype)

        def latent(t, host=host):
            x = torch.from_numpy(t).float() / 255.0
            with torch.no_grad():
                return t_model.encoder(x.to(host.compute_dtype)).float() \
                    .numpy()

        out[name], frames, tframes = paths(host, turbo, t_bn, latent)
        port[name] = dict(host=host, turbo=turbo, frames=frames,
                          tframes=tframes)
    return img, out, port, j_model


def _within_budget(a, b):
    flips = float(np.mean(a["sym"] != b["sym"]))
    dpsnr = a["psnr"] - b["psnr"]
    dbpp = abs(a["bpp"] - b["bpp"]) / b["bpp"]
    assert flips < MAX_FLIPS, flips
    assert abs(dpsnr) <= MAX_DPSNR, (a["psnr"], b["psnr"])
    assert dbpp < MAX_DBPP, (a["bpp"], b["bpp"])


@pytest.mark.parametrize("path", ["cae", "cae_tpu", "cae_bn"])
@pytest.mark.parametrize("against", ["jax", "float32"])
def test_bf16_path_within_budget(served, path, against):
    """The port's bf16 path against the JAX package's bf16 path, and
    against the port's own float32 path: symbol flips, PSNR and bpp."""
    _, out, _, _ = served
    _within_budget(out["bf16"][path], out[against][path])


def test_bf16_turbo_equals_cae(served):
    """Within the port's bf16: 'cae_tpu' symbols equal 'cae' symbols and
    the reconstructions are byte-identical (tests/test_bf16_rd.py:
    130-160)."""
    img, out, port, _ = served
    bf = out["bf16"]
    np.testing.assert_array_equal(bf["cae_tpu"]["sym"], bf["cae"]["sym"])
    p = port["bf16"]
    rec_host = p["host"].decode_tiles(p["frames"])
    rec_turbo = p["turbo"].decode_tiles(p["tframes"])
    np.testing.assert_array_equal(rec_turbo, rec_host)
    assert rec_host.shape == (1,) + img.shape


@pytest.mark.parametrize("codec", ["cae", "cae_tpu"])
def test_bf16_frames_decode_at_float32(served, codec):
    """Frames written in bf16 decode on the port's float32 reader with
    equal symbols, to the float32 reconstruction of those symbols, and in
    the JAX package (host frames: equal symbols; turbo frames: its float32
    decode within the u8 tolerance of the port's)."""
    img, _, port, j_model = served
    bf, f32 = port["bf16"], port["float32"]
    if codec == "cae":
        frames = bf["frames"]
        sym = bf["host"].entropy_decode(frames)[0]
        np.testing.assert_array_equal(
            f32["host"].entropy_decode(frames)[0], sym)
        rec = f32["host"].decode_tiles(frames)
        np.testing.assert_array_equal(
            rec, f32["host"].decode_tiles_device(sym).numpy()[:, :SIDE,
                                                             :SIDE])
        np.testing.assert_array_equal(
            jcodec.CAECodecCore(j_model).entropy_decode(frames)[0], sym)
    else:
        frames = bf["tframes"]
        sym = bf["turbo"].symbols_from_frames(frames, STREAMS, SIDE, SIDE)
        np.testing.assert_array_equal(
            f32["turbo"].symbols_from_frames(frames, STREAMS, SIDE, SIDE),
            sym)
        rec = f32["turbo"].decode_tiles(frames)
        np.testing.assert_array_equal(
            rec, f32["turbo"].reconstruct(sym, SIDE, SIDE))
        _assert_u8_close(rec, np.asarray(
            JaxTurboCore(j_model, num_streams=STREAMS).decode_tiles(frames)))
    assert rec.shape == (1,) + img.shape
