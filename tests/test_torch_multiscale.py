"""The port's multiscale decoder (``Synthesizer(multiscale_analysis=True)``
and its color layers) against the JAX package's through
``utils/weights.py``, and reconstruction at coarser levels:
``CAECodecCore.decode_latents_device`` and
``pipeline/tiles.py:decompress_latents_to_pixels`` at ``rec_level`` 1 and
2 against the JAX package's, under the ``test_rd_parity`` tolerances."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cnn_autoencoder_tpu.models.autoencoder import Synthesizer as JSynth
from cnn_autoencoder_tpu.models.factory import build_model as jax_build
from cnn_autoencoder_tpu.models.factory import \
    autoencoder_from_state_dict as jax_from_state_dict
from cnn_autoencoder_tpu.pipeline import tiles as jtiles
from cnn_autoencoder_tpu.storage import zarr as jzarr
from cnn_autoencoder_tpu.storage.cae_codec import CAECodecCore as JCore
from cnn_autoencoder_tpu.training.checkpoint import \
    save_checkpoint as jax_save_checkpoint
from cnn_autoencoder_tpu_torch.models.autoencoder import Synthesizer
from cnn_autoencoder_tpu_torch.models.factory import \
    autoencoder_from_state_dict
from cnn_autoencoder_tpu_torch.pipeline import tiles as ttiles
from cnn_autoencoder_tpu_torch.storage import zarr as tzarr
from cnn_autoencoder_tpu_torch.storage.cae_codec import CAECodecCore
from cnn_autoencoder_tpu_torch.utils.weights import (state_from_jax,
                                                     state_to_jax)

from tests.test_torch_turbo import _assert_u8_close, _image

MS_CONFIG = dict(channels_org=3, channels_net=8, channels_bn=16,
                 compression_level=3, K=4, r=3, act_layer_type="GDN",
                 multiscale_analysis=True)

# (act, bias, channels_expansion): a color layer takes its stage's width,
# which at expansion 2 is not the reference's color_channels
SYNTH_CASES = [("GDN", False, 1), ("LeakyReLU", True, 1), (None, True, 1),
               ("GDN", False, 2)]


@pytest.mark.parametrize("act,bias,expansion", SYNTH_CASES)
def test_multiscale_synthesizer_matches_jax(act, bias, expansion):
    """Every level of the pyramid, finest first, within the test_rd_parity
    tolerances; the weights cross through ``state_from_jax`` and back
    through ``state_to_jax`` unchanged."""
    level, cfg = 3, dict(channels_org=3, channels_net=6, channels_bn=8,
                         channels_expansion=expansion, use_bias=bias,
                         act_layer_type=act)
    jmod = JSynth(compression_level=level, multiscale_analysis=True, **cfg)
    y = np.random.RandomState(2).randn(2, 4, 5, 8).astype(np.float32)
    variables = jax.tree_util.tree_map(np.asarray, jmod.init(
        jax.random.PRNGKey(1), jnp.asarray(y)))
    assert {f"color_{i}" for i in range(level - 1)} <= \
        set(variables["params"])
    weights = state_from_jax({"decoder": variables},
                             {"compression_level": level})
    tmod = Synthesizer(compression_level=level, multiscale_analysis=True,
                       **cfg)
    tmod.load_state_dict({k[len("decoder."):]: v for k, v in
                          weights.items()}, strict=True)
    back = state_to_jax(weights, {"compression_level": level})["decoder"][
        "params"]
    jax.tree_util.tree_map(np.testing.assert_array_equal, back,
                           variables["params"])

    want, _ = jmod.apply(variables, jnp.asarray(y))
    with torch.no_grad():
        got, _ = tmod(torch.from_numpy(y))
    assert len(got) == len(want) == level
    for s, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape == (2, 4 << (level - s),
                                             5 << (level - s), 3)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-4,
                                   err_msg=f"x_r[{s}]")


def test_single_scale_synthesizer_keeps_none():
    tmod = Synthesizer(channels_net=6, channels_bn=8, compression_level=3)
    x_r, _ = tmod(torch.zeros(1, 2, 2, 8))
    assert x_r[1] is None and x_r[2] is None and x_r[0].shape[1] == 16
    assert not any(n.startswith("color_") for n, _ in tmod.named_children())


@pytest.fixture(scope="module")
def ms_checkpoint(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ms") / "ms.msgpack")
    m = jax_build(jax.random.PRNGKey(0), input_size=(32, 32), **MS_CONFIG)
    jax_save_checkpoint(path, {**m.config, **m.variables})
    return path


def test_color_layers_from_a_single_scale_checkpoint(ms_checkpoint):
    """A multiscale model from a checkpoint without color layers (a
    multiscale criterion trained from a single-scale model) initialises
    them from seed 0, the same every time; any other missing weight
    raises."""
    from cnn_autoencoder_tpu_torch.training.checkpoint import load_checkpoint
    state = load_checkpoint(ms_checkpoint)
    dec = {u: v for u, v in state["decoder"]["params"].items()
           if not u.startswith("color_")}
    single = dict(state, decoder={"params": dec})
    a = autoencoder_from_state_dict(single, device="cpu")
    b = autoencoder_from_state_dict(single, device="cpu")
    full = autoencoder_from_state_dict(ms_checkpoint, device="cpu")
    for name in ("color_0", "color_1"):
        wa = getattr(a.decoder, name).weight
        torch.testing.assert_close(wa, getattr(b.decoder, name).weight,
                                   rtol=0, atol=0)
        assert not torch.equal(wa, getattr(full.decoder, name).weight)
    torch.testing.assert_close(a.decoder.up_0.deconv_up.weight,
                               full.decoder.up_0.deconv_up.weight)
    dec = dict(dec)
    del dec["up_1"]
    with pytest.raises(ValueError, match="stages"):
        autoencoder_from_state_dict(dict(state, decoder={"params": dec}),
                                    device="cpu")


def test_training_checkpoint_without_the_flag(ms_checkpoint):
    """The train CLI's checkpoints record the criterion, not
    ``multiscale_analysis``: the port takes the flag from the decoder's
    color layers and keeps their weights, where the JAX package's loader
    drops them (so ``-rl`` on its own multiscale checkpoint raises); a
    config that says False drops them in both."""
    from cnn_autoencoder_tpu_torch.training.checkpoint import load_checkpoint
    state = load_checkpoint(ms_checkpoint)
    del state["multiscale_analysis"]
    state["criterion"] = "MultiscaleRateMSSSIM"
    t = autoencoder_from_state_dict(state, device="cpu")
    assert t.decoder.multiscale_analysis and t.config["multiscale_analysis"]
    np.testing.assert_array_equal(
        t.decoder.color_0.weight.detach().numpy(), np.transpose(
            state["decoder"]["params"]["color_0"]["kernel"], (3, 2, 0, 1)))
    j = jax_from_state_dict(state)
    assert "color_0" not in j.variables["decoder"]["params"]
    state["multiscale_analysis"] = False
    single = autoencoder_from_state_dict(state, device="cpu")
    assert not hasattr(single.decoder, "color_0")


@pytest.fixture(scope="module")
def cores(ms_checkpoint):
    return (JCore(jax_from_state_dict(ms_checkpoint)),
            CAECodecCore(autoencoder_from_state_dict(ms_checkpoint,
                                                     device="cpu"),
                         device="cpu"))


@pytest.mark.parametrize("rec_level", [1, 2, 3, -1])
def test_decode_latents_device_coarse_levels(cores, rec_level):
    """``rec_level`` L decodes at 2**L times the latent's size (-1 and the
    model's level at full scale)."""
    jcore, tcore = cores
    y = (np.random.RandomState(4).randn(2, 5, 6, 16) * 2).astype(np.float32)
    want = np.asarray(jcore.decode_latents_device(y, rec_level=rec_level))
    got = tcore.decode_latents_device(y, rec_level=rec_level).numpy()
    scale = 2 ** (3 if rec_level == -1 else rec_level)
    assert got.dtype == np.uint8
    assert got.shape == want.shape == (2, 5 * scale, 6 * scale, 3)
    _assert_u8_close(got, want)


@pytest.mark.parametrize("rec_level", [1, 2])
def test_decompress_latents_to_pixels_coarse_levels(cores, tmp_path,
                                                    rec_level):
    """A 'cae_bn' store of a 72 x 88 image (true shape kept) decoded at a
    coarser level by both packages: the same metadata bytes, shape and
    chunk grid, the pixels within the test_rd_parity tolerances."""
    jcore, tcore = cores
    img = _image(72, 88, seed=5)
    src_path = str(tmp_path / "bn.zarr")
    jtiles.compress_pixels_to_bottleneck(jcore, img, src_path,
                                         patch_size=32, batch_tiles=3)
    out = {}
    for pkg, tiles, core, src in (
            ("j", jtiles, jcore, jzarr.open(src_path)["0/0"]),
            ("t", ttiles, tcore,
             tzarr.open(src_path, device="cpu")["0/0"])):
        path = str(tmp_path / f"rec_{pkg}.zarr")
        res = tiles.decompress_latents_to_pixels(
            core, src, path, "rec/0", batch_tiles=3, rec_level=rec_level)
        with open(os.path.join(path, "rec", "0", ".zarray"), "rb") as f:
            meta = f.read()
        out[pkg] = (res[...], meta, sorted(res.chunk_ids()))
    scale = 2 ** rec_level
    # ceil(72 / 8) x ceil(88 / 8) latents, at 2**rec_level each
    assert out["t"][0].shape == (9 * scale, 11 * scale, 3)
    assert out["t"][1] == out["j"][1] and out["t"][2] == out["j"][2]
    _assert_u8_close(out["t"][0], out["j"][0])
