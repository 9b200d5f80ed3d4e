"""The port's Analyzer/Synthesizer (plain versions, on the CPU) against the
JAX package, by the protocol of ``test_rd_parity``: latents within float32
tolerance, no symbol flips, u8 reconstructions equal almost everywhere."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cnn_autoencoder_tpu.models.autoencoder import Analyzer as JaxAnalyzer
from cnn_autoencoder_tpu.models.autoencoder import \
    Synthesizer as JaxSynthesizer
from cnn_autoencoder_tpu.models.factory import \
    autoencoder_from_state_dict as jax_from_state_dict
from cnn_autoencoder_tpu_torch.models.autoencoder import (Analyzer,
                                                          Synthesizer)
from cnn_autoencoder_tpu_torch.models.factory import (
    CAEModel, autoencoder_from_state_dict)
from cnn_autoencoder_tpu_torch.utils.weights import state_from_jax

FLAGSHIP = "benchmarks/bench_flagship.msgpack"


def _image(h=64, w=64, seed=0):
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    return np.clip((np.sin(yy / 9.0) + np.cos(xx / 11.0))[:, :, None]
                   * np.ones((1, 1, 3)) * 55 + 128
                   + rng.randn(h, w, 3) * 4, 0, 255).astype(np.uint8)


def _assert_parity(j_encode, j_decode, t_enc, t_dec, img, medians):
    """The test_rd_parity protocol on one image (NHWC in both packages)."""
    x = img[None].astype(np.float32) / 255.0
    y_j = np.asarray(j_encode(jnp.asarray(x)))
    with torch.no_grad():
        y_t = t_enc(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(y_t, y_j, rtol=1e-4, atol=1e-4)

    sym_j = np.round(y_j - medians).astype(np.int32)
    sym_t = np.round(y_t - medians).astype(np.int32)
    mismatch = np.mean(sym_j != sym_t)
    assert mismatch == 0.0, f"{mismatch:.2e} of symbols flipped"

    y_q = (sym_j + medians).astype(np.float32)
    rec_j = np.asarray(j_decode(jnp.asarray(y_q))[0][0])
    with torch.no_grad():
        rec_t = t_dec(torch.from_numpy(y_q))[0][0].numpy()
    np.testing.assert_allclose(rec_t, rec_j, rtol=1e-4, atol=1e-4)

    u8_j = np.clip(rec_j * 255.0, 0, 255).astype(np.uint8)
    u8_t = np.clip(rec_t * 255.0, 0, 255).astype(np.uint8)
    frac_diff = np.mean(u8_t != u8_j)
    assert frac_diff < 5e-3, frac_diff
    if frac_diff:
        assert np.abs(u8_t.astype(int) - u8_j.astype(int)).max() <= 1


def test_jax_initialized_weights_carry_across():
    level, net, bn_ch = 3, 8, 12
    kw = dict(channels_org=3, channels_net=net, channels_bn=bn_ch,
              compression_level=level, act_layer_type="GDN")
    j_enc, j_dec = JaxAnalyzer(**kw), JaxSynthesizer(**kw)
    k_enc, k_dec = jax.random.split(jax.random.PRNGKey(0))
    v_enc = j_enc.init(k_enc, jnp.zeros((1, 64, 64, 3)))
    v_dec = j_dec.init(k_dec, jnp.zeros((1, 8, 8, bn_ch)))
    # non-trivial GDN parameters: perturb every beta/gamma
    rng = np.random.RandomState(1)

    def perturb(path, a):
        a = np.asarray(a)
        if path[-1].key in ("beta", "gamma"):
            return a + 0.05 * rng.rand(*a.shape).astype(np.float32)
        return a
    v_enc = jax.tree_util.tree_map_with_path(perturb, v_enc)
    v_dec = jax.tree_util.tree_map_with_path(perturb, v_dec)

    weights = state_from_jax({"encoder": v_enc, "decoder": v_dec},
                             {"compression_level": level})
    t_enc, t_dec = Analyzer(**kw), Synthesizer(**kw)
    for prefix, mod in (("encoder.", t_enc), ("decoder.", t_dec)):
        mod.load_state_dict({k[len(prefix):]: v for k, v in weights.items()
                             if k.startswith(prefix)}, strict=True)
    medians = rng.randn(bn_ch).astype(np.float32) * 0.1
    _assert_parity(lambda x: j_enc.apply(v_enc, x),
                   lambda y: j_dec.apply(v_dec, y),
                   t_enc.eval(), t_dec.eval(), _image(), medians)


def test_flagship_fixture_one_tile():
    """At full width the fused conv+GDN stage (down_1) runs its plain
    version, the other GDN stages the GDN plain version."""
    j_model = jax_from_state_dict(FLAGSHIP)
    t_model = autoencoder_from_state_dict(FLAGSHIP, device="cpu")
    assert [getattr(t_model.encoder, n).fused
            for n in t_model.encoder.names] == [False, True, False]
    medians = np.asarray(
        j_model.variables["fact_ent"]["params"]["quantiles"][:, 0, 1])
    _assert_parity(j_model.encode, j_model.decode, t_model.encoder,
                   t_model.decoder, _image(seed=3), medians)


def test_unported_options_raise():
    """The heads build (tests/test_torch_heads.py holds them to the JAX
    package) and so do the architecture options
    (tests/test_torch_arch_options.py); an unknown head or activation
    raises."""
    for key, value, child in (("class_model_type", "ResNet", "class_model"),
                              ("seg_model_type", "UNet", "seg_model")):
        model = CAEModel({"channels_bn": 8, "compression_level": 2,
                          "cut_position": 4, key: value})
        assert hasattr(model, child)
        with pytest.raises(ValueError, match="unknown"):
            CAEModel({"channels_bn": 8, "compression_level": 2,
                      key: value + "X"})
    for key, value in (("batch_norm", True), ("use_residual", True),
                       ("dropout", 0.1), ("groups", True)):
        CAEModel({"channels_org": 3, "channels_net": 3, "channels_bn": 3,
                  "compression_level": 2, key: value})
    with pytest.raises(ValueError, match="not supported"):
        Analyzer(act_layer_type="Swish")
