"""The port's reference ``.pth`` import (``utils/torch_import.py``, through
``training/checkpoint.py:load_checkpoint``) against the JAX package's:
array-equal conversion for every unit layout, the imported model's forward,
the compress CLI's chunks from ``-chk x.pth``, and checkpoints with a
classifier or segmenter head.  The reference-layout modules are untrained
(``tests/test_torch_import.py``'s replicas, ``tests/torch_ref_cae.py``'s
bottleneck and checkpoint layout)."""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cnn_autoencoder_tpu.models.factory import \
    autoencoder_from_state_dict as jax_from_state_dict
from cnn_autoencoder_tpu.utils import torch_import as J
from cnn_autoencoder_tpu_torch.models.factory import \
    autoencoder_from_state_dict
from cnn_autoencoder_tpu_torch.training.checkpoint import load_checkpoint
from cnn_autoencoder_tpu_torch.utils import torch_import as T

from tests.test_torch_cli import _both, _chunks, _zarr_input
from tests.test_torch_import import _t_analyzer, _t_synthesizer
from tests.test_torch_turbo import _image
from tests.torch_ref_cae import (TorchFactorizedEntropy,
                                 reference_checkpoint_dict)

LEVEL, NET, BN = 3, 6, 8
# every _unit_layout case: act None / ReLU / GDN x batch norm x residual x
# multiscale color layers
LAYOUTS = list(itertools.product([None, "ReLU", "GDN"], [False, True],
                                 [False, True], [False, True]))


def _reference(act, bn, residual, multiscale, bias=False, seed=0,
               level=LEVEL, net=NET, bn_ch=BN):
    """A reference-layout training checkpoint dict of untrained modules."""
    torch.manual_seed(seed)
    enc = _t_analyzer(level, net, bn_ch, act, bn, bias, residual)
    dec = _t_synthesizer(level, net, bn_ch, act, bn, bias, residual,
                         multiscale)
    fe = TorchFactorizedEntropy(bn_ch)
    with torch.no_grad():     # batch-norm statistics away from 0 and 1
        for m in list(enc.modules()) + list(dec.modules()):
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.uniform_(-1, 1)
                m.running_var.uniform_(0.5, 2)
    chk = reference_checkpoint_dict(enc, dec, fe, level, net, bn_ch, act)
    chk.update(batch_norm=bn, use_residual=residual,
               multiscale_analysis=multiscale, bias=bias)
    return chk


def _assert_same_tree(got, want, path=""):
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            _assert_same_tree(got[k], want[k], f"{path}/{k}")
    else:
        assert type(got) is type(want) or (
            isinstance(got, np.ndarray) and isinstance(want, np.ndarray)), \
            path
        if isinstance(want, np.ndarray):
            assert got.dtype == want.dtype and got.shape == want.shape, path
            np.testing.assert_array_equal(got, want, err_msg=path)
        else:
            assert got == want, path


@pytest.mark.parametrize("act,bn,residual,multiscale", LAYOUTS)
def test_conversion_equals_jax(act, bn, residual, multiscale):
    """``convert_reference_checkpoint`` gives the JAX one's config and
    arrays exactly, and each track's ``_unit_layout`` is the JAX one's."""
    for track in ("analysis", "synthesis"):
        assert T._unit_layout(act, bn, residual, track) == \
            J._unit_layout(act, bn, residual, track)
    chk = _reference(act, bn, residual, multiscale)
    _assert_same_tree(T.convert_reference_checkpoint(chk),
                      J.convert_reference_checkpoint(chk))


def test_module_prefix_stripped():
    """DataParallel's ``module.`` prefix goes, as in the JAX importer."""
    chk = _reference("GDN", False, False, True)
    chk["decoder"] = {"module." + k: v for k, v in chk["decoder"].items()}
    got = T.convert_reference_checkpoint(chk)
    _assert_same_tree(got, J.convert_reference_checkpoint(chk))
    assert {"up_0", "color_0", "color_1"} <= set(got["decoder"]["params"])


@pytest.mark.parametrize("act,bias,multiscale", [("GDN", False, False),
                                                 ("LeakyReLU", True, True)])
def test_imported_forward_matches_jax(tmp_path, act, bias, multiscale):
    """The port's model from the ``.pth`` file against the JAX package's
    from the same file: latents and every reconstruction level within the
    test_rd_parity tolerances."""
    path = str(tmp_path / "ref.pth")
    torch.save(_reference(act, False, False, multiscale, bias=bias), path)
    assert load_checkpoint(path)["act_layer_type"] == act
    tm = autoencoder_from_state_dict(path, device="cpu")
    jm = jax_from_state_dict(path)
    x = np.random.RandomState(3).rand(2, 32, 40, 3).astype(np.float32)
    y_j = jm.encode(jnp.asarray(x))
    x_r_j, _ = jm.decode(y_j)
    with torch.no_grad():
        y_t = tm.encoder(torch.from_numpy(x))
        x_r_t, _ = tm.decoder(y_t)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), rtol=1e-4,
                               atol=1e-4)
    assert len(x_r_t) == len(x_r_j) == LEVEL
    for s, (g, w) in enumerate(zip(x_r_t, x_r_j)):
        if w is None:
            assert g is None and not multiscale
            continue
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4, err_msg=f"x_r[{s}]")
    np.testing.assert_array_equal(
        tm.fact_ent.quantiles.detach().numpy(),
        np.asarray(jm.variables["fact_ent"]["params"]["quantiles"]))


def test_compress_cli_from_pth_matches_jax(tmp_path, monkeypatch):
    """``compress -chk x.pth`` writes the JAX CLI's chunks and metadata."""
    path = str(tmp_path / "ref.pth")
    torch.save(_reference("GDN", False, False, False, level=2, net=8,
                          bn_ch=16), path)
    img = _image(96, 80, seed=13)
    (tmp_path / "in").mkdir()
    _zarr_input(tmp_path / "in" / "slide.zarr", img)
    outs = _both(tmp_path, monkeypatch, [
        "-dd", str(tmp_path / "in"), "-if", "zarr", "-cod", "CAETPU",
        "-chk", path, "-ps", "32", "-da", "YXC", "-dg", "0/0"])
    stores = {pkg: str(out / "slide.zarr") for pkg, out in outs.items()}
    port, ref = _chunks(stores["port"]), _chunks(stores["jax"])
    assert port == ref and ".zarray" in port and len(port) > 2


@pytest.mark.parametrize("head", ["class_model", "seg_model"])
def test_heads_raise_not_ported(tmp_path, head):
    """A checkpoint with a head (a cut ResNet in torchvision's layout, a
    UNet in the reference's) converts to the JAX package's trees, array for
    array, and ``autoencoder_from_state_dict`` loads it: the ResNet head
    gives the torchvision oracle's logits, the UNet holds the imported
    weights.  With weights missing from the head it raises."""
    from cnn_autoencoder_tpu_torch.models.factory import CAEModel
    from cnn_autoencoder_tpu_torch.utils.weights import head_from_jax
    from tests.test_head_parity import _randomize
    from tests.test_torch_heads import reference_unet_state_dict
    from tests.torch_ref_heads import TorchResNetHead
    chk = _reference("GDN", False, False, False)
    if head == "class_model":
        oracle = _randomize(TorchResNetHead(channels_bn=BN, cut_position=4,
                                            num_classes=2), seed=4).eval()
        chk.update(class_model_type="ResNet", cut_position=4, num_classes=2,
                   class_model=oracle.state_dict())
    else:
        chk.update(seg_model_type="UNet", seg_channels_net=8,
                   seg_channels_bn=8, seg_channels_expansion=2)
        chk["seg_model"] = reference_unet_state_dict(
            CAEModel(chk).seg_model)
    tree = T.convert_reference_checkpoint(chk)[head]
    _assert_same_tree(tree, J.convert_reference_checkpoint(chk)[head])
    path = str(tmp_path / "heads.pth")
    torch.save(chk, path)
    model = autoencoder_from_state_dict(path, device="cpu")
    for key, value in head_from_jax(tree).items():
        assert torch.equal(getattr(model, head).state_dict()[key], value)
    if head == "class_model":
        y = np.random.RandomState(2).randn(2, BN, 4, 4).astype(np.float32)
        with torch.no_grad():
            ref, _ = oracle(torch.from_numpy(y))
            got, _ = model.class_model(torch.from_numpy(
                np.ascontiguousarray(y.transpose(0, 2, 3, 1))))
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=2e-4,
                                   atol=2e-5)
    chk[head] = {k: v for k, v in chk[head].items()
                 if not k.startswith("fc.")}
    torch.save(chk, path)
    with pytest.raises(ValueError, match="lacks weights"):
        autoencoder_from_state_dict(path, device="cpu")


def test_optimizer_and_scheduler_state_dropped():
    chk = _reference("GDN", False, False, False)
    chk.update(optimizer_encoder={"state": {}}, scheduler_encoder={"x": 1},
               step=12, extra={"a": 1})
    got = T.convert_reference_checkpoint(chk)
    assert "optimizer_encoder" not in got and "scheduler_encoder" not in got
    assert got["step"] == 12 and "extra" not in got
    jax.tree_util.tree_map(np.testing.assert_array_equal,
                           got["fact_ent"],
                           J.convert_reference_checkpoint(chk)["fact_ent"])
