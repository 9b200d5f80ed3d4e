"""The port's heads (``models/classifiers.py``, ``models/segmenters.py``)
against the JAX package's flax heads, weights carried across by
``utils/weights.py``: each head's eval-mode forward (and Inception's
train-mode forward with its new batch statistics) at 1e-5 relative in
float32; the carry-over both ways against flax's own initial trees; the
model with both heads through ``make_forward_fn``; and the head importers
against the torchvision oracles of ``tests/torch_ref_heads.py`` and the JAX
importers.  The weights start from the port's seeded init (norms moved off
1 and 0) and reach flax through ``head_to_jax``, whose trees flax applies
(jitted) only when every parameter is there with its shape.

Inception in train mode normalizes by the statistics of a batch of two
(a 1x1 map at its auxiliary head), which the float32 rounding of either
side moves by up to about 1e-3 relative; there each side is held to the
port's own float64 forward, and the two to each other, within twice the
JAX side's distance from it plus 1e-5 of the largest logit.  Inception's
blocks are held one by one on small inputs, and ``models/layers.py``
layer by layer, so that no test pays for a whole head at its native
35^2 or 299^2."""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cnn_autoencoder_tpu.models import classifiers as jcls
from cnn_autoencoder_tpu.models import segmenters as jseg
from cnn_autoencoder_tpu_torch.models import classifiers as cls
from cnn_autoencoder_tpu_torch.models import layers
from cnn_autoencoder_tpu_torch.models import segmenters as seg
from cnn_autoencoder_tpu_torch.utils.weights import (head_from_jax,
                                                     head_to_jax)

LATENT = (2, 8, 8, 16)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads for the port's CPU work in this file: the suite
    runs six workers on the machine's cores."""
    saved = torch.get_num_threads()
    torch.set_num_threads(min(saved, 2))
    yield
    torch.set_num_threads(saved)


# whole heads; Inception's blocks are held one by one below, where their
# native sizes (35^2, 17^2) would make a whole head at cuts 0 to 4 cost
# gigaflops a test
CASES = {
    "vit_cut10": ("ViT", dict(channels_bn=16, cut_position=10, patch_size=32,
                              compression_level=2, num_classes=5), LATENT),
    "resnet_cut3": ("ResNet", dict(channels_bn=16, cut_position=3,
                                   patch_size=32, compression_level=2,
                                   num_classes=7, layers=(1, 2, 1, 1)),
                    LATENT),
    "inception_cut6": ("InceptionV3", dict(channels_bn=16, cut_position=6,
                                           num_classes=6), LATENT),
    "inception_from_patch": ("InceptionV3", dict(
        channels_bn=16, cut_position=None, patch_size=64,
        compression_level=3, num_classes=6), LATENT),
    "unet": ("UNet", dict(channels_org=3, seg_channels_net=8,
                          seg_channels_bn=16, seg_channels_expansion=2,
                          compression_level=2, num_classes=2), (1, 16, 16, 3)),
    "jnet": ("JNet", dict(channels_bn=16, seg_channels_net=8,
                          seg_channels_bn=16, seg_channels_expansion=2,
                          compression_level=2, num_classes=1,
                          batch_norm=False), (1, 4, 4, 16)),
    "jnet_bridges": ("JNet", dict(channels_org=3, channels_net=8,
                                  channels_bn=16, seg_channels_net=8,
                                  seg_channels_bn=16,
                                  seg_channels_expansion=2,
                                  compression_level=2, num_classes=2,
                                  concat_bridges=True), (1, 4, 4, 16)),
}
JAX_HEADS = {**jcls.CLASS_MODELS, "UNet": jseg.UNet, "JNet": jseg.JNet}
PORT_HEADS = {**cls.CLASS_MODELS, **seg.SEG_MODELS}


def _bridges(case, shape):
    if case != "jnet_bridges":
        return None
    rng = np.random.RandomState(9)
    n, h = shape[0], shape[1]
    return [rng.randn(n, 2 * h, 2 * h, 8).astype(np.float32),
            rng.randn(n, 4 * h, 4 * h, 3).astype(np.float32)]


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port(kind, kwargs, shape, variables=None, seed=0):
    """The port's head for inputs of ``shape``: ``variables`` loaded, else
    its seeded init with every 1-D leaf (biases, scales, statistics) moved
    by U(0, 0.2)."""
    extra = {"channels_in": shape[-1]}
    if kind == "ViT":
        extra["input_size"] = shape[1:3]
    module = PORT_HEADS[kind](**kwargs, **extra)
    if variables is None:
        gen = torch.Generator().manual_seed(seed)
        for m in module.modules():
            if hasattr(m, "reset_parameters"):
                m.reset_parameters(gen)
        with torch.no_grad():
            for value in module.state_dict().values():
                if value.dim() == 1:
                    value.add_(torch.rand(value.shape, generator=gen) * 0.2)
    else:
        module.load_state_dict(head_from_jax(variables), strict=True)
    return module


def _jax_apply(kind, kwargs, variables, x, train, bridges):
    module = JAX_HEADS[kind](**kwargs)
    extra = {} if bridges is None else {
        "fx_brg": [jnp.asarray(b) for b in bridges]}

    def apply(v, x):
        if train:
            return module.apply(v, x, train=True, mutable=["batch_stats"],
                                **extra)
        return module.apply(v, x, train=False, **extra), {}
    (pred, aux), upd = jax.jit(apply)(variables, jnp.asarray(x))
    return pred, aux, upd.get("batch_stats")


def _forward(module, x, train, bridges, dtype=torch.float32):
    stats = {}
    kw = {} if bridges is None else {
        "fx_brg": [torch.from_numpy(b).to(dtype) for b in bridges]}
    with torch.no_grad():
        pred, aux = module(torch.from_numpy(x).to(dtype), train=train,
                           batch_stats=stats, **kw)
    return pred, aux, stats


def _close(got, ref, rtol=1e-5):
    ref = np.asarray(ref, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), ref, rtol=rtol,
                               atol=rtol * np.abs(ref).max())


# every head in eval mode; Inception, the one with batch norms, in train
# mode too
FORWARDS = [(case, False) for case in sorted(CASES)] + [
    ("inception_from_patch", True)]


@pytest.mark.parametrize("case,train", FORWARDS,
                         ids=[f"{c}-{'train' if t else 'eval'}"
                              for c, t in FORWARDS])
def test_head_forward_matches_flax(case, train):
    kind, kwargs, shape = CASES[case]
    x = np.random.RandomState(3).randn(*shape).astype(np.float32)
    bridges = _bridges(case, shape)
    module = _port(kind, kwargs, shape)
    variables = head_to_jax(module.state_dict())
    ref, ref_aux, ref_stats = _jax_apply(kind, kwargs, variables, x, train,
                                         bridges)
    pred, aux, stats = _forward(module, x, train, bridges)
    assert tuple(pred.shape) == tuple(ref.shape)
    assert (aux is None) == (ref_aux is None)
    if not train:
        _close(pred, ref)
        if aux is not None:
            _close(aux, ref_aux)
        return
    pred64, aux64, _ = _forward(module.double(), x, True, bridges,
                                torch.float64)
    _check_train((pred, aux), (ref, ref_aux), (pred64, aux64), module,
                 stats, ref_stats)


def _check_train(outs, refs, truths, module, stats, ref_stats):
    """Train mode: each output against the float64 forward within twice the
    JAX side's distance from it (plus 1e-5 of its largest), and the new
    running statistics within 1e-4."""
    for got, want, truth in zip(outs, refs, truths):
        truth = truth.numpy()
        bound = (2 * np.abs(np.asarray(want, np.float64) - truth).max()
                 + 1e-5 * np.abs(truth).max())
        assert np.abs(got.double().numpy() - truth).max() <= bound
        assert np.abs(got.double().numpy() - np.asarray(want)).max() <= bound
    paths = {m: p for p, m in module.named_modules()}
    new = head_to_jax({f"{paths[m]}.{k}": v for m, pair in stats.items()
                       for k, v in zip(("mean", "var"), pair)})
    got_stats = _flat(new.get("batch_stats", {}))
    want_stats = _flat(ref_stats or {})
    assert set(got_stats) == set(want_stats)
    for key, value in want_stats.items():
        _close(got_stats[key], value, 1e-4)


# Inception's blocks: (flax block, port block, input shape)
BLOCKS = {
    "A": (lambda: jcls.InceptionA(32), lambda: cls.InceptionA(16, 32),
          (2, 7, 7, 16)),
    "B": (lambda: jcls.InceptionB(), lambda: cls.InceptionB(16),
          (2, 9, 9, 16)),
    "C": (lambda: jcls.InceptionC(8), lambda: cls.InceptionC(16, 8),
          (2, 7, 7, 16)),
    "D": (lambda: jcls.InceptionD(), lambda: cls.InceptionD(16),
          (2, 9, 9, 16)),
    "E": (lambda: jcls.InceptionE(), lambda: cls.InceptionE(16),
          (2, 5, 5, 16)),
    "Aux": (lambda: jcls.InceptionAux(5), lambda: cls.InceptionAux(16, 5),
            (2, 17, 17, 16)),
    "Aux_past_cut4": (lambda: jcls.InceptionAux(5, True, True),
                      lambda: cls.InceptionAux(16, 5, True, True),
                      (2, 8, 8, 16)),
}


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("block", sorted(BLOCKS))
def test_inception_block_matches_flax(block, train):
    """Each Inception block on a small input, eval and train mode (batch
    norms), against flax's block on the port's seeded weights."""
    make_jax, make_port, shape = BLOCKS[block]
    module = make_port()
    gen = torch.Generator().manual_seed(1)
    for m in module.modules():
        if hasattr(m, "reset_parameters"):
            m.reset_parameters(gen)
    with torch.no_grad():
        for value in module.state_dict().values():
            if value.dim() == 1:
                value.add_(torch.rand(value.shape, generator=gen) * 0.2)
    x = np.random.RandomState(5).randn(*shape).astype(np.float32)
    flax_block = make_jax()

    def apply(v, x):
        if train:
            return flax_block.apply(v, x, train, mutable=["batch_stats"])
        return flax_block.apply(v, x, train), {}
    ref, upd = jax.jit(apply)(head_to_jax(module.state_dict()),
                              jnp.asarray(x))
    stats = {}
    with torch.no_grad():
        got = module(torch.from_numpy(x), train, stats)
    assert tuple(got.shape) == tuple(ref.shape)
    if not train:
        _close(got, ref)
        return
    with torch.no_grad():
        truth = module.double()(torch.from_numpy(x).double(), True, {})
    _check_train((got,), (ref,), (truth,), module, stats,
                 upd.get("batch_stats"))


LAYERS = {
    # (flax layer, port layer, input shape)
    "conv_16x16_s16_same_ragged": (
        lambda: nn.Conv(8, (16, 16), strides=(16, 16)),
        lambda: layers.Conv(3, 8, 16, 16), (1, 33, 40, 3)),
    "conv_7x7_s2_p3": (
        lambda: nn.Conv(8, (7, 7), strides=(2, 2), padding=3, use_bias=False),
        lambda: layers.Conv(3, 8, 7, 2, 3, use_bias=False), (2, 19, 18, 3)),
    "conv_1x7_p0_3": (
        lambda: nn.Conv(6, (1, 7), padding=((0, 0), (3, 3))),
        lambda: layers.Conv(4, 6, (1, 7), padding=(0, 3)), (1, 9, 9, 4)),
    "conv_3x3_s2_valid": (
        lambda: nn.Conv(6, (3, 3), strides=(2, 2), padding="VALID"),
        lambda: layers.Conv(4, 6, 3, 2, "VALID"), (1, 10, 11, 4)),
    "conv_1x1_s2_same_odd": (
        lambda: nn.Conv(6, (1, 1), strides=(2, 2)),
        lambda: layers.Conv(4, 6, 1, 2), (1, 9, 9, 4)),
    "conv_transpose_2x2": (
        lambda: nn.ConvTranspose(5, (2, 2), strides=(2, 2)),
        lambda: layers.ConvTranspose2x2(4, 5), (2, 3, 5, 4)),
    "dense": (lambda: nn.Dense(7), lambda: layers.Dense(6, 7), (3, 6)),
    "layer_norm": (lambda: nn.LayerNorm(epsilon=1e-6),
                   lambda: layers.LayerNorm(6, 1e-6), (2, 5, 6)),
    "group_norm": (lambda: nn.GroupNorm(num_groups=6, epsilon=1e-5),
                   lambda: layers.GroupNorm(6, 1e-5), (2, 4, 5, 6)),
}


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layer_matches_flax(name):
    """``models/layers.py`` against the flax layer it stands for, on the
    port's seeded weights: padding rules (a ragged "SAME" 16 x 16 stride-16
    patch conv, explicit and VALID paddings), the transposed conv's taps,
    and the norms' statistics."""
    make_jax, make_port, shape = LAYERS[name]
    module = make_port()
    gen = torch.Generator().manual_seed(2)
    module.reset_parameters(gen)
    with torch.no_grad():
        for value in module.state_dict().values():
            if value.dim() == 1:
                value.add_(torch.rand(value.shape, generator=gen) * 0.2)
    x = np.random.RandomState(6).randn(*shape).astype(np.float32) + 0.5
    ref = make_jax().apply(head_to_jax(module.state_dict()), jnp.asarray(x))
    with torch.no_grad():
        got = module(torch.from_numpy(x))
    assert tuple(got.shape) == tuple(ref.shape)
    _close(got, ref)


@pytest.mark.parametrize("op,k,s,p", [("max", 3, 2, 1), ("max", 2, 2, 0),
                                      ("avg", 3, 1, 1), ("avg", 5, 3, 0)])
def test_pool_matches_flax(op, k, s, p):
    x = np.random.RandomState(7).randn(2, 9, 10, 3).astype(np.float32)
    pad = ((p, p), (p, p))
    if op == "max":
        ref = nn.max_pool(jnp.asarray(x), (k, k), (s, s), pad)
        got = layers.max_pool(torch.from_numpy(x), k, s, p)
    else:
        ref = nn.avg_pool(jnp.asarray(x), (k, k), (s, s), pad,
                          count_include_pad=True)
        got = layers.avg_pool(torch.from_numpy(x), k, s, p)
    _close(got, ref)


@pytest.mark.parametrize("case", ["inception_from_patch", "jnet_bridges"])
def test_weights_carry_both_ways(case):
    """flax's own initial tree -> the port's head -> back, exactly."""
    kind, kwargs, shape = CASES[case]
    x = jnp.zeros(shape, jnp.float32)
    module = JAX_HEADS[kind](**kwargs)
    extra = {} if _bridges(case, shape) is None else {
        "fx_brg": [jnp.asarray(b) for b in _bridges(case, shape)]}
    variables = jax.jit(lambda k: module.init(k, x, **extra))(
        jax.random.PRNGKey(0))
    port = _port(kind, kwargs, shape, variables)
    want, got = _flat(variables), _flat(head_to_jax(port.state_dict()))
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])


def test_model_with_both_heads_through_forward_fn():
    """encoder -> fact_ent -> decoder + classifier + segmenter in one
    forward (``tests/test_heads.py:83``), the port's seeded model carried
    to the JAX package's modules by ``state_to_jax``."""
    from cnn_autoencoder_tpu.models.factory import setup_modules
    from cnn_autoencoder_tpu.models.tasks import \
        make_forward_fn as jax_forward_fn
    from cnn_autoencoder_tpu_torch.models.factory import build_model
    from cnn_autoencoder_tpu_torch.models.tasks import make_forward_fn
    from cnn_autoencoder_tpu_torch.utils.weights import state_to_jax
    config = dict(channels_org=3, channels_net=8, channels_bn=16,
                  compression_level=2, K=4, r=3, act_layer_type="GDN",
                  class_model_type="InceptionV3", cut_position=6,
                  num_classes=4, patch_size=32, seg_model_type="JNet",
                  seg_channels_net=8, seg_channels_bn=32,
                  seg_channels_expansion=2)
    model = build_model(config, torch.Generator().manual_seed(0),
                        device="cpu").eval()
    assert {n for n, _ in model.named_children()} == {
        "encoder", "decoder", "fact_ent", "class_model", "seg_model"}
    x = np.random.RandomState(0).rand(2, 32, 32, 3).astype(np.float32)
    modules = setup_modules(**config)
    ref, _ = jax.jit(jax_forward_fn(modules))(
        state_to_jax(model.state_dict(), config), jnp.asarray(x))
    with torch.no_grad():
        out, _ = make_forward_fn(model)(torch.from_numpy(x))
    for key in ("t_pred", "t_aux_pred", "s_pred"):
        _close(out[key], ref[key])
    assert out["s_aux_pred"] is None


@pytest.mark.parametrize("kind,state,shape", [
    ("ViT", dict(class_model_type="ViT", cut_position=10, channels_bn=16,
                 patch_size=32, compression_level=2, num_classes=5),
     (2, 8, 8, 16)),
    ("InceptionV3", dict(class_model_type="InceptionV3", cut_position=6,
                         channels_bn=16, num_classes=3), (2, 8, 8, 16)),
    ("UNet", dict(seg_model_type="UNet", channels_bn=16, seg_channels_net=8,
                  seg_channels_bn=16, seg_channels_expansion=2,
                  compression_level=2, num_classes=2), (1, 8, 8, 16)),
    ("JNet", dict(seg_model_type="JNet", channels_bn=16, seg_channels_net=8,
                  seg_channels_bn=16, seg_channels_expansion=1,
                  compression_level=2, num_classes=1, batch_norm=False),
     (1, 4, 4, 16)),
])
def test_head_from_state_dict_matches_jax(kind, state, shape):
    """``classifier_from_state_dict`` / ``segmenter_from_state_dict`` on a
    checkpoint holding a head's variables: the port's head, its input width
    (and ViT's tokens) read from the saved weights, gives the JAX head's
    output on the same variables."""
    seg_kind = state.get("seg_model_type")
    build = (seg.segmenter_from_state_dict if seg_kind
             else cls.classifier_from_state_dict)
    jax_build = (jseg.segmenter_from_state_dict if seg_kind
                 else jcls.classifier_from_state_dict)
    name = "seg_model" if seg_kind else "class_model"
    module = _port(kind, {k: v for k, v in state.items()
                          if k not in ("class_model_type", "seg_model_type")},
                   shape)
    chk = dict(state, **{name: head_to_jax(module.state_dict())})
    x = np.random.RandomState(8).randn(*shape).astype(np.float32)
    port = build(chk, device="cpu")
    jax_module, variables = jax_build(chk)
    ref = jax.jit(lambda v, x: jax_module.apply(v, x))(variables,
                                                       jnp.asarray(x))
    pred, aux, _ = _forward(port, x, False, None)
    _close(pred, ref[0])
    if aux is not None:
        _close(aux, ref[1])


def test_resnet_from_state_dict_where_jax_raises():
    """The JAX ``classifier_from_state_dict`` hands ``dropout`` to every
    head, and its ResNet has no such field, so it raises; the port's ResNet
    takes the keyword and ignores it (it has no dropout either) and loads
    the saved weights."""
    state = dict(class_model_type="ResNet", cut_position=4, channels_bn=16,
                 compression_level=2, num_classes=3)
    kwargs = dict(state, layers=(3, 8, 36, 3))
    del kwargs["class_model_type"]
    module = _port("ResNet", kwargs, (1, 4, 4, 16))
    chk = dict(state, class_model=head_to_jax(module.state_dict()))
    with pytest.raises(TypeError, match="dropout"):
        jcls.classifier_from_state_dict(chk)
    port = cls.classifier_from_state_dict(chk, device="cpu")
    for key, value in module.state_dict().items():
        assert torch.equal(port.state_dict()[key], value), key



@pytest.mark.parametrize("loader,state", [
    ("classifier", dict(class_model_type="ViT", cut_position=10,
                        channels_bn=16, patch_size=32, compression_level=2,
                        num_classes=5)),
    ("segmenter", dict(seg_model_type="JNet", channels_bn=16,
                       seg_channels_net=8, seg_channels_bn=16,
                       compression_level=2, num_classes=1)),
])
def test_head_loader_without_device_wants_the_card(loader, state,
                                                   monkeypatch):
    """Both head loaders take ``device=None`` to mean the card: without one
    they raise rather than hand back a CPU module."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    build = (cls.classifier_from_state_dict if loader == "classifier"
             else seg.segmenter_from_state_dict)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build(state)
    assert next(build(state, device="cpu").parameters()).device.type == "cpu"

# --- importers: torchvision-layout heads -> the port's heads ----------------


# (kind, kwargs, input shape NCHW, forward): Inception's oracles at cuts 0
# and 4 are held tree for tree only (their forwards cost gigaflops; the
# blocks are held to flax above)
ORACLES = [
    ("ViT", dict(channels_bn=24, cut_position=10, patch_size=128,
                 compression_level=4, num_classes=11), (2, 24, 8, 8), True),
    ("ResNet", dict(channels_bn=32, cut_position=3, patch_size=64,
                    compression_level=4, num_classes=9, layers=(1, 2, 3, 2)),
     (2, 32, 4, 4), True),
    ("ResNet", dict(channels_org=3, cut_position=0, patch_size=64,
                    compression_level=4, num_classes=9, layers=(2, 1, 1, 1)),
     (2, 3, 32, 32), True),
    ("InceptionV3", dict(channels_bn=16, cut_position=5, patch_size=128,
                         compression_level=4, num_classes=7), (1, 16, 8, 8),
     True),
    ("InceptionV3", dict(channels_bn=20, cut_position=4, patch_size=128,
                         compression_level=4, num_classes=7), (1, 20, 15, 15),
     False),
    ("InceptionV3", dict(channels_org=3, cut_position=0, patch_size=128,
                         compression_level=4, num_classes=7),
     (1, 3, 299, 299), False),
]


@pytest.mark.parametrize("kind,kwargs,shape,forward", ORACLES,
                         ids=[f"{k}-cut{a['cut_position']}"
                              for k, a, _, _ in ORACLES])
def test_importer_against_torchvision_oracle(kind, kwargs, shape, forward):
    """A randomised oracle (``tests/torch_ref_heads.py``) through the port's
    ``import_class_model``: the same trees as the JAX importer's, which the
    port's head loads; where ``forward``, the port's head reproduces the
    oracle's logits (and aux logits) within ``tests/test_head_parity.py``'s
    tolerances."""
    from cnn_autoencoder_tpu.utils.torch_import import \
        import_class_model as jax_import
    from cnn_autoencoder_tpu_torch.utils.torch_import import \
        import_class_model
    from tests.test_head_parity import _randomize
    from tests.torch_ref_heads import (TorchInceptionHead, TorchResNetHead,
                                       TorchViTHead)
    oracle = {"ViT": TorchViTHead, "ResNet": TorchResNetHead,
              "InceptionV3": TorchInceptionHead}[kind]
    tm = _randomize(oracle(**kwargs), seed=kwargs["cut_position"]).eval()
    sd = tm.state_dict()
    tree = import_class_model(sd, kind, cut_position=kwargs["cut_position"])
    ref_tree = jax_import(sd, kind, cut_position=kwargs["cut_position"])
    want, got = _flat(ref_tree), _flat(tree)
    assert set(got) == set(want)
    assert all(np.array_equal(got[k], want[k]) for k in want)
    nhwc = (shape[0], shape[2], shape[3], shape[1])
    module = _port(kind, kwargs, nhwc, tree)
    if not forward:
        return
    x = np.random.RandomState(1).randn(*shape).astype(np.float32)
    with torch.no_grad():
        t_pred, t_aux = tm(torch.from_numpy(x))
    x_nhwc = np.ascontiguousarray(np.transpose(x, (0, 2, 3, 1)))
    pred, aux, _ = _forward(module, x_nhwc, False, None)
    np.testing.assert_allclose(pred.numpy(), t_pred.numpy(), rtol=2e-4,
                               atol=2e-5)
    if t_aux is not None:
        np.testing.assert_allclose(aux.numpy(), t_aux.numpy(), rtol=5e-4,
                                   atol=5e-5)


def reference_unet_state_dict(module, seed=6):
    """A reference-layout state dict of the port's UNet / JNet ``module``'s
    shapes (the reference's unit names, torch's ConvTranspose2d layout),
    random values."""
    rng = np.random.RandomState(seed)
    sd = {}
    names = {"c1": "_c1", "c2": "_c2", "bn1": "_bn1", "bn2": "_bn2",
             "up": "_up_sample"}
    tracks = {"analysis": "analysis_track", "synthesis": "synthesis_track",
              "bridge": "bridges_projection"}
    for key, value in module.state_dict().items():
        parts = key.split(".")
        if parts[0] == "fc":
            name, leaf = "fc", parts[1]
        else:
            unit, layer, leaf = parts
            base = (f"{tracks[unit.split('_')[0]]}.{unit.split('_')[-1]}"
                    if unit != "bottleneck" else unit)
            name = f"{base}.{names[layer]}"
        arr = rng.randn(*value.shape).astype(np.float32) * 0.1
        if name.endswith("_up_sample") and leaf == "weight":
            arr = np.ascontiguousarray(arr.transpose(1, 0, 2, 3))
        sd[f"{name}.{'weight' if leaf == 'scale' else leaf}"] = \
            torch.from_numpy(arr)
    return sd


def _unet_import(use_analysis_track, batch_norm):
    """A reference-layout UNet / JNet state dict (the reference's names and
    torch's ConvTranspose2d layout, random values) through both packages'
    ``import_unet``: (kind, kwargs, shape, case, port tree, JAX tree)."""
    from cnn_autoencoder_tpu.utils.torch_import import \
        import_unet as jax_import_unet
    from cnn_autoencoder_tpu_torch.utils.torch_import import import_unet
    kind = "UNet" if use_analysis_track else "JNet"
    case = "unet" if use_analysis_track else "jnet_bridges"
    _, kwargs, shape = CASES[case]
    kwargs = dict(kwargs, batch_norm=batch_norm)
    sd = reference_unet_state_dict(_port(kind, kwargs, shape))
    level = kwargs["compression_level"]
    tree = import_unet(sd, compression_level=level,
                       use_analysis_track=use_analysis_track)
    ref_tree = jax_import_unet(sd, compression_level=level,
                               use_analysis_track=use_analysis_track)
    return kind, kwargs, shape, case, tree, ref_tree


@pytest.mark.parametrize("use_analysis_track", [True, False],
                         ids=["unet", "jnet"])
def test_unet_importer_matches_jax(use_analysis_track):
    """Without group norms: equal trees, and the port's head holding the
    imported weights gives the JAX head's output."""
    kind, kwargs, shape, case, tree, ref_tree = _unet_import(
        use_analysis_track, batch_norm=False)
    want, got = _flat(ref_tree), _flat(tree)
    assert set(got) == set(want)
    assert all(np.array_equal(got[k], want[k]) for k in want)
    x = np.random.RandomState(4).randn(*shape).astype(np.float32)
    bridges = _bridges(case, shape)
    ref, _, _ = _jax_apply(kind, kwargs, ref_tree, x, False, bridges)
    pred, _, _ = _forward(_port(kind, kwargs, shape, tree), x, False,
                          bridges)
    _close(pred, ref)


@pytest.mark.parametrize("use_analysis_track", [True, False],
                         ids=["unet", "jnet"])
def test_unet_importer_group_norms_fail_as_in_jax(use_analysis_track):
    """With group norms both importers nest each norm's scale and bias under
    ``GroupNorm_0`` (the classifiers' wrapper), where the segmenters keep
    them at ``bn1`` / ``bn2``: the trees are equal, flax cannot apply them
    and the port's head refuses them (a defect of the JAX package's
    importer, mirrored)."""
    kind, kwargs, shape, case, tree, ref_tree = _unet_import(
        use_analysis_track, batch_norm=True)
    want, got = _flat(ref_tree), _flat(tree)
    assert set(got) == set(want)
    assert any("GroupNorm_0" in k for k in want)
    x = np.random.RandomState(4).randn(*shape).astype(np.float32)
    with pytest.raises(Exception, match="scale"):
        _jax_apply(kind, kwargs, ref_tree, x, False, _bridges(case, shape))
    with pytest.raises(RuntimeError, match="GroupNorm_0"):
        _port(kind, kwargs, shape, tree)
