"""The CAE's architecture options in the port (plain versions, on the CPU)
against the JAX package: residual units, batch norm, dropout and grouped
convolutions through the tracks, the weight carrier, the train step, the
reference ``.pth`` import, serving and the train CLI.

Inputs are made from seeds with numpy at tiny sizes (16^2 or 32^2 images,
widths of at most 8).  Dropout's masks cannot be drawn alike in both
packages, so JAX's are captured (``flax.linen.intercept_methods`` around
``nn.Dropout``) or handed to it (``tests/test_torch_train_cli.py``), and
the port takes the same ones."""

import contextlib
import itertools
import os

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.errors import ModifyScopeVariableError

from cnn_autoencoder_tpu.criteria.loss import setup_loss as jax_setup_loss
from cnn_autoencoder_tpu.models.autoencoder import Analyzer as JaxAnalyzer
from cnn_autoencoder_tpu.models.autoencoder import \
    Synthesizer as JaxSynthesizer
from cnn_autoencoder_tpu.models.factory import build_model as jax_build_model
from cnn_autoencoder_tpu.models.factory import \
    autoencoder_from_state_dict as jax_from_state_dict
from cnn_autoencoder_tpu.ops import convops as jax_convops
from cnn_autoencoder_tpu.training.checkpoint import \
    save_checkpoint as jax_save_checkpoint
from cnn_autoencoder_tpu.training.loop import \
    make_train_step as jax_train_step
from cnn_autoencoder_tpu.training.optim import \
    setup_optimizers as jax_setup_optimizers
from cnn_autoencoder_tpu_torch.criteria.loss import setup_loss
from cnn_autoencoder_tpu_torch.models.autoencoder import (Analyzer,
                                                          Synthesizer)
from cnn_autoencoder_tpu_torch.models.factory import (
    CAEModel, autoencoder_from_state_dict, build_model)
from cnn_autoencoder_tpu_torch.ops.batchnorm import BatchNorm
from cnn_autoencoder_tpu_torch.ops.convops import (Conv2dReflect,
                                                   ConvTranspose2dTorch)
from cnn_autoencoder_tpu_torch.storage.turbo_codec import CAETurboCore
from cnn_autoencoder_tpu_torch.training.checkpoint import save_checkpoint
from cnn_autoencoder_tpu_torch.training.loop import (make_eval_step,
                                                     make_train_step)
from cnn_autoencoder_tpu_torch.training.optim import setup_optimizers
from cnn_autoencoder_tpu_torch.utils.weights import (_deconv,
                                                     state_from_jax,
                                                     state_to_jax)

from tests.test_torch_pth_import import _reference
from tests.test_torch_train_cli import (  # noqa: F401 (data: a fixture)
    _argv, _assert_trees, _dropout_masks, _port_masks, _run_jax, _run_port,
    _saved, data)
from tests.test_torch_turbo import _assert_u8_close, _image

ACTS = [None, "LeakyReLU", "ReLU", "GDN"]
TRAINABLE = ["encoder", "decoder", "fact_ent"]
LR = 1e-4


def _close(got, want, tol=1e-5):
    """Within ``tol`` relative, elementwise, plus ``tol`` of the tensor's
    scale (at least 1): IGDN stacks of random weights reach 1e3."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale)


def _perturb(tree, rng):
    """GDN, batch-norm parameters and statistics away from their initial
    values, so every term of the units counts."""
    def f(path, a):
        a, key = np.asarray(a), path[-1].key
        if key in ("beta", "gamma"):
            return a + 0.05 * rng.rand(*a.shape).astype(np.float32)
        if key == "scale":
            return (1 + 0.3 * rng.randn(*a.shape)).astype(np.float32)
        if key == "bias" and path[-2].key.startswith(("norm", "res_norm")):
            return (0.1 * rng.randn(*a.shape)).astype(np.float32)
        if key == "mean":
            return (0.3 * rng.randn(*a.shape)).astype(np.float32)
        if key == "var":
            return (0.5 + rng.rand(*a.shape)).astype(np.float32)
        return a
    return jax.tree_util.tree_map_with_path(f, tree)


def _tracks(cfg, x, seed=0):
    """JAX Analyzer and Synthesizer with perturbed variables, and the port's
    with the same weights: (j_enc, v_enc, j_dec, v_dec, t_enc, t_dec)."""
    rng = np.random.RandomState(seed)
    j_enc, j_dec = JaxAnalyzer(**cfg), JaxSynthesizer(**cfg)
    v_enc = _perturb(j_enc.init(jax.random.PRNGKey(seed), jnp.asarray(x)),
                     rng)
    y = j_enc.apply(v_enc, jnp.asarray(x))
    v_dec = _perturb(j_dec.init(jax.random.PRNGKey(seed + 1), y), rng)
    weights = state_from_jax({"encoder": v_enc, "decoder": v_dec}, cfg)
    t_enc, t_dec = Analyzer(**cfg), Synthesizer(**cfg)
    for prefix, mod in (("encoder.", t_enc), ("decoder.", t_dec)):
        mod.load_state_dict({k[len(prefix):]: v for k, v in weights.items()
                             if k.startswith(prefix)}, strict=True)
    return j_enc, v_enc, j_dec, v_dec, t_enc, t_dec


def _named_stats(track, stats):
    """A train-mode forward's recorded statistics as ``{unit: {norm:
    {"mean", "var"}}}`` (the JAX ``batch_stats`` tree)."""
    names = {m: n for n, m in track.named_modules()
             if isinstance(m, BatchNorm)}
    out = {}
    for mod, (mean, var) in stats.items():
        unit, layer = names[mod].split(".")
        out.setdefault(unit, {})[layer] = {"mean": mean.numpy(),
                                           "var": var.numpy()}
    return out


def _stats_close(got, want, tol=1e-5):
    want = jax.tree_util.tree_map(np.asarray, want)
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(want)
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        _close(a, b, tol)


@pytest.mark.parametrize(
    "residual,act,bn", list(itertools.product([False, True], ACTS,
                                              [False, True])),
    ids=lambda v: str(v))
def test_units_match_jax(residual, act, bn):
    """Plain and residual units x every activation x batch norm, through a
    two-stage Analyzer and Synthesizer: eval outputs within 1e-5, and in
    train mode the outputs and the batch norms' new running statistics
    within 1e-5."""
    cfg = dict(channels_org=3, channels_net=6, channels_bn=8,
               compression_level=2, act_layer_type=act,
               use_residual=residual, batch_norm=bn)
    x = np.random.RandomState(1).rand(2, 16, 16, 3).astype(np.float32)
    j_enc, v_enc, j_dec, v_dec, t_enc, t_dec = _tracks(cfg, x)
    y_j = j_enc.apply(v_enc, jnp.asarray(x))
    x_r_j = j_dec.apply(v_dec, y_j)[0][0]
    with torch.no_grad():
        _close(t_enc(torch.from_numpy(x)), y_j)
        _close(t_dec(torch.from_numpy(np.array(y_j)))[0][0], x_r_j)
        for j_mod, v, t_mod, inp in ((j_enc, v_enc, t_enc, x),
                                     (j_dec, v_dec, t_dec, np.array(y_j))):
            out_j, upd = j_mod.apply(v, jnp.asarray(inp), train=True,
                                     mutable=["batch_stats"])
            stats = {}
            out_t = t_mod(torch.from_numpy(inp), train=True,
                          batch_stats=stats)
            if isinstance(out_j, tuple):
                out_j, out_t = out_j[0][0], out_t[0][0]
            _close(out_t, out_j)
            if bn:
                _stats_close(_named_stats(t_mod, stats),
                             upd["batch_stats"])
            else:
                assert not stats and not upd


@contextlib.contextmanager
def _captured_dropout(masks):
    """Record each train-mode ``nn.Dropout`` call's keep-mask ((N, C)
    bool) in ``masks``: the interceptor draws flax's mask from the key the
    layer would draw (``make_rng``), then runs the layer on that key."""
    def interceptor(next_fun, args, kwargs, context):
        mod = context.module
        if (not isinstance(mod, nn.Dropout) or context.method_name
                != "__call__" or mod.deterministic):
            return next_fun(*args, **kwargs)
        rng = mod.make_rng(mod.rng_collection)
        shape = list(args[0].shape)
        for d in mod.broadcast_dims:
            shape[d] = 1
        keep = jax.random.bernoulli(rng, 1.0 - mod.rate, shape)
        masks.append(np.asarray(keep)[:, 0, 0, :])
        return next_fun(*args, rng=rng, **kwargs)

    with nn.intercept_methods(interceptor):
        yield


@pytest.mark.parametrize("residual,bn", [(False, False), (True, True)])
def test_dropout_with_jax_masks(residual, bn):
    """Train-mode dropout on every unit with the masks JAX drew: outputs
    within 1e-5 of JAX's; eval mode drops nothing; the port's own draw is a
    (N, C) keep-mask per unit."""
    cfg = dict(channels_org=3, channels_net=6, channels_bn=8,
               compression_level=2, act_layer_type="GDN",
               use_residual=residual, batch_norm=bn, dropout=0.4)
    x = np.random.RandomState(2).rand(3, 16, 16, 3).astype(np.float32)
    j_enc, v_enc, j_dec, v_dec, t_enc, t_dec = _tracks(cfg, x)
    key = jax.random.PRNGKey(7)
    for j_mod, v, t_mod, inp in ((j_enc, v_enc, t_enc, x),
                                 (j_dec, v_dec, t_dec, np.array(
                                     j_enc.apply(v_enc, jnp.asarray(x))))):
        masks = []
        with _captured_dropout(masks):
            out_j, _ = j_mod.apply(v, jnp.asarray(inp), train=True,
                                   mutable=["batch_stats"],
                                   rngs={"dropout": key})
        plain_j, _ = j_mod.apply(v, jnp.asarray(inp), train=True,
                                 mutable=["batch_stats"],
                                 rngs={"dropout": key})
        assert len(masks) == len(t_mod.names) == 2
        assert not all(m.all() for m in masks)
        t_masks = {n: torch.from_numpy(np.array(m))
                   for n, m in zip(t_mod.names, masks)}
        with torch.no_grad():
            out_t = t_mod(torch.from_numpy(inp), train=True, masks=t_masks,
                          batch_stats={})
            eval_t = t_mod(torch.from_numpy(inp))
        if isinstance(out_j, tuple):
            out_j, plain_j, out_t, eval_t = (out_j[0][0], plain_j[0][0],
                                             out_t[0][0], eval_t[0][0])
        np.testing.assert_array_equal(np.asarray(out_j), np.asarray(plain_j))
        _close(out_t, out_j)
        eval_j = j_mod.apply(v, jnp.asarray(inp))
        _close(eval_t, eval_j[0][0] if isinstance(eval_j, tuple) else eval_j)
        drawn = t_mod.draw_masks(3, torch.Generator().manual_seed(0))
        assert list(drawn) == t_mod.names and all(
            m.dtype == torch.bool and m.shape == (3, t_masks[n].shape[1])
            for n, m in drawn.items())
        with pytest.raises(ValueError, match="keep-mask"):
            t_mod(torch.from_numpy(inp), train=True, batch_stats={})


@pytest.mark.parametrize("residual,act,multiscale",
                         [(False, "GDN", False), (True, "GDN", True),
                          (False, "ReLU", True), (True, "LeakyReLU", False)])
def test_grouped_tracks_match_jax(residual, act, multiscale):
    """Grouped convolutions (each unit's as many groups as its input
    channels) at the widths the JAX package builds, 3/3/3: eval outputs and
    the color layers within 1e-5."""
    cfg = dict(channels_org=3, channels_net=3, channels_bn=3,
               compression_level=3, act_layer_type=act,
               use_residual=residual, groups=True)
    x = np.random.RandomState(3).rand(2, 32, 32, 3).astype(np.float32)
    rng = np.random.RandomState(0)
    j_enc = JaxAnalyzer(**cfg)
    j_dec = JaxSynthesizer(multiscale_analysis=multiscale, **cfg)
    v_enc = _perturb(j_enc.init(jax.random.PRNGKey(0), jnp.asarray(x)), rng)
    y_j = j_enc.apply(v_enc, jnp.asarray(x))
    v_dec = _perturb(j_dec.init(jax.random.PRNGKey(1), y_j), rng)
    weights = state_from_jax({"encoder": v_enc, "decoder": v_dec}, cfg)
    t_enc = Analyzer(**cfg)
    t_dec = Synthesizer(multiscale_analysis=multiscale, **cfg)
    for prefix, mod in (("encoder.", t_enc), ("decoder.", t_dec)):
        mod.load_state_dict({k[len(prefix):]: v for k, v in weights.items()
                             if k.startswith(prefix)}, strict=True)
    assert t_dec.up_0.deconv_up.weight.shape == (3, 1, 3, 3)
    x_r_j = j_dec.apply(v_dec, y_j)[0]
    with torch.no_grad():
        _close(t_enc(torch.from_numpy(x)), y_j)
        x_r_t = t_dec(torch.from_numpy(np.array(y_j)))[0]
    assert len(x_r_t) == len(x_r_j) == 3
    for got, want in zip(x_r_t, x_r_j):
        assert (got is None) == (want is None)
        if want is not None:
            _close(got, want)


@pytest.mark.parametrize("cin,cout,groups,stride", [(4, 6, 2, 2),
                                                    (6, 6, 3, 1),
                                                    (4, 8, 4, 2)])
def test_grouped_layers_match_jax(cin, cout, groups, stride):
    """A grouped conv and transposed conv against the JAX package's
    (``feature_group_count``) on one seeded input, forward and the input's
    gradient within 1e-5."""
    rng = np.random.RandomState(cin + cout)
    x = rng.randn(2, 9, 7, cin).astype(np.float32)
    g = rng.randn(2, 9 * stride, 7 * stride, cout).astype(np.float32)
    j_layer = jax_convops.ConvTranspose2dTorch(
        cout, 3, stride, 1, stride - 1, True, groups)
    v = j_layer.init(jax.random.PRNGKey(0), jnp.asarray(x))
    t_layer = ConvTranspose2dTorch(cin, cout, 3, stride, 1, stride - 1, True,
                                   groups)
    with torch.no_grad():
        t_layer.weight.copy_(torch.from_numpy(np.ascontiguousarray(_deconv(
            np.asarray(v["params"]["kernel"]), groups))))
        t_layer.bias.copy_(torch.from_numpy(np.asarray(v["params"]["bias"])))
    y_j, vjp = jax.vjp(lambda a: j_layer.apply(v, a), jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    y_t = t_layer(xt)
    (dx_t,) = torch.autograd.grad(y_t, xt, torch.from_numpy(g))
    _close(y_t.detach(), y_j)
    _close(dx_t, vjp(jnp.asarray(g))[0])

    j_conv = jax_convops.Conv2dReflect(cout, 3, stride, True, groups)
    v = j_conv.init(jax.random.PRNGKey(1), jnp.asarray(x))
    t_conv = Conv2dReflect(cin, cout, 3, stride, True, groups)
    with torch.no_grad():
        t_conv.weight.copy_(torch.from_numpy(np.transpose(
            np.asarray(v["params"]["kernel"]), (3, 2, 0, 1))))
        t_conv.bias.copy_(torch.from_numpy(np.array(
            v["params"]["bias"])))
        _close(t_conv(torch.from_numpy(x)), j_conv.apply(v, jnp.asarray(x)))


@pytest.mark.parametrize("layer,groups", [("conv", 1), ("conv", 2),
                                          ("deconv", 1), ("deconv", 2)])
def test_mixed_layers_match_jax_conv_mixed(layer, groups):
    """Float32 rows in the bf16 mode (a batch norm's output) through a
    conv (stride 2) or a transposed conv against the JAX layer with
    ``dtype=bfloat16`` (``conv_mixed``): the float32 output within 1e-5;
    the port's kernel gradient and transposed-conv dx bf16 values (the
    cotangent rounded to bf16, the results rounded to bf16, as
    ``conv_mixed``'s backward); dx, the kernel's and the bias's gradients
    within one bf16 ulp (2^-7 relative) plus half an ulp of their largest
    value (2^-8 of it): the conv's dx sums two bf16-rounded terms at the
    reflected border, and the JAX layer, a border-corrected conv in bf16,
    sums its dx and its kernel's gradient from several."""
    rng = np.random.RandomState(groups)
    x = rng.randn(2, 8, 6, 4).astype(np.float32)
    if layer == "conv":
        j_layer = jax_convops.Conv2dReflect(
            6, 3, 2, True, groups, dtype=jnp.bfloat16)
        t_layer = Conv2dReflect(4, 6, 3, 2, True, groups)
        to_port = lambda k: np.transpose(k, (3, 2, 0, 1))  # noqa: E731
    else:
        j_layer = jax_convops.ConvTranspose2dTorch(
            6, 3, 2, 1, 1, True, groups, dtype=jnp.bfloat16)
        t_layer = ConvTranspose2dTorch(4, 6, 3, 2, 1, 1, True, groups)
        to_port = lambda k: _deconv(k, groups)  # noqa: E731
    v = j_layer.init(jax.random.PRNGKey(groups), jnp.asarray(x))
    kernel = np.asarray(v["params"]["kernel"])
    with torch.no_grad():
        t_layer.weight.copy_(torch.from_numpy(np.ascontiguousarray(
            to_port(kernel))))
        t_layer.bias.copy_(torch.from_numpy(np.array(v["params"]["bias"])))
    y_j, vjp = jax.vjp(lambda p, a: j_layer.apply({"params": p}, a),
                       v["params"], jnp.asarray(x))
    g = rng.randn(*y_j.shape).astype(np.float32)
    dp_j, dx_j = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_(True)
    y_t = t_layer(xt, compute_dtype=torch.bfloat16)
    assert y_t.dtype == torch.float32
    dx_t, dw_t, db_t = torch.autograd.grad(
        y_t, (xt, t_layer.weight, t_layer.bias), torch.from_numpy(g))
    _close(y_t.detach(), y_j)
    dw_j = to_port(np.asarray(dp_j["kernel"]))
    for t in [dw_t] + [dx_t] * (layer == "deconv"):
        assert torch.equal(t, t.bfloat16().float())
    for got, want in ((dx_t, dx_j), (dw_t, dw_j), (db_t, dp_j["bias"])):
        want = np.asarray(want, np.float32)
        np.testing.assert_allclose(got.numpy(), want, rtol=2.0 ** -7,
                                   atol=2.0 ** -8 * float(np.abs(want).max()))


def test_grouped_synthesizer_raises_where_jax_does():
    """A grouped Synthesizer builds only when each stage's outputs are a
    multiple of its inputs: net 8 / bn 8 fails at up_1's 3 outputs in both
    packages (the JAX package on its first call, the port when built)."""
    cfg = dict(channels_org=3, channels_net=8, channels_bn=8,
               compression_level=2, act_layer_type="GDN", groups=True)
    with pytest.raises(ValueError, match="multiple of feature_group_count"):
        JaxSynthesizer(**cfg).init(jax.random.PRNGKey(0),
                                   jnp.zeros((1, 4, 4, 8)))
    with pytest.raises(ValueError, match="not a multiple of 8 groups"):
        Synthesizer(**cfg)
    Synthesizer(**dict(cfg, channels_net=3, channels_bn=3))


@pytest.mark.parametrize("residual,groups", [(False, True), (True, False)])
def test_weights_round_trip_with_batch_stats(residual, groups):
    """``state_from_jax`` then ``state_to_jax`` gives back the JAX package's
    variables array for array, ``batch_stats`` and grouped layouts
    included; batch norms start as flax starts them; a port checkpoint
    reads in the JAX package with the same variables."""
    width = 3 if groups else 6
    cfg = dict(channels_org=3, channels_net=width, channels_bn=width,
               compression_level=2, act_layer_type="ReLU",
               use_residual=residual, batch_norm=True, groups=groups, K=2,
               r=2)
    j_model = jax_build_model(jax.random.PRNGKey(0), input_size=(16, 16),
                              **cfg)
    variables = _perturb(j_model.variables, np.random.RandomState(4))
    weights = state_from_jax(variables, cfg)
    t_model = CAEModel(cfg)
    t_model.load_state_dict(weights, strict=True)
    back = state_to_jax(t_model.state_dict(), cfg)
    _assert_trees(back, jax.tree_util.tree_map(np.asarray, variables), 0)

    fresh = build_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    init = state_from_jax(j_model.variables, cfg)
    for k, v in fresh.state_dict().items():
        if ".norm" in k or ".res_norm" in k:
            assert torch.equal(v, init[k]), k


def test_build_and_serve_reference_pth(tmp_path):
    """A residual batch-norm reference ``.pth`` builds in the port and
    serves as the JAX package's import does: ``CAETurboCore`` on a model
    left in train mode takes the running statistics, so its symbols are
    the JAX model's ``round(encode(x) - medians)`` and its decodes the JAX
    decode of those symbols within the u8 tolerance, round trip lossless."""
    path = str(tmp_path / "ref.pth")
    torch.save(_reference("GDN", True, True, False, level=2, net=8,
                          bn_ch=16), path)
    t_model = autoencoder_from_state_dict(path, device="cpu").train()
    j_model = jax_from_state_dict(path)
    tiles = np.stack([_image(32, 32, seed) for seed in range(2)])
    tcore = CAETurboCore(t_model, num_streams=64, device="cpu")
    medians = tcore.base.medians
    y_j = np.asarray(j_model.encode(jnp.asarray(tiles / 255.0, jnp.float32)))
    sym = tcore.latent_symbols(tiles).numpy()
    np.testing.assert_array_equal(
        sym, np.round(y_j - medians).astype(np.int32).transpose(0, 3, 1, 2))
    frames = tcore.encode_tiles(tiles)
    np.testing.assert_array_equal(
        tcore.symbols_from_frames(frames, 64, 32, 32).numpy(), sym)
    x_r_j = np.asarray(j_model.decode(jnp.asarray(
        sym.transpose(0, 2, 3, 1) + medians, jnp.float32))[0][0])
    _assert_u8_close(tcore.decode_tiles(frames),
                     np.clip(x_r_j * 255.0, 0, 255).astype(np.uint8))


def _step_config(kind):
    """R: residual GDN units; B: plain GDN units with batch norm and
    dropout (the chip's phase 10 configurations at widths of 8)."""
    cfg = dict(channels_org=3, channels_net=8, channels_bn=8,
               compression_level=2, K=4, r=3, act_layer_type="GDN")
    if kind == "R":
        return dict(cfg, use_residual=True)
    return dict(cfg, batch_norm=True, dropout=0.25)


def _step_data(steps=2):
    rng = np.random.RandomState(0)
    xs = [np.clip(rng.rand(2, 16, 16, 3) * 0.7 + 0.15, 0, 1)
          .astype(np.float32) for _ in range(steps)]
    noises = [rng.uniform(-0.5, 0.5, (2, 4, 4, 8)).astype(np.float32)
              for _ in range(steps)]
    return xs, noises


def _step_masks(kind, steps, batch=2):
    """Per step, B's four dropout keep-masks ((batch, C) of down_0, down_1,
    up_0, up_1: the JAX call order); none for R."""
    if kind == "R":
        return [[] for _ in range(steps)]
    rng = np.random.RandomState(11)
    return [[rng.rand(batch, c) >= 0.25 for c in (8, 8, 8, 3)]
            for _ in range(steps)]


def _jax_steps(j_model, xs, noises, masks, monkeypatch, trainable=TRAINABLE,
               remat=False):
    """Losses per step and the final variables of the JAX
    ``make_train_step``, jitted again with the noise and the dropout masks
    as arguments (``tests/test_torch_train_cli.py:_run_jax``)."""
    criterion = jax_setup_loss("RateMSE", distortion_lambda=0.01)
    optimizers, opt_states, acc = jax_setup_optimizers(j_model.variables,
                                                       trainable)
    step_fn = jax_train_step(j_model.modules, criterion, optimizers,
                             trainable_modules=trainable, donate=False,
                             remat=remat).__wrapped__
    current = {}
    uniform = jax.random.uniform

    def fake_uniform(key, shape=(), dtype=jnp.float32, minval=0.0,
                     maxval=1.0):
        if tuple(shape) != current["noise"].shape:
            return uniform(key, shape, dtype, minval, maxval)
        return current["noise"].astype(dtype)

    def with_inputs(noise, step_masks, *args):
        current.update(noise=noise, masks=list(step_masks))
        with _dropout_masks(current):
            return step_fn(*args)

    step = jax.jit(with_inputs)
    lrs = {k: jnp.float32(LR) for k in optimizers}
    variables, losses = j_model.variables, []
    monkeypatch.setattr(jax.random, "uniform", fake_uniform)
    for i, (x, noise, m) in enumerate(zip(xs, noises, masks), start=1):
        variables, opt_states, acc, stats = step(
            jnp.asarray(noise), [jnp.asarray(a) for a in m], variables,
            opt_states, acc, lrs, jnp.asarray(x), None,
            jax.random.PRNGKey(i), jnp.int32(i))
        losses.append(float(stats["loss"]))
    monkeypatch.undo()
    return losses, variables


def _port_steps(t_model, xs, noises, masks, compute_dtype, remat=False):
    criterion = setup_loss("RateMSE", distortion_lambda=0.01)
    optimizers = setup_optimizers(t_model, TRAINABLE)
    step = make_train_step(t_model, criterion, optimizers,
                           trainable_modules=TRAINABLE,
                           compute_dtype=compute_dtype, remat=remat)
    losses = []
    for i, (x, noise, m) in enumerate(zip(xs, noises, masks), start=1):
        stats, _ = step(torch.from_numpy(x), {k: LR for k in optimizers}, i,
                        noise=torch.from_numpy(noise),
                        masks=_port_masks(t_model, m))
        losses.append(float(stats["loss"]))
    return losses


@pytest.mark.parametrize("kind,mode", [("R", "float32"), ("B", "float32"),
                                       ("R", "bf16"), ("B", "bf16")])
def test_train_steps_match_jax(kind, mode, monkeypatch):
    """Two steps of the whole train step against JAX ``make_train_step``
    (the same noise and dropout masks): losses within 1e-5 (bf16: 2e-2)
    and, for B, the running statistics after both steps as close; in bf16
    the GDN after each batch norm (float32 rows) takes ``gdn_mixed``."""
    cfg = _step_config(kind)
    tol = 1e-5 if mode == "float32" else 2e-2
    j_model = jax_build_model(jax.random.PRNGKey(0), input_size=(16, 16),
                              **cfg)
    t_model = CAEModel(cfg)
    t_model.load_state_dict(state_from_jax(j_model.variables, cfg))
    xs, noises = _step_data()
    masks = _step_masks(kind, len(xs))
    if mode == "bf16":
        jax_convops.set_default_precision("bf16")
    try:
        j_losses, j_vars = _jax_steps(j_model, xs, noises, masks,
                                      monkeypatch)
    finally:
        jax_convops.set_default_precision("highest")
    t_losses = _port_steps(t_model, xs, noises, masks,
                           torch.float32 if mode == "float32"
                           else torch.bfloat16)
    np.testing.assert_allclose(t_losses, j_losses, rtol=tol)
    if kind == "B":
        got = state_to_jax(t_model.state_dict(), t_model.config)
        for module in ("encoder", "decoder"):
            _stats_close(got[module]["batch_stats"],
                         j_vars[module]["batch_stats"], tol)
        assert float(t_model.encoder.down_0.norm_down.mean.abs().max()) > 0


def test_frozen_batch_norm_raises_in_both():
    """A batch-norm decoder that is not trainable cannot run in a train
    step: the JAX package raises ModifyScopeVariableError (its forward
    applies the frozen module without ``mutable``), the port ValueError;
    the eval step runs."""
    cfg = _step_config("B")
    trainable = ["encoder", "fact_ent"]
    j_model = jax_build_model(jax.random.PRNGKey(0), input_size=(16, 16),
                              **cfg)
    t_model = CAEModel(cfg)
    t_model.load_state_dict(state_from_jax(j_model.variables, cfg))
    xs, noises = _step_data(1)
    criterion = jax_setup_loss("RateMSE", distortion_lambda=0.01)
    optimizers, opt_states, acc = jax_setup_optimizers(j_model.variables,
                                                       trainable)
    step = jax_train_step(j_model.modules, criterion, optimizers,
                          trainable_modules=trainable, donate=False)
    with pytest.raises(ModifyScopeVariableError):
        step(j_model.variables, opt_states, acc,
             {k: jnp.float32(LR) for k in optimizers}, jnp.asarray(xs[0]),
             None, jax.random.PRNGKey(0), jnp.int32(1))
    t_crit = setup_loss("RateMSE", distortion_lambda=0.01)
    t_step = make_train_step(t_model, t_crit,
                             setup_optimizers(t_model, trainable),
                             trainable_modules=trainable)
    with pytest.raises(ValueError, match="ModifyScopeVariableError"):
        t_step(torch.from_numpy(xs[0]), {}, 1,
               noise=torch.from_numpy(noises[0]))
    stats = make_eval_step(t_model, t_crit)(torch.from_numpy(xs[0]))
    assert np.isfinite(float(stats["loss"]))


@pytest.fixture(scope="module")
def arch_checkpoints(tmp_path_factory):
    """JAX-written starting checkpoints of the R and B configurations at
    the train CLI test's widths (net 8, bn 8, 2 levels)."""
    out = {}
    for kind in ("R", "B"):
        m = jax_build_model(jax.random.PRNGKey(0), input_size=(32, 32),
                            **_step_config(kind))
        path = str(tmp_path_factory.mktemp(kind) / f"{kind}.msgpack")
        jax_save_checkpoint(path, {**m.config, **m.variables})
        out[kind] = path
    return out


CLI_FLAGS = {"R": ["-res"], "B": ["-bn", "-do", "0.25"]}


def _cli_noises(steps, batch=4):
    rng = np.random.RandomState(5)
    return [rng.uniform(-0.5, 0.5, (batch, 8, 8, 8)).astype(np.float32)
            for _ in range(steps)]


@pytest.mark.parametrize("kind", ["R", "B"])
def test_cli_matches_jax_and_resumes_across(data, arch_checkpoints, kind,
                                            tmp_path, monkeypatch):
    """``-res`` and ``-bn -do`` through both train CLIs from one JAX-written
    checkpoint, 2 steps with the same noise and masks: losses within 1e-5,
    ``last_`` checkpoints (variables with ``batch_stats``, optimizer slots
    with the batch norms' scale and bias) within 1e-4; then (B) each
    package resumes from the other's ``last_`` with the same losses."""
    flags = CLI_FLAGS[kind] + ["-chk", arch_checkpoints[kind], "-s", "1",
                               "-cs", "5"]
    noises, masks = _cli_noises(6), _step_masks(kind, 6, batch=4)
    for d in ("j", "t"):
        (tmp_path / d).mkdir()
    jl = _run_jax(_argv("zarr", data, tmp_path / "j", flags), noises,
                  monkeypatch, masks=masks)
    tl = _run_port(_argv("zarr", data, tmp_path / "t", flags), noises,
                   monkeypatch, masks=masks)
    assert len(jl) == len(tl) == 2
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    (jname, jstate), (tname, tstate) = (_saved(tmp_path / "j")["last"],
                                        _saved(tmp_path / "t")["last"])
    assert jname == tname
    keys = [k for k in jstate if k in ("encoder", "decoder", "fact_ent")
            or k.startswith("optimizer_")]
    assert ("batch_stats" in jstate["encoder"]) == (kind == "B")
    _assert_trees({k: tstate[k] for k in keys}, {k: jstate[k] for k in keys},
                  1e-4)
    if kind == "R":
        return
    assert "scale" in jstate["optimizer_encoder"]["1"]["mu"]["down_0"][
        "norm_down"]
    resumed = {}
    for d, src in (("jr", "t"), ("tr", "j")):
        (tmp_path / d).mkdir()
        last = os.path.join(tmp_path / src, _saved(tmp_path / src)["last"][0])
        argv = _argv("zarr", data, tmp_path / d,
                     flags + ["-chk", last, "-reso", "true"])
        run = _run_jax if d == "jr" else _run_port
        resumed[d] = run(argv, noises, monkeypatch, masks=masks)
    assert len(resumed["tr"]) == len(resumed["jr"]) == 2
    np.testing.assert_allclose(resumed["tr"], resumed["jr"], rtol=1e-5)


def test_save_checkpoint_reads_in_jax(tmp_path):
    """A batch-norm residual model's ``save_checkpoint`` file loads in the
    JAX package with the same variables, statistics included, and encodes
    as the port does."""
    cfg = dict(_step_config("B"), use_residual=True)
    model = build_model(cfg, torch.Generator().manual_seed(2), device="cpu")
    with torch.no_grad():
        for name, buf in model.named_buffers():
            buf.copy_(torch.rand(buf.shape) + (0.5 if "var" in name else 0))
    path = str(tmp_path / "bn.msgpack")
    save_checkpoint(path, model)
    j_model = jax_from_state_dict(path)
    want = state_to_jax(model.state_dict(), cfg)
    for module in ("encoder", "decoder"):
        _assert_trees(jax.tree_util.tree_map(
            np.asarray, dict(j_model.variables[module])), want[module], 0)
    x = np.random.RandomState(6).rand(2, 16, 16, 3).astype(np.float32)
    with torch.no_grad():
        _close(model.encoder(torch.from_numpy(x)),
               j_model.encode(jnp.asarray(x)))
