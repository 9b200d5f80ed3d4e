"""Training at the "default" and "high" precisions, and
``CAE_TPU_POLYPHASE_CONV=1`` in the bf16 mode, on the CPU.

JAX on the CPU computes its DEFAULT and HIGH convolutions in float32, so
each layer's gradient is held to a float64 evaluation of the rounded
arithmetic XLA's transpose rules compute on a TPU: at "default" dx from
bf16(g) and bf16(w) and dw from bf16(x) and bf16(g); at "high" each
transpose the bf16_3x product of the hi/lo parts of its two operands
(lo hi + hi lo + hi hi); float32 sums either way.  The tolerance is 1e-6 of
the largest reference value: the float32 sums here run over at most 240
terms, whose rounding grows about as sqrt(n) 2^-24, below 1e-6, while
"high"'s dropped lo lo term, up to 2^-18 of each product, and "default"'s
bf16 operands, 2^-9, put the full-float32 gradients (the control) farther
than that.  Whole steps and CLI runs are held to the JAX package's within
2e-2 (its CPU DEFAULT is float32); the polyphase conv to JAX run op by
op."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from cnn_autoencoder_tpu.criteria.loss import setup_loss as jax_setup_loss
from cnn_autoencoder_tpu.models import factory as jax_factory
from cnn_autoencoder_tpu.ops import convops as jc
from cnn_autoencoder_tpu.training.loop import \
    make_train_step as jax_train_step
from cnn_autoencoder_tpu.training.optim import \
    setup_optimizers as jax_setup_optimizers
from cnn_autoencoder_tpu_torch.models.factory import build_model
from cnn_autoencoder_tpu_torch.ops import convops as tc
from cnn_autoencoder_tpu_torch.ops.kernels import conv_gdn_kernel as cg
from cnn_autoencoder_tpu_torch.training.checkpoint import save_checkpoint
from cnn_autoencoder_tpu_torch.utils.weights import state_to_jax

from tests.test_torch_precision import _apply_bf16, _bf16, _conv_pair, _ulps
from tests.test_torch_train_cli import _argv
from tests.test_torch_train_cli import _noises as _cli_noises
from tests.test_torch_train_cli import _run_jax as _run_jax_cli
from tests.test_torch_train_cli import _run_port as _run_port_cli
from tests.test_torch_train_step import CONFIG, LR, _data, _run_port
from tests.test_zarr_training import _make_wsi

BF16 = torch.bfloat16
PRECISIONS = ("default", "high")
TOL = 1e-6
TRAINABLE = ["encoder", "decoder", "fact_ent"]


@pytest.fixture(autouse=True)
def _clean_switches(monkeypatch):
    for name in ("CAE_TPU_PALLAS", "CAE_TPU_PALLAS_INTERPRET",
                 "CAE_TPU_POLYPHASE_CONV", "CAE_TPU_NATIVE_CONV_OUT",
                 "CAE_TPU_BORDER_CONV", "CAE_TPU_GDN_FAST",
                 "CAE_TPU_FUSED_CONV"):
        monkeypatch.delenv(name, raising=False)
    yield
    jc.set_default_precision("highest")
    tc.set_default_precision("highest")


# -- the float64 references ---------------------------------------------------


def _split(t):
    hi = t.to(BF16).double()
    return hi, (t.double() - hi).to(BF16).double()


def _operands(a, b, precision):
    """The operand pairs whose products a transpose sums at
    ``precision``."""
    if precision == "default":
        return [(a.to(BF16).double(), b.to(BF16).double())]
    (ah, al), (bh, bl) = _split(a), _split(b)
    return [(al, bh), (ah, bl), (ah, bh)]


def _vjp(f, x, w, g, wrt):
    x = x.double().requires_grad_(wrt == 0)
    w = w.double().requires_grad_(wrt == 1)
    return torch.autograd.grad(f(x, w), (x, w)[wrt], g)[0]


def _ref_grads(f, x, w, g, precision):
    """dx and dw of the linear ``f(x, w)`` at the cotangent g, each
    transpose's products rounded as ``precision`` rounds them, in
    float64."""
    dx = sum(_vjp(f, x, wp, gp, 0) for gp, wp in _operands(g, w, precision))
    dw = sum(_vjp(f, xp, w, gp, 1) for xp, gp in _operands(x, g, precision))
    return dx, dw


def _reflect_conv(stride, groups):
    def f(a, w):  # NHWC, OIHW
        return F.conv2d(F.pad(a.permute(0, 3, 1, 2), (1,) * 4,
                              mode="reflect"), w, stride=stride,
                        groups=groups).permute(0, 2, 3, 1)
    return f


LAYERS = {
    "conv_s1": (1, 1), "conv_s2": (2, 1), "conv_grouped": (2, 4),
    "deconv_polyphase": {},
    "deconv_dilated": dict(kernel_size=5, stride=3, padding=2,
                           output_padding=1, groups=4),
}


def _layer(kind, rng):
    """(layer, float32 NHWC input, the layer's linear part in float64)."""
    if kind.startswith("conv"):
        stride, groups = LAYERS[kind]
        layer = tc.Conv2dReflect(12, 16, 3, stride, True, groups)
        x = rng.randn(2, 10, 12, 12)
        f = _reflect_conv(stride, groups)
    else:
        layer = tc.ConvTranspose2dTorch(12, 16, **LAYERS[kind])
        x = rng.randn(2, 5, 6, 12)
        geometry = dict(stride=layer.stride, padding=layer.padding,
                        output_padding=layer.output_padding,
                        groups=layer.groups)

        def f(a, w):
            return F.conv_transpose2d(a.permute(0, 3, 1, 2), w,
                                      **geometry).permute(0, 2, 3, 1)
    with torch.no_grad():
        layer.bias.copy_(torch.from_numpy(rng.randn(16).astype(np.float32)))
    return layer, torch.from_numpy(x.astype(np.float32)), f


def _grads(layer, x, g, precision):
    tc.set_default_precision(precision)
    try:
        xr = x.clone().requires_grad_()
        y = layer(xr)
        return torch.autograd.grad(y, (xr, layer.weight, layer.bias), g)
    finally:
        tc.set_default_precision("highest")


def _rel(a, ref):
    return float((a.double() - ref).abs().max()) / float(ref.abs().max())


# -- A1: each low-precision layer's backward ----------------------------------


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("kind", sorted(LAYERS))
def test_low_precision_vjp_matches_float64(kind, precision):
    """dx and dw of Conv2dReflect (stride 1, stride 2, grouped) and
    ConvTranspose2dTorch (the polyphase and the dilated form) at "default"
    and "high" against the float64 transposes of the rounded operands:
    within TOL of the largest value; the highest precision's gradients
    (full float32) farther than that.  The bias's gradient is the float32
    sum of g."""
    rng = np.random.RandomState(sorted(LAYERS).index(kind))
    layer, x, f = _layer(kind, rng)
    with torch.no_grad():
        shape = layer(x).shape
    g = torch.from_numpy(rng.randn(*shape).astype(np.float32))
    dx, dw, db = _grads(layer, x, g, precision)
    ctl_dx, ctl_dw, _ = _grads(layer, x, g, "highest")
    ref_dx, ref_dw = _ref_grads(f, x, layer.weight.detach(), g, precision)
    for name, got, ctl, ref in (("dx", dx, ctl_dx, ref_dx),
                                ("dw", dw, ctl_dw, ref_dw)):
        assert got.dtype == torch.float32 and got.shape == ref.shape, name
        assert _rel(got, ref) <= TOL, (name, _rel(got, ref))
        assert _rel(ctl, ref) > TOL, (name, _rel(ctl, ref))
    assert _rel(db, g.double().sum((0, 1, 2))) <= TOL


# -- A3: the fused stage's backward -------------------------------------------


def _fused_inputs(rng):
    x = rng.randn(2, 10, 12, 64)
    k = rng.randn(3, 3, 64, 40) * 0.05
    gamma = 0.1 * np.eye(40) + 0.01 * rng.rand(40, 40)
    beta = 1 + rng.rand(40)
    return [torch.from_numpy(a.astype(np.float32))
            for a in (x, k, gamma, beta)]


def _fused_grads(inputs, g, precision):
    """The fused stage's mode and gradients at ``precision``."""
    tc.set_default_precision(precision)
    try:
        leaves = [t.clone().requires_grad_() for t in inputs]
        out = cg.fused_conv_gdn(*leaves)
        return cg.conv_gdn_mode(torch.float32), torch.autograd.grad(
            out, leaves, g)
    finally:
        tc.set_default_precision("highest")


@pytest.mark.parametrize("pallas", [False, True], ids=["xla", "pallas"])
@pytest.mark.parametrize("precision", PRECISIONS)
def test_fused_stage_vjp_matches_float64(precision, pallas, monkeypatch):
    """The fused conv + GDN stage at "default" (mode 4) and "high" (mode
    5), and under CAE_TPU_PALLAS=1 (mode 0's HIGHEST forward, as the JAX
    Pallas kernel, with the backward still at the precision in force, as
    JAX's ``_fused_bwd`` transposes ``_reflect_conv`` at it): the GDN part
    (dy, dgamma, dbeta) within 1e-5 of a float64 GDN of the float64 conv of
    the mode's operands; dx and dkernel within TOL of the float64
    transposes, at the precision, of the dy the stage computed; the
    highest precision's dx and dkernel farther than that."""
    if pallas:
        monkeypatch.setenv("CAE_TPU_PALLAS", "1")
    rng = np.random.RandomState(40 + pallas)
    inputs = _fused_inputs(rng)
    x, k, gamma, beta = inputs
    g = torch.from_numpy(rng.randn(2, 5, 6, 40).astype(np.float32))
    dys, real = [], cg._reflect_conv_grads
    monkeypatch.setattr(cg, "_reflect_conv_grads", lambda x, k, dy, *rest: (
        dys.append(dy.detach().clone()) or real(x, k, dy, *rest)))
    mode, (dx, dk, dgamma, dbeta) = _fused_grads(inputs, g, precision)
    want = cg.F32 if pallas else {"default": cg.F32_BF16X1,
                                  "high": cg.F32_BF16X3}[precision]
    assert mode == want and len(dys) == 1
    _, (ctl_dx, ctl_dk, _, _) = _fused_grads(inputs, g, "highest")
    f = _reflect_conv(2, 1)
    w = k.permute(3, 2, 0, 1)
    if mode == cg.F32:
        y = f(x.double(), w.double())
    else:
        y = sum(f(a, b) for a, b in _operands(
            x, w, "default" if mode == cg.F32_BF16X1 else "high"))
    y = y.requires_grad_()
    g64, b64 = gamma.double().requires_grad_(), beta.double().requires_grad_()
    out = y * torch.rsqrt(torch.matmul(y * y, g64.t()) + b64)
    ref_dy, ref_dgamma, ref_dbeta = torch.autograd.grad(out, (y, g64, b64),
                                                        g.double())
    for name, got, ref in (("dy", dys[0], ref_dy),
                           ("dgamma", dgamma, ref_dgamma),
                           ("dbeta", dbeta, ref_dbeta)):
        assert _rel(got, ref) <= 1e-5, (name, _rel(got, ref))
    ref_dx, ref_dw = _ref_grads(f, x, w, dys[0], precision)
    ref_dk = ref_dw.permute(2, 3, 1, 0)
    for name, got, ctl, ref in (("dx", dx, ctl_dx, ref_dx),
                                ("dkernel", dk, ctl_dk, ref_dk)):
        assert _rel(got, ref) <= TOL, (name, _rel(got, ref))
        assert _rel(ctl, ref) > TOL, (name, _rel(ctl, ref))


# -- A4: whole steps and the train CLI ----------------------------------------


def _pair():
    """A port model of the flagship's geometry at test width (its second
    unit fused) and the JAX package's modules and variables of the same
    weights."""
    t_model = build_model(dict(CONFIG), torch.Generator().manual_seed(0),
                          device="cpu")
    variables = jax.tree_util.tree_map(
        jnp.asarray, state_to_jax(t_model.state_dict(), CONFIG))
    return t_model, jax_factory.setup_modules(**CONFIG), variables


_UNIFORM = jax.random.uniform


def _jax_losses(modules, variables, xs, noises, monkeypatch):
    """Per-step losses of the JAX package's ``make_train_step``, jitted
    again with the bottleneck's noise as an argument, which a patched
    ``jax.random.uniform`` hands to the bottleneck."""
    current = {}

    def uniform(key, shape=(), dtype=jnp.float32, minval=0.0, maxval=1.0):
        noise = current.get("noise")
        if noise is None or tuple(shape) != noise.shape:
            return _UNIFORM(key, shape, dtype, minval, maxval)
        return noise.astype(dtype)

    criterion = jax_setup_loss("RateMSE", distortion_lambda=0.01)
    optimizers, opt_states, acc = jax_setup_optimizers(variables, TRAINABLE)
    raw = jax_train_step(modules, criterion, optimizers,
                         trainable_modules=TRAINABLE,
                         donate=False).__wrapped__

    def with_noise(noise, *args):
        current["noise"] = noise
        try:
            return raw(*args)
        finally:
            current.pop("noise")

    step = jax.jit(with_noise)
    lrs = {k: jnp.float32(LR) for k in optimizers}
    losses = []
    with monkeypatch.context() as mp:
        mp.setattr(jax.random, "uniform", uniform)
        for i, (x, noise) in enumerate(zip(xs, noises), start=1):
            variables, opt_states, acc, stats = step(
                jnp.asarray(noise), variables, opt_states, acc, lrs,
                jnp.asarray(x), None, jax.random.PRNGKey(i), jnp.int32(i))
            losses.append(float(stats["loss"]))
    return losses


def _port_losses(t_model, xs, noises, compute_dtype):
    losses, grads = _run_port(t_model, TRAINABLE, xs, noises, compute_dtype)
    for m, gs in grads.items():
        for name, grad in gs.items():
            assert bool(torch.isfinite(grad).all()), (m, name)
    return losses


@pytest.mark.parametrize("precision", PRECISIONS)
def test_step_matches_jax(precision, monkeypatch):
    """``make_train_step`` at "default" and "high" (float32 activations,
    the fused stage in mode 4 or 5 with its backward at the precision),
    three steps against the JAX package's at the same precision from the
    same weights, batches and noise: losses within 2e-2 relative (JAX's
    CPU computes the precision in float32); every step-1 gradient
    finite."""
    xs, noises = _data()
    t_model, modules, variables = _pair()
    jc.set_default_precision(precision)
    j_losses = _jax_losses(modules, variables, xs, noises, monkeypatch)
    tc.set_default_precision(precision)
    t_losses = _port_losses(t_model, xs, noises, torch.float32)
    np.testing.assert_allclose(t_losses, j_losses, rtol=2e-2)


@pytest.fixture(scope="module")
def cli_data(tmp_path_factory):
    """Two train slides and a val slide as zarr stores, and a checkpoint of
    the CLI tests' widths written by the port."""
    root = tmp_path_factory.mktemp("precision_cli")
    wsis = root / "wsis"
    wsis.mkdir()
    for i in range(2):
        _make_wsi(str(wsis / f"train_{i}.zarr"), seed=i)
    _make_wsi(str(wsis / "val_0.zarr"), seed=9)
    config = dict(channels_org=3, channels_net=8, channels_bn=8,
                  compression_level=2, K=4, r=3, act_layer_type="GDN")
    model = build_model(config, torch.Generator().manual_seed(1),
                        device="cpu")
    chk = str(root / "m3.msgpack")
    save_checkpoint(chk, {**config, **state_to_jax(model.state_dict(),
                                                   config)})
    return {"zarr": (str(wsis), chk)}


def _loaded_as_saved(state, **_):
    """The JAX package's ``autoencoder_from_state_dict`` of a complete
    state, without the flax init whose values its loader overwrites (each
    of its primitives compiles on its own on the CPU, some 12 s)."""
    modules = jax_factory.setup_modules(**state)
    return jax_factory.CAEModel(
        modules=modules,
        variables={name: jax.tree_util.tree_map(jnp.asarray, state[name])
                   for name in modules},
        config={k: v for k, v in state.items()
                if not isinstance(v, dict) and k != "step"})


def test_train_cli_at_default_matches_jax(cli_data, tmp_path, monkeypatch):
    """The train CLI's ``main`` with ``set_default_precision("default")``
    in each package (``CAE_TPU_PRECISION=default``): three steps and a
    validation, losses within 2e-2 relative of the JAX CLI's."""
    noises = _cli_noises(4, 3)
    argv = ["-s", "2", "-cs", "5"]
    for d in ("j", "t"):
        (tmp_path / d).mkdir()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_factory, "autoencoder_from_state_dict",
                   _loaded_as_saved)
        for mod in (jc, tc):   # restored when the block ends
            for name in ("_DEFAULT_PRECISION", "_DEFAULT_COMPUTE_DTYPE"):
                if hasattr(mod, name):
                    mp.setattr(mod, name, getattr(mod, name))
            mod.set_default_precision("default")
        jl = _run_jax_cli(_argv("zarr", cli_data, tmp_path / "j", argv),
                          noises, monkeypatch)
        tl = _run_port_cli(_argv("zarr", cli_data, tmp_path / "t", argv),
                           noises, monkeypatch)
    assert len(jl) == len(tl) == 3
    np.testing.assert_allclose(tl, jl, rtol=2e-2)


# -- A5: CAE_TPU_POLYPHASE_CONV=1 in the bf16 mode ----------------------------


@pytest.mark.parametrize("native", ["1", "0"])
def test_polyphase_conv_matches_jax(native, monkeypatch):
    """A biased bf16 3x3 stride-2 Conv2dReflect under
    CAE_TPU_POLYPHASE_CONV=1 against the JAX layer under the switch, run
    op by op, at each CAE_TPU_NATIVE_CONV_OUT setting: at most one bf16
    ulp in under 0.1 % of the values, and with the conv's sums stored as
    bf16 not the border form's output (with float32 sums both round once,
    so they differ only where the sums' order moves a rounding); the fused
    stage runs unfused under the switch."""
    monkeypatch.setenv("CAE_TPU_NATIVE_CONV_OUT", native)
    rng = np.random.RandomState(17)
    jl, k, b, tl = _conv_pair(16, 24, 2, 5)
    x = torch.from_numpy(rng.randn(2, 10, 8, 16).astype(np.float32)).to(BF16)
    with torch.no_grad():
        border = tl(x)
    monkeypatch.setenv("CAE_TPU_POLYPHASE_CONV", "1")
    with jax.disable_jit():
        want = _bf16(_apply_bf16(jl, k, b, x))
    with torch.no_grad():
        got = tl(x)
    assert got.dtype == BF16 and got.shape == want.shape
    most, share = _ulps(got, want)
    assert most <= 1 and share < 1e-3, (most, share)
    assert native == "0" or not torch.equal(got, border)
    assert cg.conv_gdn_mode(BF16) is None
    assert cg.conv_gdn_mode(torch.float32, BF16) == cg.F32_BF16X1


def test_polyphase_bf16_step_matches_jax(monkeypatch):
    """A bf16 train step under CAE_TPU_POLYPHASE_CONV=1 (every stride-2
    conv in the polyphase form, the fused stage unfused: K2 and K3 on its
    GDN) against the JAX package's bf16 step under the switch: losses
    within 2e-2 relative (``tests/test_torch_train_step.py``'s bf16
    limit); every step-1 gradient finite."""
    monkeypatch.setenv("CAE_TPU_POLYPHASE_CONV", "1")
    xs, noises = _data()
    t_model, modules, variables = _pair()
    jc.set_default_precision("bf16")
    j_losses = _jax_losses(modules, variables, xs, noises, monkeypatch)
    jc.set_default_precision("highest")
    t_losses = _port_losses(t_model, xs, noises, BF16)
    np.testing.assert_allclose(t_losses, j_losses, rtol=2e-2)
