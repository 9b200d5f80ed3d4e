"""K4 (fused reflect-pad + 3x3/s2 conv + GDN) past 128 output channels, on
the CPU: the port's plain versions against the JAX package's Pallas kernel
(interpret mode) at Cout 129 and 192 and a ragged Cin, the fused route
through a 192-channel encoder against the JAX model, and a float64
emulation of the kernel's TF32 arithmetic at K = 9 * 128.  The kernel
itself runs only on the card (``chip_smoke.py`` holds it against
``conv_gdn_plain`` there, Cout up to 1024 included)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cnn_autoencoder_tpu.models.autoencoder import Analyzer as JaxAnalyzer
from cnn_autoencoder_tpu.ops import convops as jax_convops
from cnn_autoencoder_tpu.ops.pallas import conv_gdn_kernel as jax_cg
from cnn_autoencoder_tpu_torch.models.autoencoder import Analyzer
from cnn_autoencoder_tpu_torch.models.factory import \
    autoencoder_from_state_dict
from cnn_autoencoder_tpu_torch.ops.kernels.conv_gdn_kernel import (
    conv_gdn_cuda, conv_gdn_plain, conv_gdn_train_plain)
from cnn_autoencoder_tpu_torch.utils.weights import state_from_jax

BF16 = torch.bfloat16
CHECKPOINT = os.path.join(os.path.dirname(__file__), "..", "benchmarks",
                          "bench_flagship.msgpack")


def _case(cout, cin=72, seed=0):
    rng = np.random.RandomState(seed + cout)
    x = rng.rand(2, 8, 10, cin).astype(np.float32)
    k = (rng.randn(3, 3, cin, cout) * 0.05).astype(np.float32)
    gamma = (rng.rand(cout, cout) * 0.02).astype(np.float32)
    beta = (rng.rand(cout) + 0.5).astype(np.float32)
    return x, k, gamma, beta


def _ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    return int((a.view(torch.int16).int() - b.view(torch.int16).int())
               .abs().max())


@pytest.mark.parametrize("cout", [129, 192])
def test_serving_plain_matches_pallas(cout):
    """conv_gdn_plain at Cout > 128 and Cin = 72 against the Pallas kernel,
    which pads both to multiples of 128 (float32, the tolerance of
    tests/test_torch_gdn.py's 128-channel case)."""
    args = _case(cout)
    ref = np.asarray(jax_cg._fused_conv_gdn_pallas(
        *[jnp.asarray(a) for a in args], interpret=True))
    got = conv_gdn_plain(*[torch.from_numpy(a) for a in args]).numpy()
    assert got.shape == (2, 4, 5, cout)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("cout", [129, 192])
@pytest.mark.parametrize("mode", ["float32", "bf16"])
def test_want_y_plain_matches_pallas(cout, mode, monkeypatch):
    """conv_gdn_train_plain (out and the float32 pre-GDN y) at Cout > 128
    against the Pallas kernel with want_y, in float32 and under
    set_default_precision("bf16") with CAE_TPU_PALLAS=1 (the Pallas
    function), with x holding bf16 values so both packages multiply the
    same numbers: y to 1e-5 of max |y|, out to 1e-5 of max |out| (float32)
    or one bf16 ulp (the tolerances of tests/test_torch_train_kernels.py at
    48 channels)."""
    x, k, gamma, beta = _case(cout, seed=1)
    x = torch.from_numpy(x).to(BF16).float().numpy()
    if mode == "bf16":
        monkeypatch.setenv("CAE_TPU_PALLAS", "1")
        jax_convops.set_default_precision("bf16")
    try:
        out_j, y_j = jax_cg._fused_conv_gdn_pallas(
            *[jnp.asarray(a) for a in (x, k, gamma, beta)], interpret=True,
            want_y=True)
    finally:
        jax_convops.set_default_precision("highest")
    x_t = torch.from_numpy(x).to(BF16 if mode == "bf16" else torch.float32)
    out_t, y_t, r_t = conv_gdn_train_plain(x_t, torch.from_numpy(k),
                                           torch.from_numpy(gamma),
                                           torch.from_numpy(beta))
    assert y_t.dtype == torch.float32 and out_t.dtype == x_t.dtype
    assert r_t is None
    assert out_t.shape == (2, 4, 5, cout)
    y_j, out_j = np.asarray(y_j), np.asarray(out_j)
    np.testing.assert_allclose(y_t.numpy(), y_j, rtol=0,
                               atol=1e-5 * np.abs(y_j).max())
    if mode == "bf16":
        assert _ulps(out_t, torch.from_numpy(out_j.copy()).to(BF16)) <= 1
    else:
        np.testing.assert_allclose(out_t.numpy(), out_j, rtol=0,
                                   atol=1e-5 * np.abs(out_j).max())


def test_wide_encoder_matches_jax(monkeypatch):
    """The fused route at Cout = 192 through the model: a channels_net =
    192 encoder (its down_1 is 192 -> 192 conv + GDN, fused in both
    packages; the JAX one runs its Pallas kernel in interpret mode) with
    the JAX model's weights carried by state_from_jax.  The latent to the
    test_rd_parity tolerance (1e-4), and the gradient of one scalar loss
    for every parameter to 1e-4 of its largest entry."""
    monkeypatch.setenv("CAE_TPU_PALLAS_INTERPRET", "1")
    kw = dict(channels_org=3, channels_net=192, channels_bn=16,
              compression_level=3, act_layer_type="GDN")
    j_enc = JaxAnalyzer(**kw)
    rng = np.random.RandomState(4)
    x = rng.rand(1, 16, 16, 3).astype(np.float32)
    v_enc = j_enc.init(jax.random.PRNGKey(6), jnp.asarray(x))

    # non-trivial GDN parameters: perturb every beta / gamma
    def perturb(path, a):
        a = np.asarray(a)
        if path[-1].key in ("beta", "gamma"):
            return a + 0.05 * rng.rand(*a.shape).astype(np.float32)
        return a
    v_enc = jax.tree_util.tree_map_with_path(perturb, v_enc)
    cot = rng.randn(1, 2, 2, 16).astype(np.float32)

    def loss_j(v):
        return jnp.vdot(j_enc.apply(v, jnp.asarray(x)), cot)
    y_j = np.asarray(j_enc.apply(v_enc, jnp.asarray(x)))
    g_j = state_from_jax({"encoder": jax.grad(loss_j)(v_enc)},
                         {"compression_level": 3})

    t_enc = Analyzer(**kw)
    assert [getattr(t_enc, n).fused for n in t_enc.names] == [False, True,
                                                               False]
    weights = state_from_jax({"encoder": v_enc}, {"compression_level": 3})
    t_enc.load_state_dict({k[len("encoder."):]: v
                           for k, v in weights.items()}, strict=True)
    y_t = t_enc(torch.from_numpy(x))
    np.testing.assert_allclose(y_t.detach().numpy(), y_j, rtol=1e-4,
                               atol=1e-4)
    (y_t * torch.from_numpy(cot)).sum().backward()
    for name, p in t_enc.named_parameters():
        ref = g_j["encoder." + name].numpy()
        err = np.abs(p.grad.numpy() - ref).max()
        assert err <= 1e-4 * np.abs(ref).max(), (name, err)


def _rna(v: np.ndarray) -> np.ndarray:
    """float32 -> TF32, to nearest, ties away from zero (the kernel's
    tf32_rna, bit for bit)."""
    bits = np.ascontiguousarray(v, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def _split(v: np.ndarray):
    """v as hi + lo, both TF32 (the kernel's tf32_split), in float64."""
    v = np.asarray(v, np.float32)
    hi = _rna(v)
    return hi.astype(np.float64), _rna(v - hi).astype(np.float64)


def _tf32_product(a: np.ndarray, b: np.ndarray, passes: int) -> np.ndarray:
    """a @ b (float32 operands) as the kernel computes it, in float64: each
    8-deep k-step sums lo hi + hi lo + hi hi (three passes) or hi hi (one)
    into its own part, added to the accumulator after it."""
    a_hi, a_lo = _split(a)
    b_hi, b_lo = _split(b)
    acc = np.zeros((a.shape[0], b.shape[1]))
    for k0 in range(0, a.shape[1], 8):
        s = slice(k0, k0 + 8)
        part = a_hi[:, s] @ b_hi[s]
        if passes == 3:
            part = a_lo[:, s] @ b_hi[s] + a_hi[:, s] @ b_lo[s] + part
        acc += part
    return acc


@pytest.mark.parametrize("passes", [3, 1])
def test_tf32_passes_at_k1152(passes):
    """The flagship's down_1 (Cin = Cout = 128, so K = 9 * 128 = 1152) on
    uniform x as chip_smoke.py feeds it: the kernel's arithmetic, emulated
    in float64 (the conv's products and the pool's, both split), against
    the float64 function.  Three passes stay within 1e-6 of max |y| and
    max |out|, far inside the card's limit of 1e-4 of each; one pass
    breaks that limit."""
    model = autoencoder_from_state_dict(CHECKPOINT, device="cpu")
    unit = model.encoder.down_1
    with torch.no_grad():
        w = unit.conv_down.kernel_hwio().numpy()
        gamma, beta = (v.numpy().astype(np.float64)
                       for v in unit.gdn_down.effective_params())
    x = np.random.RandomState(0).rand(2, 16, 16, 128).astype(np.float32)
    xp = np.pad(x, ((0, 0), (1, 1), (1, 1), (0, 0)), mode="reflect")
    # rows are output pixels, K runs tap by tap as the kernel's slices do
    a = np.stack([xp[:, dy:dy + 16:2, dx:dx + 16:2]
                  for dy in range(3) for dx in range(3)], axis=3)
    a = a.reshape(-1, 9 * 128)
    b = w.reshape(9 * 128, 128)

    def gdn(y, pool):
        return y / np.sqrt(pool + beta)

    y_ref = a.astype(np.float64) @ b.astype(np.float64)
    out_ref = gdn(y_ref, (y_ref * y_ref) @ gamma.T)
    y = _tf32_product(a, b, passes).astype(np.float32)
    y2 = (y * y).astype(np.float32)
    out = gdn(y.astype(np.float64),
              _tf32_product(y2, gamma.T.astype(np.float32), passes))
    y_err = np.abs(y - y_ref).max() / np.abs(y_ref).max()
    out_err = np.abs(out - out_ref).max() / np.abs(out_ref).max()
    if passes == 3:
        assert y_err <= 1e-6 and out_err <= 1e-6, (y_err, out_err)
    else:
        assert max(y_err, out_err) > 1e-4, (y_err, out_err)


@pytest.mark.parametrize("case", ["cpu", "odd", "dtype", "kernel", "gamma"])
def test_conv_gdn_cuda_refuses(case):
    """The K4 wrapper raises ValueError on what the kernel does not take,
    before it needs a card: CPU tensors, odd H, a type other than float32
    and bf16, a kernel or gamma that does not match x and Cout.  It takes
    any Cout (a 192-channel kernel on CPU tensors fails on the device
    alone)."""
    shape = (1, 5 if case == "odd" else 4, 4, 8)
    x = torch.zeros(shape, dtype=torch.float64 if case == "dtype"
                    else torch.float32)
    cout = 192
    kernel = torch.zeros((3, 3, 9 if case == "kernel" else 8, cout))
    gamma = torch.zeros((cout, cout + (case == "gamma")))
    beta = torch.ones(cout)
    match = {"cpu": "CUDA tensors", "odd": "even H", "dtype": "float32 or",
             "kernel": "kernel takes a", "gamma": "do not match"}[case]
    with pytest.raises(ValueError, match=match):
        conv_gdn_cuda(x, kernel, gamma, beta)
