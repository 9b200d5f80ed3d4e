"""The tensor-core arithmetic of K1 and of K2 on float32 rows (one kernel,
``csrc/gdn_tc.cu``), on the CPU: the TF32 split of its operands
(``tf32_split``, emulated here bit for bit), why its pool takes three TF32
passes, and what K1's wrapper refuses.  The kernel itself runs only on the
card (``chip_smoke.py`` holds it against ``gdn_plain`` and
``gdn_train_fwd_plain`` there)."""

import os

import numpy as np
import pytest
import torch

from cnn_autoencoder_tpu_torch.models.factory import \
    autoencoder_from_state_dict
from cnn_autoencoder_tpu_torch.ops.kernels.gdn_kernel import (
    gdn_cuda, gdn_plain, gdn_train_fwd_plain)
from tests.test_torch_gdn_fwd_tc import _ulps

CHECKPOINT = os.path.join(os.path.dirname(__file__), "..", "benchmarks",
                          "bench_flagship.msgpack")
LOW13 = 0x1FFF


def split_tf32(t: torch.Tensor):
    """float32 ``t`` as ``hi + lo``, both TF32 values (low 13 mantissa bits
    clear), with the kernel's integer arithmetic: ``hi`` rounds ``t`` to
    nearest with ties away from zero (the rounding of ``cvt.rna.tf32.f32``),
    ``lo`` rounds ``t - hi`` the same way."""
    def rna(v):
        return ((v.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)
    t = t.float().contiguous()
    hi = rna(t)
    return hi, rna(t - hi)


def _rna_reference(t: np.ndarray) -> np.ndarray:
    """float32 -> TF32 by value in float64: the nearer of the two TF32
    neighbours of each t, the one of larger magnitude on a tie."""
    bits = t.view(np.uint32)
    down = (bits & ~np.uint32(LOW13)).view(np.float32).astype(np.float64)
    # the TF32 neighbour away from zero: one TF32 ulp further out
    up = ((bits & ~np.uint32(LOW13)) + np.uint32(0x2000)).view(np.float32)
    up = up.astype(np.float64)
    t64 = t.astype(np.float64)
    d_down, d_up = np.abs(t64 - down), np.abs(up - t64)
    return np.where(d_up <= d_down, up, down).astype(np.float32)


def _inputs(kind: str) -> np.ndarray:
    rng = np.random.RandomState(len(kind))
    if kind == "normal":
        return (rng.randn(4096) * 10.0 ** rng.uniform(-30, 30, 4096)
                ).astype(np.float32)
    if kind == "subnormal":
        return rng.randint(1, 1 << 23, 2048).astype(np.uint32).view(
            np.float32) * np.float32(rng.choice([-1, 1], 2048))
    if kind == "large":
        return (rng.choice([-1, 1], 2048) * rng.uniform(1e37, 3.3e38, 2048)
                ).astype(np.float32)
    if kind == "zero":
        return np.array([0.0, -0.0, 1.0, -1.0], np.float32)
    # ties: the dropped 13 bits are exactly half a TF32 ulp
    bits = (rng.randint(0x00800000, 0x7E000000, 2048).astype(np.uint32)
            & ~np.uint32(LOW13)) | np.uint32(0x1000)
    signs = rng.choice([0, 1], 2048).astype(np.uint32) << np.uint32(31)
    return (bits | signs).view(np.float32)


@pytest.mark.parametrize("kind", ["normal", "subnormal", "large", "zero",
                                  "tie"])
def test_split_tf32(kind):
    t = _inputs(kind)
    hi, lo = (v.numpy() for v in split_tf32(torch.from_numpy(t)))
    for part in (hi, lo):
        assert not np.any(part.view(np.uint32) & np.uint32(LOW13))
    np.testing.assert_array_equal(hi.view(np.uint32),
                                  _rna_reference(t).view(np.uint32))
    np.testing.assert_array_equal(
        lo.view(np.uint32),
        _rna_reference((t - hi).astype(np.float32)).view(np.uint32))
    if kind == "tie":  # ties go away from zero
        assert np.all(np.abs(hi) > np.abs(t))
    err = np.abs(hi.astype(np.float64) + lo - t)
    # 2^-22 relative for |t| >= 2^-115; below, hi or lo may fall among the
    # subnormals, whose TF32 values step by 2^-136: at most half of that
    tiny = np.abs(t) < 2.0 ** -115
    assert np.all(err[~tiny] <= 2.0 ** -22 * np.abs(t[~tiny]))
    assert np.all(err[tiny] <= 2.0 ** -137)


def _tf32_pool(x2, gamma, passes):
    """beta-less pool x^2 gamma^T in float64 from TF32 parts of x^2 and
    gamma: three passes (lo hi + hi lo + hi hi) or one (hi hi)."""
    a_hi, a_lo = (v.double() for v in split_tf32(x2))
    b_hi, b_lo = (v.double().t() for v in split_tf32(gamma))
    pool = a_hi @ b_hi
    if passes == 3:
        pool = a_lo @ b_hi + a_hi @ b_lo + pool
    return pool


def _k2_epilogue(norm64, x, inverse):
    """K2's epilogue on float32 rows from a float64 pool: the norm rounded
    to float32, its correctly rounded square root, the reciprocal of that
    (GDN), y = x r in float32 and rb = bf16(r), rounded to nearest even."""
    s = norm64.float().sqrt()
    r = s if inverse else 1.0 / s
    return x * r, r.to(torch.bfloat16)


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("kernel", ["K1", "K2"])
def test_three_tf32_passes_hold_float32(kernel, inverse):
    """On the flagship's GDN parameters (C = 128) and its activation scale,
    the three-pass pool stays within 1e-6 of gdn_plain (K1); with K2's
    epilogue, y stays within K1's 3e-6 of the float64 GDN and rb within one
    bf16 ulp of gdn_train_fwd_plain's.  One pass exceeds the port's 1e-5
    limit."""
    model = autoencoder_from_state_dict(CHECKPOINT, device="cpu")
    unit = model.decoder.up_1.gdn_up if inverse else \
        model.encoder.down_0.gdn_down
    with torch.no_grad():
        gamma, beta = (v.detach() for v in unit.effective_params())
    x = torch.from_numpy(np.random.RandomState(3).randn(4096, 128)
                         .astype(np.float32) * 0.5)
    x64 = x.double()
    if kernel == "K1":
        ref = gdn_plain(x, gamma, beta, inverse).double()
    else:  # the GDN in float64
        norm = (x64 * x64) @ gamma.double().t() + beta.double()
        ref = x64 * (norm.sqrt() if inverse else norm.rsqrt())
        _, rb_plain = gdn_train_fwd_plain(x, gamma, beta, inverse)
    for passes, ok in ((3, 1e-6 if kernel == "K1" else 3e-6), (1, None)):
        norm = _tf32_pool(x * x, gamma, passes) + beta.double()
        if kernel == "K1":
            y = x64 * (norm.sqrt() if inverse else norm.rsqrt())
        else:
            y, rb = _k2_epilogue(norm, x, inverse)
            y = y.double()
        rel = float(((y - ref).abs() / ref.abs().clamp_min(1e-30)).max())
        if ok is None:
            assert rel > 1e-5, rel
            continue
        assert rel <= ok, rel
        if kernel == "K2":
            assert _ulps(rb, rb_plain) <= 1


@pytest.mark.parametrize("case", ["cpu", "bf16", "float16", "strided",
                                  "gamma"])
def test_gdn_cuda_refuses(case):
    """The K1 wrapper raises ValueError on what it does not take, before it
    needs a card: CPU rows (float32, and bf16, which it takes on the card),
    rows of another type, non-contiguous rows, a gamma that does not match
    C."""
    c = 8
    dtype = {"bf16": torch.bfloat16, "float16": torch.float16}.get(
        case, torch.float32)
    x = torch.ones((4, c), dtype=dtype)
    if case == "strided":
        x = torch.ones((c, 4)).t()
    gamma, beta = torch.zeros((c, c + (case == "gamma"))), torch.ones(c)
    match = {"cpu": "CUDA tensors", "bf16": "CUDA tensors",
             "float16": "rows of", "strided": "contiguous",
             "gamma": "do not match"}[case]
    with pytest.raises(ValueError, match=match):
        gdn_cuda(x, gamma, beta)

