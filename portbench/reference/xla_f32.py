"""The JAX codec's float32 table-baking arithmetic, reproduced bit for bit.

A frozen copy, for the reference, of ``cnn_autoencoder_tpu_torch/coding/
xla_f32.py``: the tables of cae_tpu frames are defined by this arithmetic,
so a decoder of the frames has to bake them with it.

The JAX package bakes its rANS tables from ``logits_cumulative`` run
eagerly by XLA's CPU backend in float32, then applies the logistic in
float32 numpy (``coding/device_rans.py:bake_device_tables`` there).  A
table entry moves when a pmf lies near a quantization boundary, so a
float64 chain, or torch's or libm's float32 functions, give other tables
on some checkpoints, and frames of such a checkpoint would not decode in
the other package.  This module computes what those two libraries
compute, from float32 numpy arithmetic (``+ - * /``, each one IEEE
rounding), comparisons and bit operations alone: it calls no float32
transcendental of numpy, torch or libm, so its result does not depend on
the host it runs on.

Each piece was identified by reading the LLVM IR and the object code that
XLA dumps for the eager ops (``XLA_FLAGS=--xla_dump_to=...``) and then
holding this copy bit-equal to ``jnp`` / ``np`` over hundreds of
thousands of seeded values (``tests/test_torch_cdf_tables.py``):

* **Fused multiply-add.**  XLA's CPU code contracts a multiply whose only
  use is an add or a subtract into one ``vfmadd`` (one rounding).  numpy
  has no FMA, so :func:`fma` computes it exactly: the product of two
  float32 values is exact in float64; the sum with the third operand is
  taken with TwoSum, and the float64 result is rounded to odd (its last
  bit set when the sum was inexact) before the one rounding to float32,
  which makes the double rounding equal to a single one.
* **Denormals.**  XLA's CPU computations run with flush-to-zero and
  denormals-are-zero: a subnormal operand or result of an arithmetic op is
  a signed zero (``_flush``).  numpy's own arithmetic does not flush.
* **tanh** (Eigen's ``ptanh_float``): the input clamped to
  ±7.99881172180175781; ``x`` itself where ``|x| < 0.0004`` and ±1 where
  ``|x| >= 20``; else ``x·P(x²) / Q(x²)``, both polynomials by Horner
  steps that are FMAs, ``x²`` and ``x·P`` plain products, one division.
* **exp** (Cephes ``expf``, XLA's polynomial): the input clamped to
  [-87.8, 88.8]; ``n = floor(x·log2(e) + 0.5)`` (FMA) clamped to
  [-127, 127]; ``r = x - n·0.693359375 - n·(-2.12194440e-4)`` (two FMAs);
  a degree-5 Horner polynomial (FMAs); ``y = fma(p, r·r, r) + 1``; the
  result ``y · 2^n`` with ``2^n`` made from its bits (``2^-127`` is 0).
* **log1p** (XLA's): where ``|x| < 0.41421356`` a rational
  ``x + fma(x², -0.5, x³·(B(x) / A(x)))`` with degree-6 Horner
  polynomials (FMAs); else Cephes ``logf(1 + x)``: mantissa in
  [sqrt(1/2), sqrt(2)) by bit operations, three degree-2 polynomials in
  ``x`` joined by FMAs in ``x³``, ``fma(-x², 0.5, x)``, and the exponent
  term added last by an FMA with ``0.693359375``.
* **softplus** (``jax.nn.softplus`` = ``logaddexp(x, 0)``, one XLA
  fusion): ``max(x, 0) + log1p(exp(-|x|))``, NaN passed through.
* **The einsum** ``cof,...cf->...co`` over f_in = 3 is a batched dot that
  XLA hands to Eigen: ``x0·m0`` rounded, then ``fma(x1, m1, ·)`` and
  ``fma(x2, m2, ·)`` in filter order.  Over f_in = 1 it is one product.
  Every other op of the chain (``+ b``, ``f·tanh(x)``, ``x + ·``) is its
  own eager XLA op: one rounding each, nothing fused across them.
* **The logistic** of the reference runs in numpy, whose float32 ``exp``
  on x86 hosts with AVX2 or AVX512F is its own SIMD routine, not libm's
  and not correctly rounded: Cody-Waite reduction by
  ``q = rint(x·log2(e))`` (the rounding by adding and subtracting
  1.5·2^23), ``r = fma(q, c1, x)`` then ``fma(q, c2, r)``, a degree-5
  over degree-2 rational in ``r`` by FMA Horner steps, one division, then
  scaling by ``2^q``; 0 at or below -103.972084, inf at or above
  88.722839.  That is the routine of the host the JAX package was checked
  on (x86-64 with AVX512F, numpy 2.0).
"""

from typing import Dict

import numpy as np

_F32 = np.float32
_TINY = _F32(2.0 ** -126)


def _f(bits: int) -> np.float32:
    """The float32 whose bits are ``bits``."""
    return np.array(bits, np.uint32).view(np.float32)[()]


def _flush(a):
    """XLA's flush-to-zero / denormals-are-zero: subnormals become ±0."""
    a = np.asarray(a, np.float32)
    return np.where(np.abs(a) < _TINY, np.copysign(_F32(0), a),
                    a).astype(np.float32)


def _fma_exact(a, b, c) -> np.ndarray:
    """round_float32(a·b + c) with one rounding, for float32 a, b, c."""
    p = (np.asarray(a, np.float32).astype(np.float64)
         * np.asarray(b, np.float32).astype(np.float64))   # exact
    c64 = np.asarray(c, np.float32).astype(np.float64)
    with np.errstate(invalid="ignore", over="ignore"):
        s = p + c64
        bv = s - p
        err = (p - (s - bv)) + (c64 - bv)                   # TwoSum: s + err
    bits = s.view(np.uint64)
    # round to odd: an inexact sum with an even last bit moves one float64
    # ulp toward the exact value, so the float32 rounding below is single
    inexact = np.isfinite(s) & (err != 0) & ((bits & np.uint64(1)) == 0)
    away = (err > 0) == (s > 0)
    bits = np.where(inexact, np.where(away, bits + np.uint64(1),
                                      bits - np.uint64(1)), bits)
    return bits.view(np.float64).astype(np.float32)


def fma(a, b, c) -> np.ndarray:
    """XLA's fused multiply-add: one rounding, denormals flushed."""
    return _flush(_fma_exact(_flush(a), _flush(b), _flush(c)))


def _mul(a, b):
    with np.errstate(over="ignore", invalid="ignore"):
        return _flush(_flush(a) * _flush(b))


def _add(a, b):
    with np.errstate(over="ignore", invalid="ignore"):
        return _flush(_flush(a) + _flush(b))


def _div(a, b):
    with np.errstate(divide="ignore", invalid="ignore"):
        return _flush(_flush(a) / _flush(b))


# Eigen's ptanh_float: numerator x·P(x²), denominator Q(x²), highest first
_TANH_CLAMP = _F32(7.99881172180175781)
_TANH_P = [_F32(v) for v in (-2.76076847742355e-16, 2.00018790482477e-13,
                             -8.60467152213735e-11, 5.12229709037114e-08,
                             1.48572235717979e-05, 6.37261928875436e-04,
                             4.89352455891786e-03)]
_TANH_Q = [_F32(v) for v in (1.19825839466702e-06, 1.18534705686654e-04,
                             2.26843463243900e-03, 4.89352518554385e-03)]


def _horner(x, coeffs):
    """coeffs[0]·x^n + … + coeffs[n] by FMA steps."""
    acc = fma(x, coeffs[0], coeffs[1])
    for k in coeffs[2:]:
        acc = fma(acc, x, k)
    return acc


def tanh(x) -> np.ndarray:
    """``jnp.tanh`` on float32, as XLA's CPU backend computes it."""
    x = np.asarray(x, np.float32)
    xc = np.clip(x, -_TANH_CLAMP, _TANH_CLAMP)
    x2 = _mul(xc, xc)
    r = _div(_mul(xc, _horner(x2, _TANH_P)), _horner(x2, _TANH_Q))
    r = np.where(np.abs(x) < _F32(0.0004), x, r)
    r = np.where(np.abs(x) >= _F32(20.0), np.copysign(_F32(1), x), r)
    return r.astype(np.float32)


_EXP_LO, _EXP_HI = _f(0xc2af999a), _f(0x42b1999a)        # -87.8, 88.8
_LOG2E = _f(0x3fb8aa3b)
_LN2_HI, _LN2_LO = _f(0x3f318000), _f(0xb95e8083)       # 0.693359375, -2.12e-4
_EXP_P = [_f(b) for b in (0x39506967, 0x3ab743ce, 0x3c088908, 0x3d2aa9c1,
                          0x3e2aaaaa, 0x3f000000)]


def exp(x) -> np.ndarray:
    """``jnp.exp`` on float32, as XLA's CPU backend computes it."""
    x = _flush(x)
    xc = np.minimum(np.maximum(x, _EXP_LO), _EXP_HI)
    n = np.floor(fma(xc, _LOG2E, _F32(0.5)))
    n = np.minimum(np.maximum(n, _F32(-127)), _F32(127))
    r = fma(-n, _LN2_HI, xc)
    r = fma(-n, _LN2_LO, r)
    y = _add(fma(_horner(r, _EXP_P), _mul(r, r), r), _F32(1))
    with np.errstate(invalid="ignore"):
        scale = ((n.astype(np.int32) << 23) + np.int32(0x3f800000)).view(
            np.float32)
    return _mul(y, scale)


_LOG1P_SMALL = _f(0x3ed413cd)                            # 0.41421356
_LOG1P_A = [_F32(1)] + [_f(b) for b in (0x417101ad, 0x42a6185b, 0x435dc32d,
                                        0x439a8ca3, 0x43586d8a, 0x42707982)]
_LOG1P_B = [_f(b) for b in (0x383de04b, 0x3eff40c5, 0x40d284fa, 0x41ef4b9c,
                            0x4273cc76, 0x426473ad, 0x41a05101)]
_SQRT_HALF = _f(0x3f3504f3)
_LOG_P = [[_f(0x3d9021bb), _f(0xbdebd1b8), _f(0x3def251a)],
          [_f(0xbdfe5d4f), _f(0x3e11e9bf), _f(0xbe2aae50)],
          [_f(0x3e4cceac), _f(0xbe7ffffc), _f(0x3eaaaaaa)]]


def _log(y) -> np.ndarray:
    """XLA's float32 log (Cephes ``logf``) of y >= 1 (log1p's large
    branch); other inputs follow its special cases."""
    yc = np.where(y > _TINY, y, _TINY).astype(np.float32)
    bits = yc.view(np.int32)
    e = _add(((bits >> 23) - 127).astype(np.float32), _F32(1))
    m = ((bits & 0x7fffff) | 0x3f000000).view(np.float32)    # [0.5, 1)
    low = m < _SQRT_HALF
    x = _add(_add(m, _F32(-1)), np.where(low, m, _F32(0)))
    e = _add(e, -np.where(low, _F32(1), _F32(0)))
    x2 = _mul(x, x)
    x3 = _mul(x2, x)
    y1, y2, y3 = (_horner(x, p) for p in _LOG_P)
    y1 = fma(fma(fma(y1, x3, y2), x3, y3), x3, _mul(e, _LN2_LO))
    out = fma(e, _LN2_HI, _add(fma(-x2, _F32(0.5), x), y1))
    out = np.where(y == 0, -np.inf, np.where((y < 0) | np.isnan(y), np.nan,
                                              out))
    return np.where(y == np.inf, np.inf, out).astype(np.float32)


def log1p(x) -> np.ndarray:
    """``jnp.log1p`` on float32, as XLA's CPU backend computes it."""
    x = _flush(x)
    x2 = _mul(x, x)
    ratio = _div(_horner(x, _LOG1P_B), _horner(x, _LOG1P_A))
    small = _add(x, fma(x2, _F32(-0.5), _mul(_mul(x, x2), ratio)))
    big = _log(_add(x, _F32(1)))
    return np.where(np.abs(x) < _LOG1P_SMALL, small, big).astype(np.float32)


def softplus(x) -> np.ndarray:
    """``jax.nn.softplus`` on float32: ``max(x, 0) + log1p(exp(-|x|))``."""
    x = np.asarray(x, np.float32)
    out = _add(np.maximum(x, _F32(0)), log1p(exp(-np.abs(x))))
    return np.where(np.isnan(x), x, out).astype(np.float32)


def logits_cumulative(params: Dict[str, np.ndarray], v: np.ndarray,
                      num_filters: int) -> np.ndarray:
    """The JAX package's ``models/entropy.py:logits_cumulative`` on
    channel-last float32 ``v`` (..., C), as its eager ops compute it on
    XLA's CPU backend."""
    x = np.asarray(v, np.float32)[..., None]                 # (..., C, 1)
    for i in range(num_filters + 1):
        m = softplus(params[f"matrix_{i}"])                  # (C, out, in)
        b = np.asarray(params[f"bias_{i}"], np.float32)[:, :, 0]
        acc = _mul(x[..., None, 0], m[:, :, 0])              # (..., C, out)
        for k in range(1, m.shape[2]):
            acc = fma(x[..., None, k], m[:, :, k], acc)
        x = _add(acc, b)
        if i < num_filters:
            f = tanh(np.asarray(params[f"factor_{i}"], np.float32)[:, :, 0])
            x = _add(x, _mul(f, tanh(x)))
    return x[..., 0]


_NP_EXP_MAX, _NP_EXP_MIN = _F32(88.72283935546875), _F32(-103.97208404541016)
_NP_EXP_P = [_F32(v) for v in (5.082762527590693718096e-04,
                               6.757896990527504603057e-03,
                               5.114512081637298353406e-02,
                               2.473615434895520810817e-01,
                               7.257664613233124478488e-01,
                               9.999999999980870924916e-01)]
_NP_EXP_Q = [_F32(v) for v in (2.159509375685829852307e-02,
                               -2.742335390411667452936e-01, 1.0)]


def numpy_exp(x) -> np.ndarray:
    """numpy's float32 ``exp`` (its AVX2 / AVX512F routine), no flushing."""
    x = np.asarray(x, np.float32)
    nan, big, small = np.isnan(x), x >= _NP_EXP_MAX, x <= _NP_EXP_MIN
    xx = np.where(nan | big | small, _F32(0), x).astype(np.float32)
    magic = _F32(1.5 * 2 ** 23)
    q = (xx * _F32(1.4426950408889634) + magic) - magic
    r = _fma_exact(q, _F32(-6.93145752e-1), xx)
    r = _fma_exact(q, _F32(-1.42860677e-6), r)
    num, den = (_fma_exact(c[0], r, c[1]) for c in (_NP_EXP_P, _NP_EXP_Q))
    for k in _NP_EXP_P[2:]:
        num = _fma_exact(num, r, k)
    den = _fma_exact(den, r, _NP_EXP_Q[2])
    out = np.ldexp((num / den).astype(np.float64),
                   q.astype(np.int32)).astype(np.float32)
    out = np.where(big, _F32(np.inf), np.where(small, _F32(0), out))
    return np.where(nan, x, out).astype(np.float32)


def logistic(x) -> np.ndarray:
    """The JAX package's float32 numpy logistic of table baking
    (piecewise-stable: ``exp`` only ever sees non-positive arguments)."""
    x = np.asarray(x, np.float32)
    e = numpy_exp(-np.abs(x))
    return np.where(x >= 0, _F32(1) / (_F32(1) + e),
                    e / (_F32(1) + e)).astype(np.float32)


def interval_pmf(lower: np.ndarray, upper: np.ndarray) -> np.ndarray:
    """|σ(s·upper) − σ(s·lower)| with s = −sign(lower + upper), in float32
    as the JAX package's ``bake_device_tables`` and ``update_cdf_tables``
    compute it with numpy."""
    sign = -np.sign(lower + upper)
    return np.abs(logistic(sign * upper) - logistic(sign * lower))
