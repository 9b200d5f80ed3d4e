"""The port's table baking against the JAX codec's, on the CPU.

``coding/xla_f32.py`` reproduces XLA's float32 CPU arithmetic and numpy's
float32 ``exp``, so the port bakes the same rANS tables as the JAX
package for any bottleneck, not only for the three fixtures.  Held here:
its functions bit-equal to ``jnp``'s and ``np.exp``, its chain bit-equal
to the JAX package's ``logits_cumulative`` on the fixtures' sample grids,
and the tables of hundreds of seeded bottlenecks element-equal."""

from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cnn_autoencoder_tpu.coding import device_rans as jrans
from cnn_autoencoder_tpu.models.entropy import \
    logits_cumulative as jax_logits_cumulative
from cnn_autoencoder_tpu.models.entropy import \
    update_cdf_tables as jax_update_cdf_tables
from cnn_autoencoder_tpu_torch.coding import device_rans as trans
from cnn_autoencoder_tpu_torch.coding import xla_f32
from cnn_autoencoder_tpu_torch.models.entropy import update_cdf_tables
from cnn_autoencoder_tpu_torch.training.checkpoint import load_checkpoint

FIXTURES = ["benchmarks/bench_flagship.msgpack",
            "benchmarks/bench_flagship_lam002.msgpack",
            "benchmarks/bench_flagship_lam05.msgpack"]
FILTERS = (3, 3, 3, 3)
TABLE_KEYS = ("freq", "start", "slot", "offset", "length")
HOST_KEYS = ("quantized_cdf", "cdf_length", "offset")


def _params(path):
    return {k: np.asarray(v) for k, v in
            load_checkpoint(path)["fact_ent"]["params"].items()}


def _values(seed: int) -> np.ndarray:
    """Seeded float32 values over the functions' ranges and their edges:
    ±0, subnormals, the clamps of tanh (±7.9988, 0.0004, 20) and of the
    exps (-87.8, 88.8, -103.97, 88.72), tiny and huge magnitudes, ±inf and
    NaN."""
    rng = np.random.RandomState(seed)
    n = 40000
    parts = [rng.standard_normal(n) * 3, rng.standard_normal(n) * 30,
             np.sign(rng.standard_normal(n)) * np.exp(rng.uniform(-95, 5, n)),
             rng.uniform(-110, 90, n)]
    edges = [0.0, -0.0, 1e-39, -1e-39, 1e-45, 2.0 ** -126, 1e-30, 0.0004,
             -0.0004, 0.00039999, 0.41421356, 7.99881172180175781, 8.0, 9.0,
             20.0, -20.0, 19.999998, -87.8, -87.80001, 88.8, 88.72283935546875,
             -103.97208404541016, -103.972, 100.0, -100.0, 1e30, -1e30,
             3.4e38, -3.4e38, np.inf, -np.inf, np.nan]
    out = np.concatenate(parts + [edges]).astype(np.float32)
    return np.concatenate([out, np.nextafter(out, np.float32(np.inf)),
                           np.nextafter(out, np.float32(-np.inf))])


FUNCTIONS = {
    "tanh": (xla_f32.tanh, jnp.tanh),
    "exp": (xla_f32.exp, jnp.exp),
    "log1p": (xla_f32.log1p, jnp.log1p),
    "softplus": (xla_f32.softplus, jax.nn.softplus),
    "numpy_exp": (xla_f32.numpy_exp, np.exp),
}


@pytest.mark.parametrize("name", sorted(FUNCTIONS))
def test_float32_functions_bit_equal(name):
    """Each function of the port's copy gives the bits of its original on
    every seeded and edge value (NaN for NaN)."""
    ours, theirs = FUNCTIONS[name]
    x = _values(7)
    with np.errstate(all="ignore"):
        got = ours(x)
        ref = np.asarray(theirs(x))
    assert got.dtype == np.float32 and ref.dtype == np.float32
    same = (got.view(np.uint32) == ref.view(np.uint32)) | (
        np.isnan(got) & np.isnan(ref))
    assert same.all(), (name, x[~same][:8], got[~same][:8], ref[~same][:8])


def _round_f32(exact: Fraction) -> np.float32:
    """The float32 nearest ``exact``, ties to even (normal range)."""
    guess = np.float32(float(exact))
    cands = [np.nextafter(guess, np.float32(-np.inf)), guess,
             np.nextafter(guess, np.float32(np.inf))]
    dist = [abs(Fraction(float(c)) - exact) for c in cands]
    best = min(dist)
    ties = [c for c, d in zip(cands, dist) if d == best]
    return min(ties, key=lambda c: int(np.array(c).view(np.uint32)) & 1)


def test_fma_rounds_once():
    """``fma`` is a·b + c with one rounding, also where the float64 sum
    lies on a float32 midpoint that the exact sum misses by less than a
    float64 ulp (where rounding twice goes the wrong way)."""
    rng = np.random.RandomState(3)
    a = (rng.standard_normal(3000) * 4).astype(np.float32)
    b = (rng.standard_normal(3000) * 4).astype(np.float32)
    c = (rng.standard_normal(3000) * 16).astype(np.float32)
    u = np.float32(2.0 ** -23)
    # (1 ± u)·2^-24·(1 ∓ u) = 2^-24 − 2^-70: 1 + u + that is just below the
    # midpoint 1 + u + 2^-24, which the float64 sum rounds onto
    hard_a = np.array([(1 + u) * np.float32(2.0 ** -24),
                       -(1 + u) * np.float32(2.0 ** -24),
                       (1 + u) * np.float32(2.0 ** -24)], np.float32)
    hard_b = np.array([1 - u, 1 - u, 1 + u], np.float32)
    hard_c = np.array([1 + u, -(1 + u), 1 + u], np.float32)
    a, b, c = (np.concatenate(p) for p in ((a, hard_a), (b, hard_b),
                                           (c, hard_c)))
    got = xla_f32.fma(a, b, c)
    want = np.array([_round_f32(Fraction(float(x)) * Fraction(float(y))
                                + Fraction(float(z)))
                     for x, y, z in zip(a, b, c)], np.float32)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    naive = (a.astype(np.float64) * b + c).astype(np.float32)
    assert (naive[-3:] != want[-3:]).any()  # the hard cases are hard


def _sample_grid(params):
    """The (L, C) samples at which ``bake_device_tables`` evaluates the
    chain, as both packages build them."""
    q = params["quantiles"]
    medians = q[:, 0, 1]
    minima = np.clip(np.ceil(medians - q[:, 0, 0]).astype(np.int64), 0,
                     None) + 8
    maxima = np.clip(np.ceil(q[:, 0, 2] - medians).astype(np.int64), 0,
                     None) + 8
    length = int((maxima + minima + 1).max())
    return (np.arange(length, dtype=np.float32)[:, None]
            + (medians - minima)[None, :])


@pytest.mark.parametrize("path", FIXTURES)
def test_chain_bit_equal_on_fixture_grids(path):
    params = _params(path)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    samples = _sample_grid(params)
    for v in (samples - 0.5, samples + 0.5):
        got = xla_f32.logits_cumulative(params, v, len(FILTERS))
        ref = np.asarray(jax_logits_cumulative(jparams, jnp.asarray(v),
                                               len(FILTERS),
                                               stop_gradient=True))
        np.testing.assert_array_equal(got.view(np.uint32),
                                      ref.view(np.uint32))


def _perturbed(base, seed, scale):
    """The fixture's bottleneck with every parameter but the quantiles
    scaled by 1 + scale·N(0, 1), drawn in key order from ``seed``."""
    rng = np.random.RandomState(seed)
    out = {}
    for k in sorted(base):
        v = base[k]
        if k != "quantiles":
            v = v * (1 + scale * rng.standard_normal(v.shape))
        out[k] = v.astype(np.float32)
    return out


@pytest.mark.parametrize("scale,models", [(0.3, 300), (1.0, 100)])
def test_tables_equal_on_seeded_bottlenecks(scale, models):
    """Element-equal tables over seeded bottlenecks.  With the float64
    chain the port used before, 76 entries of 4 models differed at scale
    0.3 (seeds 50, 176, 177, 198) and 8 entries of 2 models at scale 1.0
    (seeds 78, 93)."""
    base = _params(FIXTURES[0])
    differing = {}
    for seed in range(models):
        params = _perturbed(base, seed, scale)
        got = trans.bake_device_tables(params, FILTERS)
        ref = jrans.bake_device_tables(params, FILTERS)
        n = sum(int((getattr(got, k).numpy()
                     != np.asarray(getattr(ref, k))).sum())
                for k in TABLE_KEYS)
        if n:
            differing[seed] = n
    assert differing == {}, differing


def _host_table_mismatches(params) -> int:
    """Differing host-table entries; -1 where both packages refuse the
    bottleneck alike (a channel whose pmf and tail mass round to zero: the
    host tables, unlike the device tables, are not renormalized)."""
    try:
        ref = jax_update_cdf_tables(params, FILTERS)
    except ValueError as exc:
        with pytest.raises(ValueError, match=str(exc)):
            update_cdf_tables(params, FILTERS)
        return -1
    got = update_cdf_tables(params, FILTERS)
    n = 0
    for k in HOST_KEYS:
        assert got[k].shape == ref[k].shape and got[k].dtype == ref[k].dtype
        n += int((got[k] != ref[k]).sum())
    return n


@pytest.mark.parametrize("path", FIXTURES)
def test_host_tables_equal_on_fixtures(path):
    """The host coder's 16-bit tables ('cae', 'cae_bn', the 'cae_tpu'
    escape fallback) element-equal to the JAX package's
    ``update_cdf_tables``, from numpy parameters or tensors."""
    import torch
    params = _params(path)
    assert _host_table_mismatches(params) == 0
    got = update_cdf_tables({k: torch.from_numpy(v)
                             for k, v in params.items()}, FILTERS)
    ref = jax_update_cdf_tables(params, FILTERS)
    for k in HOST_KEYS:
        np.testing.assert_array_equal(got[k], ref[k])


@pytest.mark.parametrize("scale,models", [(0.3, 300), (1.0, 100)])
def test_host_tables_equal_on_seeded_bottlenecks(scale, models):
    """Element-equal host tables over the seeded bottlenecks of
    ``test_tables_equal_on_seeded_bottlenecks``, or the same refusal: at
    scale 1.0, 39 of the 100 make both packages raise."""
    base = _params(FIXTURES[0])
    differing, refused = {}, 0
    for seed in range(models):
        n = _host_table_mismatches(_perturbed(base, seed, scale))
        refused += n < 0
        if n > 0:
            differing[seed] = n
    assert differing == {}, differing
    assert refused < models // 2
