"""The port's device rANS (plain versions, on the CPU) against the JAX
package: baked tables, the XLA scans and the Pallas kernels (interpret
mode).  Words (uint16), totals and decoded symbols must be bit-identical,
at stream counts up to the frame's 65535."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cnn_autoencoder_tpu.coding import device_rans as jrans
from cnn_autoencoder_tpu.ops.pallas import rans_kernel as jkernel
from cnn_autoencoder_tpu.training.checkpoint import \
    load_checkpoint as jax_load_checkpoint
from cnn_autoencoder_tpu_torch.coding import device_rans as trans
from cnn_autoencoder_tpu_torch.ops.kernels import rans_kernel as tkernel
from cnn_autoencoder_tpu_torch.training.checkpoint import load_checkpoint

FIXTURES = ["benchmarks/bench_flagship.msgpack",
            "benchmarks/bench_flagship_lam002.msgpack",
            "benchmarks/bench_flagship_lam05.msgpack"]
FILTERS = (3, 3, 3, 3)
TABLE_KEYS = ("freq", "start", "slot", "offset", "length")


@pytest.fixture(scope="module")
def flagship_tables():
    """(port tables, JAX tables) of the flagship checkpoint."""
    params = load_checkpoint(FIXTURES[0])["fact_ent"]["params"]
    return (trans.bake_device_tables(params, FILTERS),
            jrans.bake_device_tables(params, FILTERS))


def _jax_tables(t):
    return jrans.DeviceTables(*[jnp.asarray(getattr(t, k).numpy())
                                for k in TABLE_KEYS], t.support)


def _peaked_tables():
    """One channel whose most likely value has freq 3968 > 2^11: coding it
    divides states above 2^31 (the Pallas encoder's overshoot case)."""
    freq = np.array([[3968, 64, 32, 32]], np.int32)
    start = np.concatenate([[0], np.cumsum(freq[0])[:-1]])[None]
    slot = np.repeat(np.arange(4), freq[0])[None].astype(np.int32)
    return trans.DeviceTables(
        freq=torch.from_numpy(freq), start=torch.from_numpy(
            start.astype(np.int32)), slot=torch.from_numpy(slot),
        offset=torch.tensor([-1], dtype=torch.int32),
        length=torch.tensor([4], dtype=torch.int32), support=4)


def _sample(tables, ch_map, batch, seed):
    """(B, T, S) symbols drawn from each (step, stream)'s channel table."""
    rng = np.random.RandomState(seed)
    freq = tables.freq.numpy().astype(np.float64)
    length = tables.length.numpy()
    ch = np.asarray(ch_map)
    out = np.empty((batch,) + ch.shape, np.int32)
    for c in np.unique(ch):
        p = freq[c, :length[c]] / freq[c, :length[c]].sum()
        sel = ch == c
        out[:, sel] = rng.choice(length[c], size=(batch, int(sel.sum())),
                                 p=p) + int(tables.offset[c])
    return out


def _encode_both(tables, sym, ch_map, capacity):
    got, got_tot = trans.encode_interleaved(torch.from_numpy(sym),
                                            torch.from_numpy(ch_map),
                                            tables, capacity)
    assert got.dtype == torch.uint16 and got_tot.dtype == torch.int32
    ref, ref_tot, esc = jrans.encode_device_interleaved(
        jnp.asarray(sym), jnp.asarray(ch_map), _jax_tables(tables), capacity)
    assert int(esc) == 0
    ref = np.asarray(ref)
    assert ref.dtype == np.uint16
    return got.numpy(), got_tot.numpy(), ref, np.asarray(ref_tot)


@pytest.mark.parametrize("path", FIXTURES)
def test_tables_match_jax(path):
    params = jax_load_checkpoint(path)["fact_ent"]["params"]
    got = trans.bake_device_tables(
        {k: np.asarray(v) for k, v in params.items()}, FILTERS)
    ref = jrans.bake_device_tables(params, FILTERS)
    for key in TABLE_KEYS:
        np.testing.assert_array_equal(getattr(got, key).numpy(),
                                      np.asarray(getattr(ref, key)), key)
    assert got.support == ref.support
    assert trans.expected_bits_per_symbol(got) == \
        jrans.expected_bits_per_symbol(ref)


# (latent h, latent w, streams): stream-aligned planes, a plane that is not
# a multiple of S (steps span two channels, the tail is padded), one
# stream, and more than 1024 streams: S = 2048, S = 3000 (not a multiple of
# 32, steps spanning many channels) and the frame's largest S (one step)
@pytest.mark.parametrize("lh,lw,s", [(4, 4, 64), (5, 3, 64), (3, 3, 1),
                                     (8, 8, 2048), (8, 8, 3000),
                                     (4, 4, 65535)])
def test_encode_decode_match_jax_scan(flagship_tables, lh, lw, s):
    tables, jtables = flagship_tables
    c = int(tables.freq.shape[0])
    ch_map = trans.stream_channel_map(c, (lh, lw), s)
    np.testing.assert_array_equal(
        ch_map, jrans.stream_channel_map(c, (lh, lw), s))
    n = c * lh * lw
    sym = _sample(tables, ch_map, 3, seed=lh * 10 + lw)
    flat = sym.reshape(3, -1)[:, :n]
    packed = trans.pack_streams(torch.from_numpy(flat), s).numpy()
    np.testing.assert_array_equal(
        packed, np.asarray(jrans.pack_streams(jnp.asarray(flat), s)))
    if (lh * lw) % s:
        assert any(len(set(row)) > 1 for row in ch_map)

    capacity = 2 * s + packed.shape[1] * s
    got, got_tot, ref, ref_tot = _encode_both(tables, packed, ch_map,
                                              capacity)
    np.testing.assert_array_equal(got_tot, ref_tot)
    np.testing.assert_array_equal(got, ref)

    t = ch_map.shape[0]
    if s > 1024:
        assert t * s > n and len(set(ch_map[0])) > 1
    dec = trans.decode_interleaved(torch.from_numpy(got),
                                   torch.from_numpy(ch_map), tables, t)
    ref_dec = jrans.decode_device_interleaved(jnp.asarray(ref),
                                              jnp.asarray(ch_map), jtables, t)
    np.testing.assert_array_equal(dec.numpy(), np.asarray(ref_dec))
    np.testing.assert_array_equal(
        trans.unpack_streams(dec, n).numpy(), flat)


def test_capacity_overflow_drops_like_jax(flagship_tables):
    """Words past ``capacity`` are dropped, the total still counts them."""
    tables, _ = flagship_tables
    ch_map = trans.stream_channel_map(48, (4, 4), 64)
    # uniform over each table: far more words than the tables expect
    rng = np.random.RandomState(3)
    sym = (rng.randint(0, 1 << 16, (2,) + ch_map.shape)
           % tables.length.numpy()[ch_map]
           + tables.offset.numpy()[ch_map]).astype(np.int32)
    got, got_tot, ref, ref_tot = _encode_both(tables, sym, ch_map, 2 * 64 + 5)
    assert (got_tot > 2 * 64 + 5).all()
    np.testing.assert_array_equal(got_tot, ref_tot)
    np.testing.assert_array_equal(got, ref)
    with pytest.raises(ValueError, match="flush width"):
        trans.encode_interleaved(torch.from_numpy(sym),
                                 torch.from_numpy(ch_map), tables, 2 * 64 - 1)


def test_compaction_rerun_matches_one_pass_encode(flagship_tables):
    """One state pass compacted at an overflowing capacity, then again at
    larger ones: each compaction equals the whole encode (and the JAX scan)
    at its capacity, and the words that fit do not depend on it."""
    tables, _ = flagship_tables
    ch_map = trans.stream_channel_map(48, (4, 4), 64)
    # uniform over each table: far more words than the tables expect
    rng = np.random.RandomState(13)
    sym = (rng.randint(0, 1 << 16, (2,) + ch_map.shape)
           % tables.length.numpy()[ch_map]
           + tables.offset.numpy()[ch_map]).astype(np.int32)
    state = trans.encode_states(torch.from_numpy(sym),
                                torch.from_numpy(ch_map), tables)
    assert state.words.dtype == torch.uint16
    worst = 2 * 64 + ch_map.shape[0] * 64
    full = None
    for cap in (2 * 64 + 7, worst // 2, worst):
        words, totals = tkernel.rans_compact(state, cap)
        got, got_tot, ref, ref_tot = _encode_both(tables, sym, ch_map, cap)
        np.testing.assert_array_equal(words.numpy(), got)
        np.testing.assert_array_equal(totals.numpy(), got_tot)
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(got_tot, ref_tot)
        full = words.numpy() if full is None else full
        keep = min(cap, 2 * 64 + 7)
        np.testing.assert_array_equal(words.numpy()[:, :keep],
                                      full[:, :keep])
    assert (totals.numpy() > 2 * 64 + 7).all()
    # into caller-owned tensors, as the codec compacts into its fetch buffer
    out = (torch.empty((2, worst), dtype=torch.uint16),
           torch.empty(2, dtype=torch.int32))
    assert tkernel.rans_compact(state, worst, out=out) is out
    np.testing.assert_array_equal(out[0].numpy(), words.numpy())
    np.testing.assert_array_equal(out[1].numpy(), totals.numpy())


@pytest.mark.parametrize("lh,lw,s", [(4, 4, 64), (8, 8, 100),
                                     (64, 64, 3000)])
def test_state_pass_layout(flagship_tables, lh, lw, s):
    """The state pass's flags are bit rows, one bit per (step, stream) with
    zeros past S, and its counts the set bits in each CHUNK_WORDS run of
    them (the kernel state pass's layout, which its compaction reads)."""
    tables, _ = flagship_tables
    ch_map = trans.stream_channel_map(48, (lh, lw), s)
    sym = _sample(tables, ch_map, 2, s)
    state = trans.encode_states(torch.from_numpy(sym),
                                torch.from_numpy(ch_map), tables)
    t, w = ch_map.shape[0], -(-s // 32)
    assert state.flags.dtype == state.counts.dtype == torch.int32
    assert state.flags.shape == (2, t * w)
    rows = state.flags.numpy().view(np.uint32)
    bits = (rows[..., None] >> np.arange(32, dtype=np.uint32)) & 1
    bits = bits.reshape(2, t, w * 32)
    assert not bits[..., s:].any()
    chunks = -(-t * w // tkernel.CHUNK_WORDS)
    per_word = np.zeros((2, chunks * tkernel.CHUNK_WORDS), np.int64)
    per_word[:, :t * w] = bits.reshape(2, t * w, 32).sum(-1)
    np.testing.assert_array_equal(
        state.counts.numpy(),
        per_word.reshape(2, chunks, -1).sum(-1))
    # the flagged words are the queue after the flush words, in (t, s)
    # order
    worst = 2 * s + t * s
    words, totals = tkernel.rans_compact(state, worst)
    flagged = bits[..., :s].astype(bool)
    for i in range(2):
        assert int(totals[i]) == 2 * s + int(state.counts[i].sum())
        np.testing.assert_array_equal(
            words.numpy()[i, 2 * s:int(totals[i])],
            state.words.numpy()[i][flagged[i]])


def test_stream_count_limits():
    """Any S the frame's u16 field holds is coded; 0 and 65536 are not."""
    tables = _peaked_tables()
    for s in (0, 65536):
        ch = torch.zeros((1, s), dtype=torch.int32)
        with pytest.raises(ValueError, match="65535"):
            trans.encode_states(torch.zeros((1, 1, s), dtype=torch.int32),
                                ch, tables)
        with pytest.raises(ValueError, match="65535"):
            trans.decode_interleaved(torch.zeros((1, 8), dtype=torch.uint16),
                                     ch, tables, 1)
    with pytest.raises(ValueError, match="uint16"):
        trans.decode_interleaved(torch.zeros((1, 8), dtype=torch.int32),
                                 torch.zeros((1, 4), dtype=torch.int32),
                                 tables, 1)


def test_kernels_match_pallas_interpret(flagship_tables):
    """S = 1024, a few single-channel steps: plain encode against the Pallas
    encode kernel, plain decode against the Pallas decode kernel."""
    tables, jtables = flagship_tables
    ch_map = trans.stream_channel_map(4, (32, 32), 1024)   # 4 steps
    sym = _sample(tables, ch_map, 2, seed=11)
    capacity = 2 * 1024 + 4 * 1024
    got, got_tot = trans.encode_interleaved(
        torch.from_numpy(sym), torch.from_numpy(ch_map), tables, capacity)
    ref, ref_tot, _ = jkernel.encode_interleaved_pallas(
        jnp.asarray(sym), jnp.asarray(ch_map), jtables,
        jkernel.pack_enc_tables(jtables), capacity, True)
    np.testing.assert_array_equal(got_tot.numpy(), np.asarray(ref_tot))
    assert got.dtype == torch.uint16
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(ref).astype(np.uint16))

    lut = tkernel.pack_dec_lut(tables.freq, tables.start, tables.slot)
    np.testing.assert_array_equal(lut.numpy(),
                                  np.asarray(jkernel.pack_dec_lut(jtables)))
    queues = got[:, :-(-capacity // 128) * 128]
    vals = tkernel.rans_decode_plain(queues, torch.from_numpy(ch_map), lut, 4)
    # the Pallas decode takes the words zero-extended to int32
    ref_vals = jkernel.decode_interleaved_pallas(
        jnp.asarray(queues.numpy().astype(np.int32)),
        jnp.asarray(ch_map[:, 0]), jnp.asarray(lut.numpy()), 4, True)
    np.testing.assert_array_equal(vals.numpy(), np.asarray(ref_vals))
    np.testing.assert_array_equal(
        vals.numpy() + tables.offset.numpy()[ch_map][None], sym)


def _states_before_division(tables, sym):
    """Every state the encoder divides by a freq above 2^11 (numpy replay
    of the encode recursion over one tile)."""
    f_tab = tables.freq.numpy().astype(np.uint64)
    s_tab = tables.start.numpy().astype(np.uint64)
    v = sym[0] - int(tables.offset[0])
    x = np.full(sym.shape[2], 1 << 16, np.uint64)
    seen = []
    for t in range(sym.shape[1] - 1, -1, -1):
        f, st = f_tab[0][v[t]], s_tab[0][v[t]]
        x = np.where((x >> np.uint64(20)) >= f, x >> np.uint64(16), x)
        seen.append(x[f > 2048])
        x = (x // f << np.uint64(12)) + x % f + st
    return np.concatenate(seen)


def test_peaked_table_above_2_31_matches_jax():
    tables = _peaked_tables()
    jtables = _jax_tables(tables)
    ch_map = np.zeros((12, 1024), np.int32)
    # uniform values: the rare ones push states up between peaked ones
    sym = np.random.RandomState(5).randint(0, 4, (1, 12, 1024)) - 1
    sym = sym.astype(np.int32)
    assert (_states_before_division(tables, sym) >= 1 << 31).any()
    capacity = 2 * 1024 + 12 * 1024
    got, got_tot, ref, ref_tot = _encode_both(tables, sym, ch_map, capacity)
    np.testing.assert_array_equal(got_tot, ref_tot)
    np.testing.assert_array_equal(got, ref)
    k_ref, k_tot, _ = jkernel.encode_interleaved_pallas(
        jnp.asarray(sym), jnp.asarray(ch_map), jtables,
        jkernel.pack_enc_tables(jtables), capacity, True)
    np.testing.assert_array_equal(got_tot, np.asarray(k_tot))
    np.testing.assert_array_equal(got, np.asarray(k_ref).astype(np.uint16))
    dec = trans.decode_interleaved(torch.from_numpy(got),
                                   torch.from_numpy(ch_map), tables, 12)
    np.testing.assert_array_equal(dec.numpy(), sym)


def test_truncated_queue_decodes_like_jax(flagship_tables):
    """Reads past a truncated queue's end take its last word: no error, and
    the same garbage as the JAX scan."""
    tables, jtables = flagship_tables
    ch_map = trans.stream_channel_map(48, (4, 4), 64)
    sym = _sample(tables, ch_map, 2, seed=9)
    words, totals = trans.encode_interleaved(
        torch.from_numpy(sym), torch.from_numpy(ch_map), tables,
        2 * 64 + sym.shape[1] * 64)
    assert words.dtype == torch.uint16
    for keep in (int(totals.min()) // 2, 3):
        cut = words[:, :keep].contiguous()
        dec = trans.decode_interleaved(cut, torch.from_numpy(ch_map), tables,
                                       ch_map.shape[0])
        ref = jrans.decode_device_interleaved(
            jnp.asarray(cut.numpy()), jnp.asarray(ch_map), jtables,
            ch_map.shape[0])
        assert dec.shape == sym.shape
        np.testing.assert_array_equal(dec.numpy(), np.asarray(ref))
