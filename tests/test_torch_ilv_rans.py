"""The port's interleaved (frame-v4) host coder (``coding/rans.py:
encode_interleaved`` / ``decode_interleaved`` over ``csrc/rans.cpp:ilv_*``)
against the JAX package's C++ coder and the port's numpy versions
(``coding/_rans_py.py``), on the same seeded tables and symbols: words
byte-equal, each package decoding the other's, the device coder's queue
(its plain versions here) equal to the host's, and the guards."""

import numpy as np
import pytest
import torch

from cnn_autoencoder_tpu.coding import rans as jrans
from cnn_autoencoder_tpu.coding.cdf import pmf_to_quantized_cdf
from cnn_autoencoder_tpu_torch.coding import _rans_py, rans
from cnn_autoencoder_tpu_torch.coding.device_rans import (
    DeviceTables, decode_interleaved, encode_interleaved, pack_streams,
    stream_channel_map, unpack_streams)


def _tables(rng, channels, max_support=48):
    """(freq, start, slot, offset, length) numpy tables of 12-bit random
    pmfs, as the JAX package's test draws them."""
    supports = rng.randint(5, max_support, channels)
    width = int(supports.max())
    freq = np.zeros((channels, width), np.int32)
    start = np.zeros((channels, width), np.int32)
    slot = np.zeros((channels, 4096), np.int32)
    offset = rng.randint(-20, 20, channels).astype(np.int32)
    for c in range(channels):
        n = int(supports[c])
        cdf = pmf_to_quantized_cdf(
            rng.dirichlet(np.ones(n) * rng.choice([0.1, 1.0, 5.0])), 12)
        freq[c, :n] = np.diff(cdf)
        start[c, :n] = cdf[:-1]
        freq[c, n:] = 1
        slot[c] = np.repeat(np.arange(n), freq[c, :n])
    return freq, start, slot, offset, supports.astype(np.int32)


def _symbols(rng, offset, length, n):
    """Step-major symbols over ``n`` positions, channels in runs, each
    drawn from its channel's support."""
    c = length.shape[0]
    idx = np.minimum(np.arange(n) * c // n, c - 1).astype(np.int32)
    sym = (rng.randint(0, 1 << 30, n) % length[idx] + offset[idx])
    return sym.astype(np.int32), idx


def _coders(freq, start, offset, length, s):
    """(name, encode, decode) of the three coders on these tables."""
    def bind(mod, fn):
        return lambda a, idx: getattr(mod, fn)(a, idx, freq, start, length,
                                               offset, s)
    return [(name, bind(mod, enc), bind(mod, dec))
            for name, mod, enc, dec in (
                ("port", rans, "encode_interleaved", "decode_interleaved"),
                ("jax", jrans, "encode_interleaved", "decode_interleaved"),
                ("numpy", _rans_py, "ilv_encode", "ilv_decode"))]


@pytest.mark.parametrize("seed,s,steps,rag", [(0, 16, 37, 5), (1, 64, 10, 0),
                                              (2, 128, 8, 77), (3, 3, 2, 1)])
def test_words_equal_and_decode_across(seed, s, steps, rag):
    """The port's C++, the JAX package's C++ and the numpy version write
    the same words, with a last step of ``rag`` streams or a whole one,
    and each decodes every other's."""
    rng = np.random.RandomState(seed)
    freq, start, _, offset, length = _tables(rng, rng.randint(2, 12))
    sym, idx = _symbols(rng, offset, length, s * steps + rag)
    coders = _coders(freq, start, offset, length, s)
    words = [enc(sym, idx) for _, enc, _ in coders]
    for (name, _, _), w in zip(coders, words):
        assert w.dtype == np.uint16, name
        np.testing.assert_array_equal(w, words[0], err_msg=name)
    for name, _, dec in coders:
        np.testing.assert_array_equal(dec(words[0], idx), sym, err_msg=name)


def test_device_queue_equals_host_queue():
    """The device coder's frame-v4 queue (``encode_interleaved`` over K6's
    plain versions on CPU tensors) is the host coder's over the same
    step-major symbols, and each decodes the other's."""
    rng = np.random.RandomState(3)
    c, h, w, s = 6, 16, 16, 32
    freq, start, slot, offset, length = _tables(rng, c)
    tables = DeviceTables(*(torch.from_numpy(a) for a in
                            (freq, start, slot, offset, length)),
                          support=freq.shape[1])
    cmap = stream_channel_map(c, (h, w), s)
    sym = np.stack([np.concatenate([rng.randint(0, length[ch], h * w)
                                    + offset[ch] for ch in range(c)])
                    for _ in range(2)]).astype(np.int32)
    t = cmap.shape[0]
    assert t * s == c * h * w   # no stream padding: the host codes all
    words, totals = encode_interleaved(
        pack_streams(torch.from_numpy(sym), s), torch.from_numpy(cmap),
        tables, 2 * s + t * s)
    words = words.view(torch.int16).numpy().view(np.uint16)
    queues = np.zeros((2, 2 * s + t * s), np.uint16)
    for b in range(2):
        host = rans.encode_interleaved(sym[b], cmap.reshape(-1), freq, start,
                                       length, offset, s)
        assert int(totals[b]) == host.shape[0]
        np.testing.assert_array_equal(words[b, :host.shape[0]], host)
        np.testing.assert_array_equal(rans.decode_interleaved(
            words[b, :host.shape[0]], cmap.reshape(-1), freq, start, length,
            offset, s), sym[b])
        queues[b, :host.shape[0]] = host
    dec = decode_interleaved(torch.from_numpy(queues), torch.from_numpy(cmap),
                             tables, t)
    np.testing.assert_array_equal(unpack_streams(dec, c * h * w).numpy(),
                                  sym)


def test_truncated_queue_decodes_the_same_garbage():
    """Reads past a cut queue take zero words in the C++ coders and the
    numpy version alike: the same symbols, no overread."""
    rng = np.random.RandomState(11)
    freq, start, _, offset, length = _tables(rng, 4)
    s = 32
    sym, idx = _symbols(rng, offset, length, s * 20)
    words = rans.encode_interleaved(sym, idx, freq, start, length, offset, s)
    for cut in (words[:len(words) // 3], words[:1]):
        outs = [dec(cut, idx) for _, _, dec in
                _coders(freq, start, offset, length, s)]
        for out in outs[1:]:
            np.testing.assert_array_equal(out, outs[0])


def test_out_of_support_and_wide_alphabets_rejected():
    rng = np.random.RandomState(9)
    freq, start, _, offset, length = _tables(rng, 3)
    sym, idx = _symbols(rng, offset, length, 64)
    sym[10] = offset[idx[10]] - 1
    for name, enc, _ in _coders(freq, start, offset, length, 16):
        with pytest.raises(ValueError, match="support"):
            enc(sym, idx)
    # a channel of more than 256 values (the packed LUT's value field)
    wide = np.full((1, 300), 8, np.int32)
    wide_start = (np.cumsum(wide) - wide).reshape(1, -1).astype(np.int32)
    zeros = np.zeros(64, np.int32)
    for mod, enc, dec in ((rans, "encode_interleaved", "decode_interleaved"),
                          (_rans_py, "ilv_encode", "ilv_decode")):
        args = (wide, wide_start, np.array([300], np.int32),
                np.zeros(1, np.int32), 16)
        with pytest.raises(ValueError, match="256"):
            getattr(mod, enc)(zeros, zeros, *args)
        with pytest.raises(ValueError, match="256"):
            getattr(mod, dec)(np.zeros(64, np.uint16), zeros, *args)


def test_bad_channel_indexes_rejected():
    """The C++ coder reads its table rows unchecked, so the binding
    refuses indexes past the tables and mismatched lengths."""
    rng = np.random.RandomState(5)
    freq, start, _, offset, length = _tables(rng, 3)
    sym, idx = _symbols(rng, offset, length, 64)
    bad = idx.copy()
    bad[7] = 3
    with pytest.raises(ValueError, match="channel indexes"):
        rans.encode_interleaved(sym, bad, freq, start, length, offset, 16)
    with pytest.raises(ValueError, match="channel indexes"):
        rans.decode_interleaved(np.zeros(64, np.uint16), bad, freq, start,
                                length, offset, 16)
    with pytest.raises(ValueError, match="indexes for"):
        rans.encode_interleaved(sym, idx[:-1], freq, start, length, offset,
                                16)
