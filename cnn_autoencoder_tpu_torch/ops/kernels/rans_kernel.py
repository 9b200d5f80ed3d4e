"""Interleaved rANS-32/16 encode and decode of cae_tpu frame v4: the CUDA
kernels in ``csrc/rans.cu`` and their plain PyTorch versions.

Replaces ``cnn_autoencoder_tpu/ops/pallas/rans_kernel.py`` (the encode
kernel ``_make_encode_kernel`` and the decode kernel ``_make_decode_kernel``).
Both directions are bit-identical between kernel, plain version and the JAX
package, at any stream count S from 1 to 65535 (the frame's u16 field).
Coded words are uint16 in both directions, as the frame stores them; the
plain versions keep the uint32 state in int64 masked to 32 bits.

Encode is two passes.  The state pass (``rans_encode_states``) runs every
stream's T steps and leaves an ``EncodeState``: the word each (step,
stream) would emit, whether it does (one bit each), the final states and
the flags' counts per chunk, in one layout from the kernel and the plain
version, so either compaction takes either state.  The compaction
(``rans_compact``) places the emitted words in decode order in a
(B, capacity) queue.  Frames do not depend on the capacity, so a caller
whose capacity overflows re-runs only the compaction at a larger one.

Shapes: symbols (B, T, S) int32, the per-(step, stream) channel map (T, S)
int32, encode tables ``freq``/``start`` (C, L) int32 with ``offset`` (C,),
the decode LUT (C, 4096) int32 packed ``slot<<24 | start<<12 | (freq-1)``.
The kernels take the full (T, S) channel map, so every geometry the codec
produces runs on them.
"""

from typing import NamedTuple, Tuple

import torch

from .build import check_launch, load_library, stream_handle

PRECISION = 12
PROB_SCALE = 1 << PRECISION
MASK = PROB_SCALE - 1
STATE_MIN = 1 << 16
EMIT_SHIFT = 20
_U32 = 0xFFFFFFFF
CHUNK_WORDS = 1024  # bit words a flag count covers (kChunkWords, rans.cu)


class EncodeState(NamedTuple):
    """What the state pass leaves for the compaction, in one layout from the
    kernel and the plain version alike.  Its buffers belong to the caller,
    who may compact them again at another capacity."""
    words: torch.Tensor   # (B, T, S) uint16: the word each (step, stream)
    #                       would emit
    flags: torch.Tensor   # (B, T * ceil(S / 32)) int32 bit rows: whether it
    #                       does; bit l of word t * ceil(S / 32) + g is
    #                       stream 32 g + l at step t
    final: torch.Tensor   # (B, S) int32: final states (the flush words)
    counts: torch.Tensor  # (B, chunks) int32: flags set in each run of
    #                       CHUNK_WORDS bit words


def _as_int32(v: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) as int32 with the same 32 bits."""
    return (v - ((v >> 31) << 32)).to(torch.int32)


# uint16 <-> int64 through int16 bit views: PyTorch computes little on
# uint16, so the plain versions only move it
def _as_uint16(v: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^16) as uint16."""
    return (v - ((v >> 15) << 16)).to(torch.int16).view(torch.uint16)


def _from_uint16(w: torch.Tensor) -> torch.Tensor:
    return w.view(torch.int16).long() & 0xFFFF


def _pack_flags(flags: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, T, S) bool flags -> (bit rows, counts) of an EncodeState."""
    b, t, s = flags.shape
    w = -(-s // 32)
    bits = torch.zeros((b, t, w * 32), dtype=torch.int64,
                       device=flags.device)
    bits[..., :s] = flags
    rows = _as_int32((bits.reshape(b, t * w, 32)
                      << torch.arange(32, device=flags.device)).sum(-1))
    chunks = -(-t * w // CHUNK_WORDS)
    pop = torch.zeros((b, chunks * CHUNK_WORDS), dtype=torch.int64,
                      device=flags.device)
    pop[:, :t * w] = bits.reshape(b, t * w, 32).sum(-1)
    return rows, pop.reshape(b, chunks, CHUNK_WORDS).sum(-1).to(torch.int32)


def _unpack_flags(rows: torch.Tensor, t: int, s: int) -> torch.Tensor:
    """Bit rows of an EncodeState -> (B, T, S) bool flags."""
    bits = (rows.long()[..., None]
            >> torch.arange(32, device=rows.device)) & 1
    return bits.reshape(rows.shape[0], t, -1)[..., :s].bool()


def pack_dec_lut(freq: torch.Tensor, start: torch.Tensor,
                 slot: torch.Tensor) -> torch.Tensor:
    """(C, 4096) int32 decode LUT: cum -> slot<<24 | start<<12 | (freq-1)."""
    st_at = torch.gather(start.long(), 1, slot.long())
    fq_at = torch.gather(freq.long(), 1, slot.long())
    return _as_int32((slot.long() << 24) | (st_at << PRECISION) | (fq_at - 1))


def _check_capacity(capacity: int, s: int) -> None:
    if capacity < 2 * s:
        raise ValueError(
            f"capacity {capacity} < flush width {2 * s}: capacity counts "
            "TOTAL words including the 2S-word flush")


def _check_streams(s: int) -> None:
    if not 1 <= s <= 0xFFFF:
        raise ValueError(f"rans coding takes 1..65535 streams per tile (the "
                         f"frame's u16 field), got {s}")


def _check_tensors(name: str, dtype: torch.dtype,
                   *tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name} kernel takes CUDA tensors, got {dev}")
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{name} takes contiguous {dtype} tensors, got "
                             f"{t.dtype} {tuple(t.shape)}")


def _check_geometry(name: str, t: int, s: int) -> None:
    _check_streams(s)
    if t < 1 or t * s >= 1 << 30:
        raise ValueError(f"{name}: {t} steps x {s} streams per tile is out "
                         "of range")


def _into(out, words: torch.Tensor, totals: torch.Tensor):
    if out is None:
        return words, totals
    out[0].copy_(words)
    out[1].copy_(totals)
    return out


# -- encode -----------------------------------------------------------------


def rans_encode_states_plain(symbols: torch.Tensor, ch_map: torch.Tensor,
                             freq: torch.Tensor, start: torch.Tensor,
                             offset: torch.Tensor) -> EncodeState:
    """The state pass: (B, T, S) symbols -> EncodeState.  Out-of-table
    symbols are clipped (the caller counts escapes)."""
    b, t, s = symbols.shape
    _check_streams(s)
    support = freq.shape[1]
    v = (symbols - offset[ch_map][None]).clamp(0, support - 1)
    idx = ch_map[None].long() * support + v.long()
    f_all = freq.reshape(-1)[idx].long()
    st_all = start.reshape(-1)[idx].long()

    x = torch.full((b, s), STATE_MIN, dtype=torch.int64,
                   device=symbols.device)
    words = torch.empty((b, t, s), dtype=torch.int64, device=symbols.device)
    flags = torch.empty((b, t, s), dtype=torch.bool, device=symbols.device)
    for i in range(t - 1, -1, -1):
        f, st = f_all[:, i], st_all[:, i]
        e = (x >> EMIT_SHIFT) >= f
        words[:, i] = x & 0xFFFF
        flags[:, i] = e
        x = torch.where(e, x >> 16, x)
        q = torch.div(x, f, rounding_mode="floor")
        x = ((q << PRECISION) + (x - q * f) + st) & _U32
    rows, counts = _pack_flags(flags)
    return EncodeState(_as_uint16(words), rows, _as_int32(x), counts)


def rans_compact_plain(state: EncodeState, capacity: int, out=None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The compaction: -> ((B, capacity) uint16 words in decode order,
    (B,) int32 total words).  Words past ``capacity`` are dropped: the
    caller checks ``totals <= capacity``.  ``out``: optional (words,
    totals) tensors to write into."""
    b, t, s = state.words.shape
    _check_capacity(capacity, s)
    dev = state.words.device
    flat = _unpack_flags(state.flags, t, s).reshape(b, -1).long()
    pos = 2 * s + torch.cumsum(flat, dim=1) - flat
    totals = 2 * s + flat.sum(dim=1)
    # words at or past capacity land in a spill column that is cut away
    pos = torch.where((flat > 0) & (pos < capacity), pos,
                      torch.full_like(pos, capacity))
    buf = torch.zeros((b, capacity + 1), dtype=torch.int64, device=dev)
    buf.scatter_(1, pos, _from_uint16(state.words).reshape(b, -1) * flat)
    x = state.final.long() & _U32
    buf[:, 0:2 * s:2] = x & 0xFFFF
    buf[:, 1:2 * s:2] = x >> 16
    return _into(out, _as_uint16(buf[:, :capacity]),
                 totals.to(torch.int32))


def rans_encode_plain(symbols: torch.Tensor, ch_map: torch.Tensor,
                      freq: torch.Tensor, start: torch.Tensor,
                      offset: torch.Tensor, capacity: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, T, S) symbols -> ((B, capacity) uint16 words in decode order,
    (B,) int32 total words): both plain passes."""
    return rans_compact_plain(rans_encode_states_plain(
        symbols, ch_map, freq, start, offset), capacity)


def encode_states_cuda(symbols: torch.Tensor, ch_map: torch.Tensor,
                       freq: torch.Tensor, start: torch.Tensor,
                       offset: torch.Tensor) -> EncodeState:
    """The CUDA state pass (and its flag counts); same contract as
    ``rans_encode_states_plain``."""
    _check_tensors("rans encode", torch.int32, symbols, ch_map, freq, start,
                   offset)
    b, t, s = symbols.shape
    if ch_map.shape != (t, s):
        raise ValueError(f"rans encode: channel map {tuple(ch_map.shape)} "
                         f"does not match symbols {tuple(symbols.shape)}")
    _check_geometry("rans encode", t, s)
    dev = symbols.device
    lib = load_library()
    chunks = lib.cae_rans_encode_chunks(t, s)
    state = EncodeState(
        words=torch.empty((b, t, s), dtype=torch.uint16, device=dev),
        flags=torch.empty((b, t * (-(-s // 32))), dtype=torch.int32,
                          device=dev),
        final=torch.empty((b, s), dtype=torch.int32, device=dev),
        counts=torch.empty((b, chunks), dtype=torch.int32, device=dev))
    with torch.cuda.device(dev):
        err = lib.cae_rans_encode_states(
            symbols.data_ptr(), ch_map.data_ptr(), freq.data_ptr(),
            start.data_ptr(), offset.data_ptr(), freq.shape[0],
            freq.shape[1], b, t, s, state.words.data_ptr(),
            state.flags.data_ptr(), state.final.data_ptr(),
            state.counts.data_ptr(), stream_handle(symbols))
    check_launch(err, "rans_encode_states")
    encode_states_cuda.launches += 1
    return state


encode_states_cuda.launches = 0
encode_states_cuda.kernel_name = "rans_encode_states"


def compact_cuda(state: EncodeState, capacity: int, out=None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The CUDA compaction; same contract as ``rans_compact_plain``."""
    _check_tensors("rans compaction", torch.uint16, state.words)
    _check_tensors("rans compaction", torch.int32, state.flags, state.final,
                   state.counts)
    b, t, s = state.words.shape
    _check_geometry("rans compaction", t, s)
    _check_capacity(capacity, s)
    lib = load_library()
    chunks = lib.cae_rans_encode_chunks(t, s)
    if (state.flags.shape != (b, t * (-(-s // 32)))
            or state.final.shape != (b, s)
            or state.counts.shape != (b, chunks)):
        raise ValueError(f"rans compaction: flags {tuple(state.flags.shape)}"
                         f", final {tuple(state.final.shape)}, counts "
                         f"{tuple(state.counts.shape)} do not match words "
                         f"{(b, t, s)}")
    dev = state.words.device
    if out is None:
        out = (torch.empty((b, capacity), dtype=torch.uint16, device=dev),
               torch.empty((b,), dtype=torch.int32, device=dev))
    words, totals = out
    if (words.shape != (b, capacity) or totals.shape != (b,)
            or words.device != dev or totals.device != dev):
        raise ValueError(f"rans compaction: out {tuple(words.shape)}, "
                         f"{tuple(totals.shape)} for {b} tiles of capacity "
                         f"{capacity}")
    _check_tensors("rans compaction", torch.uint16, words)
    _check_tensors("rans compaction", torch.int32, totals)
    with torch.cuda.device(dev):
        err = lib.cae_rans_compact(
            state.words.data_ptr(), state.flags.data_ptr(),
            state.final.data_ptr(), state.counts.data_ptr(), b, t, s,
            words.data_ptr(), capacity, totals.data_ptr(),
            stream_handle(words))
    check_launch(err, "rans_compact")
    compact_cuda.launches += 1
    return out


compact_cuda.launches = 0
compact_cuda.kernel_name = "rans_compact"


def rans_encode_states(symbols, ch_map, freq, start, offset) -> EncodeState:
    """Plain version for CPU tensors, kernel for CUDA tensors."""
    if symbols.device.type == "cpu":
        return rans_encode_states_plain(symbols, ch_map, freq, start, offset)
    return encode_states_cuda(symbols, ch_map, freq, start, offset)


def rans_compact(state: EncodeState, capacity: int, out=None):
    """Plain version for CPU tensors, kernel for CUDA tensors."""
    if state.words.device.type == "cpu":
        return rans_compact_plain(state, capacity, out)
    return compact_cuda(state, capacity, out)


# -- decode -----------------------------------------------------------------


def rans_decode_plain(queues: torch.Tensor, ch_map: torch.Tensor,
                      lut: torch.Tensor, num_steps: int) -> torch.Tensor:
    """(B, Q) uint16 word queues -> (B, T, S) int32 value indices (offsets
    not applied).  Reads past a queue's end take its last word."""
    if queues.dtype != torch.uint16:
        raise ValueError(f"rans decode takes uint16 queues, got "
                         f"{queues.dtype}")
    b, qlen = queues.shape
    s = ch_map.shape[1]
    _check_streams(s)
    dev = queues.device
    q = _from_uint16(queues)
    sidx = torch.arange(s, device=dev)
    x = (q[:, (2 * sidx).clamp(max=qlen - 1)]
         | (q[:, (2 * sidx + 1).clamp(max=qlen - 1)] << 16))
    base = torch.full((b, 1), 2 * s, dtype=torch.int64, device=dev)
    lut_u = lut.reshape(-1).long() & _U32
    out = torch.empty((b, num_steps, s), dtype=torch.int32, device=dev)
    for t in range(num_steps):
        cum = x & MASK
        p = lut_u[ch_map[t].long()[None] * PROB_SCALE + cum]
        f = (p & MASK) + 1
        st = (p >> PRECISION) & MASK
        out[:, t] = (p >> 24).to(torch.int32)
        x = (f * (x >> PRECISION) + cum - st) & _U32
        need = x < STATE_MIN
        ni = need.long()
        rank = torch.cumsum(ni, dim=1) - ni
        take = torch.gather(q, 1, (base + rank).clamp(max=qlen - 1))
        x = torch.where(need, ((x << 16) | take) & _U32, x)
        base = base + ni.sum(dim=1, keepdim=True)
    return out


def decode_interleaved_cuda(queues: torch.Tensor, ch_map: torch.Tensor,
                            lut: torch.Tensor, num_steps: int
                            ) -> torch.Tensor:
    """The CUDA decode kernel; same contract as ``rans_decode_plain``."""
    _check_tensors("rans decode", torch.uint16, queues)
    _check_tensors("rans decode", torch.int32, ch_map, lut)
    if ch_map.device != queues.device:
        raise ValueError(f"rans decode: tensors on {ch_map.device} and "
                         f"{queues.device}")
    b, qlen = queues.shape
    s = ch_map.shape[1]
    if ch_map.shape[0] != num_steps:
        raise ValueError(f"rans decode: channel map has {ch_map.shape[0]} "
                         f"steps, expected {num_steps}")
    if lut.dim() != 2 or lut.shape[1] != PROB_SCALE:
        raise ValueError(f"rans decode: LUT must be (C, {PROB_SCALE})")
    _check_geometry("rans decode", num_steps, s)
    if not 1 <= qlen < 1 << 30:
        raise ValueError(f"rans decode: word queue of {qlen} words")
    if lut.data_ptr() % 16:
        lut = lut.clone()  # its rows are staged by 16-byte copies
    dev = queues.device
    out = torch.empty((b, num_steps, s), dtype=torch.int32, device=dev)
    states = torch.empty((b, s), dtype=torch.int32, device=dev)
    lib = load_library()
    with torch.cuda.device(dev):
        err = lib.cae_rans_decode(queues.data_ptr(), b, qlen,
                                  ch_map.data_ptr(), lut.data_ptr(),
                                  lut.shape[0], out.data_ptr(),
                                  states.data_ptr(), num_steps, s,
                                  stream_handle(queues))
    check_launch(err, "rans_decode")
    decode_interleaved_cuda.launches += 1
    return out


decode_interleaved_cuda.launches = 0
decode_interleaved_cuda.kernel_name = "rans_decode"


def rans_decode(queues, ch_map, lut, num_steps):
    """Plain version for CPU tensors, kernel for CUDA tensors."""
    if queues.device.type == "cpu":
        return rans_decode_plain(queues, ch_map, lut, num_steps)
    return decode_interleaved_cuda(queues, ch_map, lut, num_steps)
