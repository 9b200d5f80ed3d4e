"""Interleaved rANS-32/16 encode and decode of cae_tpu frame v4: the CUDA
kernels in ``csrc/rans.cu`` and their plain PyTorch versions.

Replaces ``cnn_autoencoder_tpu/ops/pallas/rans_kernel.py`` (the encode
kernel ``_make_encode_kernel`` and the decode kernel ``_make_decode_kernel``).
Both directions are bit-identical between kernel, plain version and the JAX
package.  Words are carried as int32 holding 16-bit values, and the plain
versions keep the uint32 state in int64 masked to 32 bits, because PyTorch's
uint16/uint32 arithmetic is thin.

Shapes: symbols (B, T, S) int32, the per-(step, stream) channel map (T, S)
int32, encode tables ``freq``/``start`` (C, L) int32 with ``offset`` (C,),
the decode LUT (C, 4096) int32 packed ``slot<<24 | start<<12 | (freq-1)``.
The kernels take any S from 1 to 1024 and the full (T, S) channel map, so
every geometry the codec produces runs on them; S > 1024 raises.
"""

from typing import Tuple

import torch

from .build import check_launch, load_library, stream_handle

PRECISION = 12
PROB_SCALE = 1 << PRECISION
MASK = PROB_SCALE - 1
STATE_MIN = 1 << 16
EMIT_SHIFT = 20
MAX_STREAMS = 1024
_U32 = 0xFFFFFFFF


def pack_dec_lut(freq: torch.Tensor, start: torch.Tensor,
                 slot: torch.Tensor) -> torch.Tensor:
    """(C, 4096) int32 decode LUT: cum -> slot<<24 | start<<12 | (freq-1)."""
    st_at = torch.gather(start.long(), 1, slot.long())
    fq_at = torch.gather(freq.long(), 1, slot.long())
    packed = (slot.long() << 24) | (st_at << PRECISION) | (fq_at - 1)
    # reinterpret the uint32 pattern as int32
    return (packed - ((packed >> 31) << 32)).to(torch.int32)


def _check_capacity(capacity: int, s: int) -> None:
    if capacity < 2 * s:
        raise ValueError(
            f"capacity {capacity} < flush width {2 * s}: capacity counts "
            "TOTAL words including the 2S-word flush")


# -- encode -----------------------------------------------------------------


def rans_encode_plain(symbols: torch.Tensor, ch_map: torch.Tensor,
                      freq: torch.Tensor, start: torch.Tensor,
                      offset: torch.Tensor, capacity: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, T, S) symbols -> ((B, capacity) int32 words in decode order,
    (B,) int32 total words).  Words past ``capacity`` are dropped: the
    caller checks ``totals <= capacity``.  Out-of-table symbols are clipped
    (the caller counts escapes)."""
    b, t, s = symbols.shape
    _check_capacity(capacity, s)
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

    flat = flags.reshape(b, -1).long()
    pos = 2 * s + torch.cumsum(flat, dim=1) - flat
    totals = 2 * s + flat.sum(dim=1)
    # words at or past capacity land in a spill column that is cut away
    pos = torch.where((flat > 0) & (pos < capacity), pos,
                      torch.full_like(pos, capacity))
    buf = torch.zeros((b, capacity + 1), dtype=torch.int64,
                      device=symbols.device)
    buf.scatter_(1, pos, words.reshape(b, -1) * flat)
    buf[:, 0:2 * s:2] = x & 0xFFFF
    buf[:, 1:2 * s:2] = x >> 16
    return buf[:, :capacity].to(torch.int32), totals.to(torch.int32)


def encode_interleaved_cuda(symbols: torch.Tensor, ch_map: torch.Tensor,
                            freq: torch.Tensor, start: torch.Tensor,
                            offset: torch.Tensor, capacity: int
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The CUDA encode kernel plus its front-aligning epilogue; same
    contract as ``rans_encode_plain``."""
    _check_tensors("rans encode", symbols, ch_map, freq, start, offset)
    b, t, s = symbols.shape
    if ch_map.shape != (t, s):
        raise ValueError(f"rans encode: channel map {tuple(ch_map.shape)} "
                         f"does not match symbols {tuple(symbols.shape)}")
    _check_streams(s)
    _check_capacity(capacity, s)
    dev = symbols.device
    capw = t * s  # worst case: one word per symbol
    queue = torch.empty((b, capw), dtype=torch.int32, device=dev)
    backs = torch.empty((b,), dtype=torch.int32, device=dev)
    xfin = torch.empty((b, s), dtype=torch.int32, device=dev)
    lib = load_library()
    with torch.cuda.device(dev):
        err = lib.cae_rans_encode(
            symbols.data_ptr(), ch_map.data_ptr(), freq.data_ptr(),
            start.data_ptr(), offset.data_ptr(), freq.shape[1], b,
            queue.data_ptr(), capw, backs.data_ptr(), xfin.data_ptr(), t, s,
            stream_handle(symbols))
    check_launch(err, "rans_encode")
    encode_interleaved_cuda.launches += 1

    # epilogue: flush words, then the back-aligned payload front-aligned
    back = backs.long()
    x = xfin.long() & _U32
    buf = torch.zeros((b, capacity), dtype=torch.int32, device=dev)
    buf[:, 0:2 * s:2] = (x & 0xFFFF).to(torch.int32)
    buf[:, 1:2 * s:2] = (x >> 16).to(torch.int32)
    j = torch.arange(capacity - 2 * s, device=dev)[None]
    src = (capw - back[:, None] + j).clamp(max=capw - 1)
    payload = torch.gather(queue, 1, src)
    buf[:, 2 * s:] = torch.where(j < back[:, None], payload,
                                 torch.zeros_like(payload))
    return buf, (2 * s + back).to(torch.int32)


encode_interleaved_cuda.launches = 0
encode_interleaved_cuda.kernel_name = "rans_encode"


def rans_encode(symbols, ch_map, freq, start, offset, capacity):
    """Plain version for CPU tensors, kernel for CUDA tensors."""
    if symbols.device.type == "cpu":
        return rans_encode_plain(symbols, ch_map, freq, start, offset,
                                 capacity)
    return encode_interleaved_cuda(symbols, ch_map, freq, start, offset,
                                   capacity)


# -- decode -----------------------------------------------------------------


def rans_decode_plain(queues: torch.Tensor, ch_map: torch.Tensor,
                      lut: torch.Tensor, num_steps: int) -> torch.Tensor:
    """(B, Q) int32 word queues -> (B, T, S) int32 value indices (offsets
    not applied).  Reads past a queue's end take its last word."""
    b, qlen = queues.shape
    s = ch_map.shape[1]
    dev = queues.device
    q = queues.long()
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
    _check_tensors("rans decode", queues, ch_map, lut)
    b, qlen = queues.shape
    s = ch_map.shape[1]
    if ch_map.shape[0] != num_steps:
        raise ValueError(f"rans decode: channel map has {ch_map.shape[0]} "
                         f"steps, expected {num_steps}")
    if lut.dim() != 2 or lut.shape[1] != PROB_SCALE:
        raise ValueError(f"rans decode: LUT must be (C, {PROB_SCALE})")
    _check_streams(s)
    if qlen < 1:
        raise ValueError("rans decode: empty word queue")
    out = torch.empty((b, num_steps, s), dtype=torch.int32,
                      device=queues.device)
    lib = load_library()
    with torch.cuda.device(queues.device):
        err = lib.cae_rans_decode(queues.data_ptr(), b, qlen,
                                  ch_map.data_ptr(), lut.data_ptr(),
                                  out.data_ptr(), num_steps, s,
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


def _check_streams(s: int) -> None:
    if not 1 <= s <= MAX_STREAMS:
        raise ValueError(f"rans kernels take 1..{MAX_STREAMS} streams per "
                         f"tile (one thread each), got {s}")


def _check_tensors(name: str, *tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name} kernel takes CUDA tensors, got {dev}")
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"{name} takes contiguous int32 tensors, got "
                             f"{t.dtype} {tuple(t.shape)}")
