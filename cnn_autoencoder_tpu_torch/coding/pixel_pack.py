"""The bit-plane packer: the other coded fetch of the pixel transport.

The port's copy of the JAX package's ``coding/pixel_pack.py``.  A
reconstructed tile's left/up-predictor residuals are small, so their zigzag
values are packed on the device into bit-planes of 128-value blocks, and
only about w bits a pixel cross the link (w: the bits of a block's largest
value, usually 3 to 6).  The host unpacks and inverts the predictor in C++
(``csrc/rans.cpp:pixel_unpack_blocks``).  The residuals are mod-256
differences and the host's prefix sums invert them exactly, so the pixels
equal a raw fetch's.

Layout of a batch of B tiles of (P, Q, C) uint8, P * Q * C a multiple of
128:

* predictor: p[y, x] - p[y, x-1]; in column 0, p[y, 0] - p[y-1, 0]; p[0, 0]
  raw; per channel (``pixel_rans.residual_zigzag_device`` mode 0);
* zigzag: s -> (s << 1) ^ (s >> 7) as uint8 values;
* blocks of 128 consecutive values (tile-major); each block's width w
  (0..8) and its w bit-planes of 4 uint32 words;
* one word buffer in block order: block b's planes at 4 * (exclusive
  cumsum of w)[b], plane-major (plane k, then word m).

The packer is plain PyTorch on either device, as the JAX package's is jnp:
shifts, small sums and one scatter.  The words are int32 tensors holding
the uint32 words' bits (PyTorch computes little on uint32).
"""

from typing import Tuple

import numpy as np
import torch

from . import _rans_py, rans
from .link_probe import coded_fetch_enabled as packed_fetch_enabled  # noqa
from .pixel_rans import residual_zigzag_device

BLOCK = 128
PLANES = 8


def pack_pixels_device(tiles_u8: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(B, P, Q, C) uint8 -> (words (cap,) int32, widths (NB,) uint8, the
    used word count as a 0-d int32).  ``cap`` is the worst case (raw size
    and a header), so packing never loses."""
    b, p, q, c = tiles_u8.shape
    if (p * q * c) % BLOCK:
        raise ValueError(f"tile size {p}x{q}x{c} is not a multiple of "
                         f"{BLOCK} values")
    nb = b * p * q * c // BLOCK
    dev = tiles_u8.device
    z = residual_zigzag_device(tiles_u8, 0).reshape(nb, 4, 32)
    w = torch.zeros((nb,), dtype=torch.int64, device=dev)
    mx = z.amax(dim=(1, 2))
    for k in range(PLANES):
        w += mx >= (1 << k)
    # plane k of block b -> 4 words; int32 sums of distinct bits are exact
    # mod 2^32, bit 31 included
    lanes = torch.arange(32, dtype=torch.int32, device=dev)
    words = torch.stack([(((z >> k) & 1) << lanes).sum(-1)
                         for k in range(PLANES)], dim=1)       # (NB, 8, 4)
    off = 4 * (torch.cumsum(w, 0) - w)
    kidx = torch.arange(PLANES, device=dev)[None, :, None]
    midx = torch.arange(4, device=dev)[None, None, :]
    cap = nb * 4 * PLANES + 8
    pos = off[:, None, None] + 4 * kidx + midx
    pos = torch.where(kidx < w[:, None, None], pos, cap)       # dropped
    buf = torch.zeros((cap + 1,), dtype=torch.int64, device=dev)
    buf.scatter_(0, pos.reshape(-1), words.reshape(-1) & 0xFFFFFFFF)
    words32 = (buf[:cap] - ((buf[:cap] >> 31) << 32)).to(torch.int32)
    return words32, w.to(torch.uint8), (4 * w.sum()).to(torch.int32)


def head_words(n_blocks: int) -> int:
    """Length of the buffer's prefix fetched with the first copy (6 bits a
    value): one copy in the common case; a batch that packs worse fetches
    its tail with a second."""
    return min(n_blocks * 4 * PLANES + 8,
               -(-(n_blocks * 4 * 6 + 64) // (1 << 14)) * (1 << 14))


def pack_pixels_device_with_head(tiles_u8: torch.Tensor):
    """``pack_pixels_device`` and the prefix of ``head_words``: (head,
    words, widths, total)."""
    buf, widths, total = pack_pixels_device(tiles_u8)
    return buf[:head_words(widths.shape[0])], buf, widths, total


def unpack_pixels_host(words: np.ndarray, widths: np.ndarray,
                       shape: Tuple[int, int, int, int]) -> np.ndarray:
    """Inverse of ``pack_pixels_device`` on the host (C++): ``words`` holds
    at least the used prefix, as int32 or uint32.  Raises when planes lie
    past its end (an under-sized fetch)."""
    b, p, q, c = shape
    out = np.empty((b, p, q, c), np.uint8)
    widths = np.ascontiguousarray(widths, np.uint8)
    words = np.ascontiguousarray(words).view(np.uint32)
    if widths.shape[0] * BLOCK != out.size:
        raise ValueError(f"{widths.shape[0]} blocks for tiles of {shape}")
    truncated = rans.load_library().pixel_unpack_blocks(
        words, words.shape[0], widths, widths.shape[0], b, p, q, c,
        out.reshape(-1))
    if truncated:
        raise ValueError(
            f"packed pixel buffer truncated: {truncated} bit-planes past "
            "the end of the fetched words")
    return out


# the plain version of unpack_pixels_host
_unpack_numpy = _rans_py.pixel_unpack_blocks
