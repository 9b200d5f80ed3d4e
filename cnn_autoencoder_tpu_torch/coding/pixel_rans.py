"""The rANS pixel transport: tiles cross the host<->device link as coded
prediction residuals instead of raw uint8 pixels.

The port's copy of the JAX package's ``coding/pixel_rans.py``, under the
same names, with the frame-v4 machinery of the latent codec:

* fetch (decompress): the reconstruction's left/up-predictor zigzag
  residuals are rANS-coded on the device (K6: the state pass and the
  compaction of ``ops/kernels/rans_kernel.py``, one channel of 256 values,
  ``STREAMS`` streams) with a table calibrated from the content, and the
  host decodes them and inverts the predictor in one C++ pass
  (``csrc/rans.cpp:pixel_rans_decode``);
* upload (compress): the host predicts, zigzags and codes in C++
  (``pixel_rans_encode``), the device decodes (K5) and inverts the
  predictor with two mod-256 prefix sums before the encoder.

Calibration: an upload fits its table from the first batch's host tiles
before anything is dispatched; a fetch decodes one probe batch raw, fits
from its reconstructions and discards the probe's pixels, so every output
batch goes through the same coded path.  The one 12-bit table gives each of
the 256 zigzag values a frequency of at least 1, so nothing escapes and any
content stays decodable.  A batch past its capacity (content far noisier
than the calibration batch) is detected from the true totals and returns
the device's raw pixels: the bytes are the same either way.

On CUDA tensors the coding runs K6 and K5, at any step count; CPU tensors
take their plain versions.  The table lookups run on the device's copy of
the calibrated tables; the host halves use the C++ coder, whose numpy
versions are in ``coding/_rans_py.py``.
"""

import threading
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..ops.kernels.rans_kernel import (PRECISION, PROB_SCALE, pack_dec_lut,
                                       rans_compact, rans_decode,
                                       rans_encode_states)
from ..utils.device import resolve_device
from . import rans
from .device_rans import DeviceTables, pack_streams

STREAMS = 1024          # streams a tile: T = 768 steps for a 512^2 RGB tile
_CAP_BUCKET = 1 << 11   # capacity quantum (words)


class TransportSnapshot(NamedTuple):
    """One consistent view of a calibrated transport: a batch is coded on
    the device and on the host from one snapshot."""
    tables: DeviceTables       # C = 1, support 256, on the device
    dec_lut: torch.Tensor      # (1, 4096) int32 decode LUT, on the device
    freq: np.ndarray           # (256,) int32
    start: np.ndarray          # (256,) int32
    pred_mode: int             # 0 hybrid, 1 plane

    def to(self, device) -> "TransportSnapshot":
        """The same snapshot with its device tables on ``device``."""
        return self._replace(tables=self.tables.to(device),
                             dec_lut=self.dec_lut.to(device))


class RansFetchResult(NamedTuple):
    """A dispatched coded fetch: device outputs and the coding state they
    were made with.  A serving core may refit its transport while a fetch
    job waits, so the job decodes with these tables, not the live ones.
    ``capacity`` is the per-tile word budget: a tile whose total exceeds it
    was cut on the device, so the host takes the raw pixels even when the
    pooled head holds (wrong) words."""
    head: torch.Tensor     # (shards, head_words) uint16: compacted queues
    totals: torch.Tensor   # (B,) int32 true totals
    rec: torch.Tensor      # (B, P, Q, C) uint8 raw pixels (the fallback)
    capacity: int
    freq: np.ndarray       # (256,) table snapshot
    start: np.ndarray
    pred_mode: int = 0


def make_pixel_tables(freq: torch.Tensor, start: torch.Tensor,
                      slot: torch.Tensor) -> DeviceTables:
    """The single-channel, 256-value tables of the transport."""
    dev = freq.device
    return DeviceTables(
        freq=freq, start=start, slot=slot,
        offset=torch.zeros((1,), dtype=torch.int32, device=dev),
        length=torch.full((1,), 256, dtype=torch.int32, device=dev),
        support=256)


# -- device halves ------------------------------------------------------------


def _zigzag(r: torch.Tensor) -> torch.Tensor:
    """uint8 residuals (mod 256) -> int32 zigzag values in [0, 256)."""
    s = r.view(torch.int8).to(torch.int32)
    return ((s << 1) ^ (s >> 7)) & 0xFF


def residual_zigzag_device(tiles_u8: torch.Tensor,
                           mode: int = 0) -> torch.Tensor:
    """(B, P, Q, C) uint8 -> (B, P, Q, C) int32 zigzag residuals, per
    channel, mod 256.  ``mode`` 0: the hybrid predictor (left; up for
    column 0; (0, 0) raw), the bit-plane packer's.  ``mode`` 1: the plane
    predictor (left + up - upleft) in separable form, a vertical then a
    horizontal difference, whose inverse is two prefix sums.  Twin of
    ``csrc/rans.cpp:pixel_predict_zigzag``."""
    x = tiles_u8
    if mode == 1:
        d = torch.cat([x[:, :1], x[:, 1:] - x[:, :-1]], dim=1)
        return _zigzag(torch.cat([d[:, :, :1], d[:, :, 1:] - d[:, :, :-1]],
                                 dim=2))
    b, _, _, c = x.shape
    up_col0 = torch.cat([torch.zeros((b, 1, 1, c), dtype=x.dtype,
                                     device=x.device), x[:, :-1, :1]], dim=1)
    return _zigzag(x - torch.cat([up_col0, x[:, :, :-1]], dim=2))


def unzigzag_unpredict_device(z: torch.Tensor, mode: int = 0) -> torch.Tensor:
    """Inverse of ``residual_zigzag_device``: (B, P, Q, C) int32 zigzag
    values -> uint8 pixels, by two prefix sums mod 256 (a horizontal then
    a vertical one for the plane predictor)."""
    s = ((z >> 1) ^ -(z & 1)) & 0xFF
    if mode == 1:
        h = torch.cumsum(s, dim=2) & 0xFF
        return (torch.cumsum(h, dim=1) & 0xFF).to(torch.uint8)
    # column 0 sums down the rows, the rest of a row across it
    col0 = torch.cumsum(s[:, :, :1], dim=1)
    out = torch.cumsum(s, dim=2) - s[:, :, :1] + col0
    return (out & 0xFF).to(torch.uint8)


def _zero_map(steps: int, device) -> torch.Tensor:
    """The (T, S) channel map of the one-channel transport."""
    return torch.zeros((steps, STREAMS), dtype=torch.int32, device=device)


def encode_residuals_device(tiles_u8: torch.Tensor, tables: DeviceTables,
                            capacity: int, pred_mode: int = 0
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Residuals, then K6 (state pass and compaction): (B, P, Q, C) uint8
    -> ((B, capacity) uint16 word queues, (B,) int32 true totals).  The
    values cover all of 0..255, so nothing escapes; ``totals > capacity``
    flags a tile whose words were cut (the caller fetches raw pixels)."""
    b = tiles_u8.shape[0]
    z = residual_zigzag_device(tiles_u8, pred_mode).reshape(b, -1)
    packed = pack_streams(z, STREAMS).contiguous()       # (B, T, S)
    state = rans_encode_states(packed, _zero_map(packed.shape[1], z.device),
                               tables.freq, tables.start, tables.offset)
    return rans_compact(state, capacity)


def compact_queues_device(bufs: torch.Tensor, totals: torch.Tensor,
                          head_words: int) -> torch.Tensor:
    """Concatenate per-tile queues into one (head_words,) uint16 buffer:
    tile i's words at [exclusive cumsum(totals)[i], + totals[i]), so the
    batch ships as one head without each tile's margin.  Word k is taken
    from the last tile that starts at or before k, as the JAX package's
    ascending row writes leave it; words past the last row read 0.  A
    batch whose words overrun ``head_words`` is the caller's overflow
    case (the totals ship beside it)."""
    b, cap = bufs.shape
    tot = totals.long()
    offs = torch.cumsum(tot, 0) - tot
    k = torch.arange(head_words, device=bufs.device)
    i = torch.searchsorted(offs, k, right=True) - 1
    j = k - offs[i]
    words = bufs.view(torch.int16).reshape(-1)[i * cap + j.clamp(max=cap - 1)]
    return torch.where(j < cap, words, 0).view(torch.uint16)


def compact_host(queues: np.ndarray, totals: np.ndarray,
                 capacity: int) -> Tuple[np.ndarray, np.ndarray]:
    """Concatenate host-coded per-tile queues into one flat buffer:
    (B, capacity) uint16 and per-tile totals -> ((sum(totals),) uint16,
    (B,) int32 offsets).  Only the coded words cross the link (the JAX
    package rounds the buffer up to 2^15 words to bound its recompiles;
    the port has none to bound); the zero tail that keeps each row's read
    in bounds is added on the device by ``expand_queues_device``."""
    b = queues.shape[0]
    totals = np.asarray(totals, np.int64)
    if totals.max() > capacity:
        raise ValueError(
            f"per-tile total {int(totals.max())} exceeds the device "
            f"expansion capacity {capacity}; the expanded row would "
            "truncate this tile's words")
    offs = np.zeros(b, np.int32)
    offs[1:] = np.cumsum(totals[:-1]).astype(np.int32)
    flat = np.empty(int(totals.sum()), np.uint16)
    for i in range(b):
        t = int(totals[i])
        flat[offs[i]:offs[i] + t] = queues[i, :t]
    return flat, offs


def expand_queues_device(flat: torch.Tensor, offsets: torch.Tensor,
                         capacity: int) -> torch.Tensor:
    """Inverse of ``compact_host`` on the device: (F,) uint16 words and
    (B,) offsets -> (B, capacity) uint16 rows.  A row reads on past its
    tile's words into the next tile's or the zero tail added here; the
    decoder consumes exactly each tile's total, stream pads included, so
    those words are never used."""
    padded = torch.cat([flat.view(torch.int16),
                        torch.zeros((capacity,), dtype=torch.int16,
                                    device=flat.device)])
    idx = (offsets.long()[:, None]
           + torch.arange(capacity, device=flat.device))
    return padded[idx].view(torch.uint16)


def decode_residuals_device(queues: torch.Tensor, dec_lut: torch.Tensor,
                            shape: Tuple[int, ...],
                            pred_mode: int = 0) -> torch.Tensor:
    """K5, then the inverse predictor: (B, Q) uint16 word queues ->
    (B, P, Q, C) uint8 pixels of ``shape``'s tile geometry (the batch
    from ``queues``).  ``dec_lut`` is a snapshot's: its table's offset is
    0, so the decoded value indices are the zigzag values."""
    _, p, q, c = shape
    b = queues.shape[0]
    n = p * q * c
    t = -(-n // STREAMS)
    vals = rans_decode(queues, _zero_map(t, queues.device), dec_lut, t)
    z = vals.reshape(b, -1)[:, :n].reshape(b, p, q, c)
    return unzigzag_unpredict_device(z, pred_mode)


# -- host halves and calibration ---------------------------------------------


def residual_hist_host(tiles_u8: np.ndarray, mode: int = 0) -> np.ndarray:
    """(B, P, Q, C) uint8 -> (256,) int64 zigzag-residual histogram (one
    C++ predictor pass)."""
    tiles_u8 = np.ascontiguousarray(tiles_u8, np.uint8)
    b, p, q, c = tiles_u8.shape
    z = np.empty(tiles_u8.size, np.uint8)
    rans.load_library().pixel_predict_zigzag(tiles_u8.reshape(-1), b, p, q,
                                             c, z, mode)
    return np.bincount(z, minlength=256)


def _hist_entropy_bits(hist: np.ndarray) -> float:
    """Shannon entropy (bits a value) of a residual histogram."""
    p = hist.astype(np.float64)
    p = p / max(1.0, p.sum())
    p = p[p > 0]
    return float(-(p * np.log2(p)).sum())


def _quantize_freqs_optimal(hist: np.ndarray,
                            precision: int = PRECISION) -> np.ndarray:
    """Cross-entropy-minimizing integer frequency table of the transport.

    The latent path's ``pmf_to_quantized_cdf`` must keep the reference
    coder's semantics, whose zero-frequency repair steals from the smallest
    bins; the transport's format is the package's own, so it rounds with a
    floor of 1 and walks the total back to 2**precision one unit at a time
    by the best marginal rate (p log2 ratios)."""
    scale = 1 << precision
    p = hist + 1.0                           # +1: every value codable
    p = p / p.sum()
    f = np.maximum(1, np.round(p * scale)).astype(np.int64)
    excess = int(f.sum()) - scale
    while excess > 0:
        mask = f > 1
        cost = np.where(mask, p * np.log2(f / np.maximum(f - 1, 1)), np.inf)
        f[int(np.argmin(cost))] -= 1
        excess -= 1
    while excess < 0:
        gain = p * np.log2((f + 1) / f)
        f[int(np.argmax(gain))] += 1
        excess += 1
    return f.astype(np.int32)


class PixelRansTransport:
    """A calibrated single-table transport shared by a serving core, with
    its device tables on ``device`` (``None``: the card).

    One instance a direction (uploads see raw input noise, fetches smooth
    reconstructions).  Calibration publishes the host table last, and
    ``snapshot`` reads everything under one lock, so pipeline threads see
    a whole table set or none."""

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self.freq: Optional[np.ndarray] = None      # (256,) int32
        self.start: Optional[np.ndarray] = None     # (256,) int32
        self.tables: Optional[DeviceTables] = None  # C = 1 device tables
        self.dec_lut: Optional[torch.Tensor] = None
        self.pred_mode: int = 0                     # 0 hybrid, 1 plane
        self.bits_per_value: float = 8.0
        self.fallbacks = 0   # batches sent raw after an overflow, in all
        self._overflows = 0
        self._lock = threading.Lock()

    def calibrated(self) -> bool:
        return self.freq is not None

    def snapshot(self) -> Optional[TransportSnapshot]:
        """The current tables, or None when uncalibrated.  A batch is coded
        from one snapshot: fields read one by one could interleave with a
        refit and pair device tables with another host table or
        predictor."""
        with self._lock:
            if self.freq is None:
                return None
            return TransportSnapshot(self.tables, self.dec_lut, self.freq,
                                     self.start, self.pred_mode)

    def calibrate(self, hist: np.ndarray, mode: Optional[int] = None) -> None:
        """Fit the table from a residual histogram made with predictor
        ``mode`` (None keeps the current one); a no-op when calibrated (two
        pipeline jobs may both see an invalidated transport)."""
        with self._lock:
            if self.calibrated():
                return
            if mode is not None:
                self.pred_mode = mode
            self._calibrate_locked(hist)

    def calibrate_from_tiles(self, tiles_u8: np.ndarray) -> None:
        """Fit whichever predictor codes these tiles tighter: the hybrid
        (mode 0) wins on noisy content, where a 2-D predictor amplifies
        per-pixel noise, the plane predictor (mode 1) on smooth content
        such as reconstructions."""
        if self.calibrated():
            return
        tiles_u8 = np.ascontiguousarray(tiles_u8, np.uint8)
        hists = [residual_hist_host(tiles_u8, m) for m in (0, 1)]
        mode = int(np.argmin([_hist_entropy_bits(h) for h in hists]))
        with self._lock:
            if self.calibrated():
                return
            self.pred_mode = mode
            self._calibrate_locked(hists[mode])

    def _calibrate_locked(self, hist: np.ndarray) -> None:
        hist = np.asarray(hist, np.float64)
        freq = _quantize_freqs_optimal(hist)
        start = np.concatenate(([0], np.cumsum(freq[:-1]))).astype(np.int32)
        # the cross-entropy of the observed pmf under the quantized table:
        # the bits a value the coder achieves (before the flush words)
        p = hist / max(1.0, hist.sum())
        self.bits_per_value = float(np.sum(
            p * -np.log2(freq.astype(np.float64) / PROB_SCALE)))
        slot = np.repeat(np.arange(256, dtype=np.int32), freq)
        dev = self.device
        self.tables = make_pixel_tables(
            torch.from_numpy(freq[None]).to(dev),
            torch.from_numpy(start[None]).to(dev),
            torch.from_numpy(slot[None]).to(dev))
        self.dec_lut = pack_dec_lut(self.tables.freq, self.tables.start,
                                    self.tables.slot)
        # published last: a reader must never see freq without the tables
        self.start = start
        self.freq = freq

    def capacity(self, n_values: int) -> int:
        """Per-tile word capacity on the device, bucketed.  Its margin costs
        device memory only (uploads ship sum(totals) words, fetches the used
        span of the head), so it is generous: drifting content rarely
        takes the raw fallback."""
        margin = 1.25 + 0.1 * min(4, self._overflows)
        words = 2 * STREAMS + 64 + int(
            n_values * self.bits_per_value / 16.0 * margin)
        return -(-words // _CAP_BUCKET) * _CAP_BUCKET

    def note_overflow(self):
        """Record a capacity overflow (a raw fallback happened).  After 3
        the calibration no longer fits the content: it is invalidated, so
        the next pipeline batch goes raw and refits the table.  Snapshots
        taken before stay whole, and their fallbacks stay right."""
        with self._lock:
            self.fallbacks += 1
            self._overflows += 1
            if self._overflows >= 3:
                self._overflows = 1   # keep slightly widened margins
                self.freq = None      # calibrated() False: refit next batch

    def worthwhile(self, n_values: int) -> bool:
        """Whether a coded tile beats raw on the wire (the flush's 2 *
        STREAMS words can exceed a small or noisy tile's raw bytes)."""
        return 2 * self.estimate_coded_words(n_values, 1) < n_values

    def pooled_head_words(self, n_values: int, batch: int) -> int:
        """Word budget of a batch's compacted fetch head: its margin costs
        device memory, not wire bytes (the host fetches the used span)."""
        margin = 1.08 + 0.04 * min(4, self._overflows)
        words = batch * (2 * STREAMS + 64) + int(
            batch * n_values * self.bits_per_value / 16.0 * margin)
        return -(-words // _CAP_BUCKET) * _CAP_BUCKET

    def worthwhile_fetch(self, n_values: int, batch: int) -> bool:
        """Like ``worthwhile``, for a fetched batch of ``batch`` tiles."""
        return 2 * self.estimate_coded_words(n_values, batch) \
            < batch * n_values

    def calibrate_and_gate_fetch(self, tiles_u8, n_values: int,
                                 batch: int) -> bool:
        """Calibrate from these reconstructions (a no-op when calibrated)
        and report whether the coded fetch beats raw; False means coding
        would expand on the wire and the caller drops the transport."""
        self.calibrate_from_tiles(tiles_u8)
        return self.worthwhile_fetch(n_values, batch)

    def calibrate_and_gate_upload(self, tiles_u8, n_values: int) -> bool:
        """The upload twin of ``calibrate_and_gate_fetch``, from source
        tiles."""
        self.calibrate_from_tiles(tiles_u8)
        return self.worthwhile(n_values)

    def estimate_coded_words(self, n_values: int, batch: int) -> float:
        """Expected coded words of ``batch`` tiles (flush and slack in, no
        margin): the one frame-size formula that the predicted head slice,
        the gates and the pooled budget use."""
        return batch * (n_values * self.bits_per_value / 16.0
                        + 2 * STREAMS + 64)

    def _host_tables(self, freq, start, mode):
        """(freq, start, mode): the given snapshot's, or the live ones.
        Tables without their predictor would decode but invert the wrong
        transform, so they are refused."""
        if freq is None or start is None:
            snap = self.snapshot()
            if snap is None:
                raise RuntimeError(
                    "pixel transport is uncalibrated (or was invalidated by "
                    "an overflow refit); pass the snapshot tables the device "
                    "work was dispatched with")
            return (snap.freq, snap.start,
                    snap.pred_mode if mode is None else mode)
        if mode is None:
            raise ValueError(
                "explicit freq/start require the matching predictor "
                "'mode' (pass snapshot()'s pred_mode alongside)")
        return (np.ascontiguousarray(freq, np.int32),
                np.ascontiguousarray(start, np.int32), mode)

    def decode_host(self, words: np.ndarray, total: int,
                    shape: Tuple[int, int, int, int],
                    freq: Optional[np.ndarray] = None,
                    start: Optional[np.ndarray] = None,
                    mode: Optional[int] = None) -> np.ndarray:
        """uint16 word queue -> (B, P, Q, C) uint8 pixels (one C++ pass).
        A fetch passes the snapshot its device work was dispatched with."""
        freq, start, mode = self._host_tables(freq, start, mode)
        words = np.ascontiguousarray(words[:total], np.uint16)
        out = np.empty(int(np.prod(shape)), np.uint8)
        rc = rans.load_library().pixel_rans_decode(
            words, words.shape[0], freq, start, 256, STREAMS, *shape, out,
            mode)
        if rc != 0:
            raise ValueError("pixel rANS table invalid")
        return out.reshape(shape)

    def encode_host(self, tiles_u8: np.ndarray, capacity: int,
                    freq: Optional[np.ndarray] = None,
                    start: Optional[np.ndarray] = None,
                    mode: Optional[int] = None
                    ) -> Tuple[np.ndarray, np.ndarray]:
        """(B, P, Q, C) uint8 -> ((B, capacity) uint16 queues, (B,) totals),
        one C++ call a tile; a tile past ``capacity`` gets total -1 (the
        caller uploads the batch raw).  The snapshot's tables pin what the
        device decode will use."""
        freq, start, mode = self._host_tables(freq, start, mode)
        tiles_u8 = np.ascontiguousarray(tiles_u8, np.uint8)
        b, p, q, c = tiles_u8.shape
        out = np.zeros((b, capacity), np.uint16)
        totals = np.empty((b,), np.int64)
        lib = rans.load_library()
        for i in range(b):
            t = lib.pixel_rans_encode(tiles_u8[i].reshape(-1), 1, p, q, c,
                                      freq, start, 256, STREAMS, out[i],
                                      capacity, mode)
            if t == -3:
                raise ValueError("pixel rANS table invalid")
            totals[i] = t if t >= 0 else -1
        return out, totals
