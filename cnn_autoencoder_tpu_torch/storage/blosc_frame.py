"""Pure-stdlib blosc1 container framing (zlib inner codec).

The port's own copy of the JAX package's ``storage/blosc_frame.py``: the
blosc1 frame is a 16-byte header, a uint32 block-offset table and one
independently compressed stream per block, and with ``cname='zlib'`` the
inner streams are ordinary zlib data.  This module writes and parses those
frames with stdlib zlib and numpy, so chunks stay readable by c-blosc
readers and writers where the ``blosc`` module is not installed.

Format (c-blosc 1.x, BLOSC_VERSION_FORMAT=2)::

  byte 0   format version (2)
  byte 1   inner-codec format version
  byte 2   flags: bit0 byte-shuffle, bit1 pure-memcpy, bit2 bit-shuffle,
           bits 5-7 compressor code (0 blosclz, 1 lz4, 2 snappy,
           3 zlib, 4 zstd)
  byte 3   typesize
  4-7      nbytes   (uncompressed, LE uint32)
  8-11     blocksize (LE uint32)
  12-15    cbytes   (total frame length, LE uint32)
  16-      if memcpy: the raw buffer; else nblocks LE-uint32 absolute
           block-start offsets, then per block: LE-int32 csize followed
           by the stream (csize == uncompressed block size means the
           block is stored raw — in shuffled order, like c-blosc).

Byte-shuffle is per BLOCK (each block transposed independently before
compression; the sub-typesize tail is copied through), exactly like
c-blosc's shuffle stage.  Only zlib frames are produced; decode accepts
zlib and memcpy frames and raises a clear error for lz4/zstd/blosclz
payloads (their codecs aren't available in this environment).
"""

import struct
import zlib

import numpy as np

FORMAT_VERSION = 2
FLAG_SHUFFLE = 0x1
FLAG_MEMCPY = 0x2
FLAG_BITSHUFFLE = 0x4
# c-blosc splits every full (non-leftover) block into `typesize` equal
# sub-streams — one per shuffled byte lane — unless this flag says not to;
# the decoder recomputes the split count from it (c-blosc blosc.c blosc_d)
FLAG_DONT_SPLIT = 0x10
CODE_BLOSCLZ, CODE_LZ4, CODE_SNAPPY, CODE_ZLIB, CODE_ZSTD = 0, 1, 2, 3, 4
_CODE_NAMES = {0: "blosclz", 1: "lz4", 2: "snappy", 3: "zlib", 4: "zstd"}
_HDR = struct.Struct("<BBBBIII")


def _shuffle(block: bytes, typesize: int) -> bytes:
    n = len(block) - len(block) % typesize
    if n == 0:
        return block
    arr = np.frombuffer(block[:n], np.uint8).reshape(-1, typesize)
    return arr.T.tobytes() + block[n:]


def _unshuffle(block: bytes, typesize: int) -> bytes:
    n = len(block) - len(block) % typesize
    if n == 0:
        return block
    arr = np.frombuffer(block[:n], np.uint8).reshape(typesize, -1)
    return arr.T.tobytes() + block[n:]


def _memcpy_frame(data: bytes, typesize: int) -> bytes:
    header = _HDR.pack(FORMAT_VERSION, 1, FLAG_MEMCPY, typesize,
                       len(data), len(data), len(data) + _HDR.size)
    return header + data


def compress(data, typesize: int = 1, clevel: int = 5, shuffle: int = 1,
             blocksize: int = 0) -> bytes:
    """blosc1-frame data with zlib block streams (c-blosc compatible)."""
    data = bytes(data)
    nbytes = len(data)
    typesize = max(1, min(int(typesize), 255))
    if nbytes == 0:
        return _memcpy_frame(b"", typesize)
    if blocksize <= 0:
        blocksize = 1 << 16
    blocksize -= blocksize % typesize
    blocksize = max(typesize, min(blocksize, nbytes))
    do_shuffle = bool(shuffle) and typesize > 1

    nblocks = -(-nbytes // blocksize)
    streams = []
    for j in range(nblocks):
        block = data[j * blocksize:(j + 1) * blocksize]
        if do_shuffle:
            block = _shuffle(block, typesize)
        comp = zlib.compress(block, clevel)
        if len(comp) >= len(block):
            comp = block  # raw (shuffled) block, marked by csize==neblock
        streams.append(struct.pack("<i", len(comp) if comp is not block
                                   else len(block)) + comp)

    body_len = 4 * nblocks + sum(len(s) for s in streams)
    if _HDR.size + body_len >= _HDR.size + nbytes:
        return _memcpy_frame(data, typesize)

    flags = (CODE_ZLIB << 5) | (FLAG_SHUFFLE if do_shuffle else 0)
    if typesize > 1:
        flags |= FLAG_DONT_SPLIT  # we emit one stream per block
    offsets = []
    pos = _HDR.size + 4 * nblocks
    for s in streams:
        offsets.append(pos)
        pos += len(s)
    header = _HDR.pack(FORMAT_VERSION, 1, flags, typesize, nbytes,
                       blocksize, _HDR.size + body_len)
    return b"".join([header, struct.pack("<%dI" % nblocks, *offsets)]
                    + streams)


def decompress(buf) -> bytes:
    """Parse a blosc1 frame (zlib or memcpy payloads)."""
    buf = bytes(buf)
    if len(buf) < _HDR.size:
        raise ValueError("blosc frame shorter than its header")
    (version, _vlz, flags, typesize, nbytes, blocksize,
     cbytes) = _HDR.unpack_from(buf)
    if version < 1 or version > FORMAT_VERSION:
        raise ValueError("unsupported blosc format version %d" % version)
    if cbytes > len(buf):
        raise ValueError("truncated blosc frame: header claims %d bytes, "
                         "got %d" % (cbytes, len(buf)))
    if flags & FLAG_MEMCPY:
        if len(buf) < _HDR.size + nbytes:
            raise ValueError("memcpy blosc frame shorter than its nbytes "
                             "(%d < %d)" % (len(buf) - _HDR.size, nbytes))
        return buf[_HDR.size:_HDR.size + nbytes]
    code = flags >> 5
    if code != CODE_ZLIB:
        raise ValueError(
            "blosc frame uses compressor %r; only zlib payloads are "
            "decodable in this environment (no %s library)"
            % (_CODE_NAMES.get(code, code), _CODE_NAMES.get(code, code)))
    if flags & FLAG_BITSHUFFLE:
        raise ValueError("bit-shuffled blosc frames are not supported")
    if nbytes == 0:
        return b""
    # untrusted-header plausibility guards (remote stores ship these
    # frames): zlib's theoretical maximum expansion is ~1032:1, so an
    # nbytes far beyond that is an allocation bomb, and the block-offset
    # table must fit inside the frame (also turns struct.error into the
    # documented ValueError).
    if nbytes > 1100 * len(buf):
        raise ValueError(
            "implausible blosc frame: header claims %d bytes from a "
            "%d-byte frame (corrupt or crafted)" % (nbytes, len(buf)))
    blocksize = blocksize or nbytes
    nblocks = -(-nbytes // blocksize)
    if _HDR.size + 4 * nblocks > len(buf):
        raise ValueError("blosc block-offset table overruns the frame "
                         "(%d blocks claimed)" % nblocks)
    offsets = struct.unpack_from("<%dI" % nblocks, buf, _HDR.size)
    do_shuffle = bool(flags & FLAG_SHUFFLE) and typesize > 1
    dont_split = bool(flags & FLAG_DONT_SPLIT)

    def read_block(off, neblock, nsplits):
        parts = []
        for _ in range(nsplits):
            if off + 4 > len(buf):
                raise ValueError("blosc block table overruns the frame")
            (csize,) = struct.unpack_from("<i", buf, off)
            if csize < 0 or off + 4 + csize > len(buf):
                raise ValueError("blosc sub-stream overruns the frame")
            stream = buf[off + 4:off + 4 + csize]
            nesplit = neblock // nsplits
            if csize == nesplit:
                parts.append(stream)
            else:
                # bounded inflation: a crafted stream cannot allocate
                # beyond its declared split size (+1 so an overlong
                # stream still fails the length check below)
                part = zlib.decompressobj().decompress(stream, nesplit + 1)
                parts.append(part)
            off += 4 + csize
        block = b"".join(parts)
        if len(block) != neblock:
            raise ValueError("blosc block decoded to %d bytes, expected %d"
                             % (len(block), neblock))
        return block

    out = []
    for j, off in enumerate(offsets):
        neblock = min(blocksize, nbytes - j * blocksize)
        # full blocks are split into `typesize` equal sub-streams unless
        # the DONT_SPLIT flag says otherwise; leftover blocks are never
        # split.  Writers older than the flag (pre c-blosc 1.14) used
        # extra conditions (typesize/blocksize thresholds) this header
        # cannot express, so on a parse failure retry with the other
        # split interpretation — a wrong guess cannot decode to exactly
        # neblock bytes by accident.
        nsplits = (typesize if typesize > 1 and not dont_split
                   and neblock == blocksize and neblock % typesize == 0
                   else 1)
        try:
            block = read_block(off, neblock, nsplits)
        except (ValueError, zlib.error):
            if nsplits == 1:
                raise
            block = read_block(off, neblock, 1)
        out.append(_unshuffle(block, typesize) if do_shuffle else block)
    return b"".join(out)
