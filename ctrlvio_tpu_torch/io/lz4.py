"""Pure-Python LZ4: block codec + frame (and legacy-frame) container (the
port's own copy of `ctrlvio_tpu/io/lz4.py`).

rosbag writes lz4-compressed chunks through roslz4, which emits the LZ4
Frame format (magic 0x184D2204). This module removes the last external
dependency of the no-ROS ingest path (`io/rosbag.py` — the reference links
rosbag/roslz4 C++ instead, `odometry_manager.cpp:97-126`): a spec-complete
decoder (block format, frame format incl. xxh32 header/block/content
checksums, legacy frame) plus a greedy hash-table compressor used by the
test fixtures and the converter.

Formats: https://github.com/lz4/lz4/blob/dev/doc/lz4_Block_format.md and
lz4_Frame_format.md. Pure CPython (~5 MB/s): fine for fixtures and
moderate bags; a production pipeline would swap in a C codec behind the
same two functions.
"""

from __future__ import annotations

import struct

_u32 = struct.Struct("<I")
_u16 = struct.Struct("<H")
_u64 = struct.Struct("<Q")

FRAME_MAGIC = 0x184D2204
LEGACY_MAGIC = 0x184C2102
_M32 = 0xFFFFFFFF

# ---------------------------------------------------------------------------
# xxHash32 (checksums inside the frame format)
# ---------------------------------------------------------------------------

_P1, _P2, _P3, _P4, _P5 = (2654435761, 2246822519, 3266489917,
                           668265263, 374761393)


def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & _M32


def xxh32(data: bytes, seed: int = 0) -> int:
    n = len(data)
    i = 0
    if n >= 16:
        v1 = (seed + _P1 + _P2) & _M32
        v2 = (seed + _P2) & _M32
        v3 = seed
        v4 = (seed - _P1) & _M32
        lim = n - 16
        while i <= lim:
            (l1, l2, l3, l4) = struct.unpack_from("<IIII", data, i)
            v1 = (_rotl((v1 + l1 * _P2) & _M32, 13) * _P1) & _M32
            v2 = (_rotl((v2 + l2 * _P2) & _M32, 13) * _P1) & _M32
            v3 = (_rotl((v3 + l3 * _P2) & _M32, 13) * _P1) & _M32
            v4 = (_rotl((v4 + l4 * _P2) & _M32, 13) * _P1) & _M32
            i += 16
        h = (_rotl(v1, 1) + _rotl(v2, 7) + _rotl(v3, 12) + _rotl(v4, 18)) & _M32
    else:
        h = (seed + _P5) & _M32
    h = (h + n) & _M32
    while i + 4 <= n:
        (lane,) = _u32.unpack_from(data, i)
        h = (_rotl((h + lane * _P3) & _M32, 17) * _P4) & _M32
        i += 4
    while i < n:
        h = (_rotl((h + data[i] * _P5) & _M32, 11) * _P1) & _M32
        i += 1
    h ^= h >> 15
    h = (h * _P2) & _M32
    h ^= h >> 13
    h = (h * _P3) & _M32
    h ^= h >> 16
    return h


# ---------------------------------------------------------------------------
# Block format
# ---------------------------------------------------------------------------

def decompress_block(src: bytes) -> bytes:
    """Decode one raw LZ4 block (sequences of literals + back-references)."""
    out = bytearray()
    i, n = 0, len(src)
    while i < n:
        token = src[i]
        i += 1
        ll = token >> 4
        if ll == 15:
            while True:
                b = src[i]
                i += 1
                ll += b
                if b != 255:
                    break
        out += src[i:i + ll]
        i += ll
        if i >= n:  # last sequence: literals only
            break
        off = _u16.unpack_from(src, i)[0]
        i += 2
        if off == 0:
            raise ValueError("lz4: zero match offset")
        ml = token & 15
        if ml == 15:
            while True:
                b = src[i]
                i += 1
                ml += b
                if b != 255:
                    break
        ml += 4
        start = len(out) - off
        if start < 0:
            raise ValueError("lz4: match offset before block start")
        if off >= ml:
            out += out[start:start + ml]
        else:  # overlapping match: byte-wise semantics (run extension)
            for k in range(ml):
                out.append(out[start + k])
    return bytes(out)


def _write_seq(out: bytearray, lit: bytes, ml: int = -1, off: int = 0):
    ll = len(lit)
    tok_l = 15 if ll >= 15 else ll
    tok_m = 0 if ml < 0 else (15 if ml - 4 >= 15 else ml - 4)
    out.append((tok_l << 4) | tok_m)
    if ll >= 15:
        r = ll - 15
        while r >= 255:
            out.append(255)
            r -= 255
        out.append(r)
    out += lit
    if ml >= 0:
        out += _u16.pack(off)
        if ml - 4 >= 15:
            r = ml - 4 - 15
            while r >= 255:
                out.append(255)
                r -= 255
            out.append(r)


def compress_block(src: bytes) -> bytes:
    """Greedy hash-table LZ4 block compressor (spec-conformant: the last
    5 bytes are literals; no match starts within 12 bytes of the end)."""
    n = len(src)
    out = bytearray()
    if n < 13:
        _write_seq(out, src)
        return bytes(out)
    table: dict = {}
    i = anchor = 0
    limit = n - 12
    while i <= limit:
        key = src[i:i + 4]
        j = table.get(key, -1)
        table[key] = i
        if j >= 0 and i - j <= 65535:
            m, p = i + 4, j + 4
            end = n - 5
            while m < end and src[m] == src[p]:
                m += 1
                p += 1
            _write_seq(out, src[anchor:i], m - i, i - j)
            anchor = i = m
        else:
            i += 1
    _write_seq(out, src[anchor:])
    return bytes(out)


# ---------------------------------------------------------------------------
# Frame format
# ---------------------------------------------------------------------------

def decompress_frame(buf: bytes) -> bytes:
    """Decode an LZ4 Frame (or legacy frame) stream, verifying xxh32
    checksums where present. Accepts concatenated frames."""
    out = bytearray()
    o, n = 0, len(buf)
    while o + 4 <= n:
        (magic,) = _u32.unpack_from(buf, o)
        o += 4
        if magic == LEGACY_MAGIC:
            # legacy: blocks of <u32 size><lz4 block> until EOF/next magic
            while o + 4 <= n:
                (bs,) = _u32.unpack_from(buf, o)
                if bs in (FRAME_MAGIC, LEGACY_MAGIC):
                    break
                o += 4
                out += decompress_block(buf[o:o + bs])
                o += bs
            continue
        if magic != FRAME_MAGIC:
            raise ValueError(f"lz4: bad magic {magic:#x}")
        hdr_start = o
        flg = buf[o]
        bd = buf[o + 1]
        o += 2
        if (flg >> 6) != 0b01:
            raise ValueError("lz4: unsupported frame version")
        b_checksum = bool(flg & 0x10)
        c_size = bool(flg & 0x08)
        c_checksum = bool(flg & 0x04)
        dict_id = bool(flg & 0x01)
        del bd
        if c_size:
            o += 8
        if dict_id:
            o += 4
        hc = buf[o]
        o += 1
        if ((xxh32(buf[hdr_start:o - 1]) >> 8) & 0xFF) != hc:
            raise ValueError("lz4: frame header checksum mismatch")
        frame_out_start = len(out)
        while True:
            (bsize,) = _u32.unpack_from(buf, o)
            o += 4
            if bsize == 0:  # EndMark
                break
            uncompressed = bool(bsize & 0x80000000)
            bsize &= 0x7FFFFFFF
            block = buf[o:o + bsize]
            o += bsize
            if b_checksum:
                (bc,) = _u32.unpack_from(buf, o)
                o += 4
                if xxh32(block) != bc:
                    raise ValueError("lz4: block checksum mismatch")
            out += block if uncompressed else decompress_block(block)
        if c_checksum:
            (cc,) = _u32.unpack_from(buf, o)
            o += 4
            if xxh32(bytes(out[frame_out_start:])) != cc:
                raise ValueError("lz4: content checksum mismatch")
    return bytes(out)


def compress_frame(data: bytes, block_size: int = 1 << 16,
                   content_checksum: bool = True) -> bytes:
    """Encode an LZ4 Frame (block-independent, 64 KB blocks, content
    checksum) — what roslz4-written bag chunks look like."""
    flg = (0b01 << 6) | 0x20 | (0x04 if content_checksum else 0)
    bd = 0x40  # block max size id 4 (64 KB)
    hdr = bytes([flg, bd])
    out = bytearray(_u32.pack(FRAME_MAGIC))
    out += hdr
    out.append((xxh32(hdr) >> 8) & 0xFF)
    for i in range(0, max(len(data), 1), block_size):
        block = data[i:i + block_size]
        comp = compress_block(block)
        if len(comp) < len(block):
            out += _u32.pack(len(comp)) + comp
        else:
            out += _u32.pack(0x80000000 | len(block)) + block
    out += _u32.pack(0)  # EndMark
    if content_checksum:
        out += _u32.pack(xxh32(data))
    return bytes(out)
