"""Self-contained OpenEXR scanline reader, no codec deps (the reader of
nerfactor_tpu/utils/exr.py, so the port loads .exr probes without the JAX
package).

The reference ingests light probes and rendered buffers from .exr via
xiuminglib's io.exr wrapper around the OpenEXR bindings
(third_party/xiuminglib/xiuminglib/io/exr.py); this image ships neither
OpenEXR nor an imageio EXR plugin, so the format is implemented
directly with NumPy + zlib:

  * single-part scanline files (the only kind the reference deals in);
  * NO_COMPRESSION, ZIPS (1 line/chunk) and ZIP (16 lines/chunk);
  * HALF / FLOAT / UINT channels, increasing-Y line order.

ZIP chunks follow OpenEXR's two-stage scheme: zlib, then an undelta
pass (t[i] += t[i-1] - 128) and a two-half deinterleave.
"""

import struct
import zlib

import numpy as np

_MAGIC = b'\x76\x2f\x31\x01'
_PIXEL_DTYPES = {0: np.uint32, 1: np.float16, 2: np.float32}
_LINES_PER_CHUNK = {0: 1, 2: 1, 3: 16}  # NONE, ZIPS, ZIP


def _read_cstr(buf, pos):
    end = buf.index(b'\x00', pos)
    return buf[pos:end].decode('latin-1'), end + 1


def _parse_chlist(val):
    """chlist attribute -> list of (name, pixel_type, xs, ys)."""
    channels, pos = [], 0
    while val[pos:pos + 1] != b'\x00':
        name, pos = _read_cstr(val, pos)
        ptype, xs, ys = struct.unpack_from('<i4xii', val, pos)
        pos += 16
        channels.append((name, ptype, xs, ys))
    return channels


def _unzip_chunk(data, raw_size):
    if len(data) == raw_size:  # stored raw (zlib would not shrink it)
        return data
    t = np.frombuffer(zlib.decompress(data), np.uint8)
    # undelta: t[i] = t[i-1] + t[i] - 128  (vectorized as a cumsum)
    d = t.astype(np.int64).copy()
    d[1:] -= 128
    t = (np.cumsum(d) & 0xff).astype(np.uint8)
    # deinterleave the two halves
    n = t.size
    out = np.empty(n, np.uint8)
    half = (n + 1) // 2
    out[0::2] = t[:half]
    out[1::2] = t[half:]
    return out.tobytes()


def read_exr_channels(path):
    """Reads a scanline EXR into {channel_name: (H, W) float32/uint32}."""
    with open(path, 'rb') as f:
        buf = f.read()
    assert buf[:4] == _MAGIC, "Not an EXR file: %s" % path
    version = struct.unpack_from('<i', buf, 4)[0]
    assert not (version & 0x200), "Tiled EXR is not supported: %s" % path
    assert not (version & 0x1000), \
        "Multi-part EXR is not supported: %s" % path
    pos = 8
    attrs = {}
    while buf[pos:pos + 1] != b'\x00':
        name, pos = _read_cstr(buf, pos)
        _type, pos = _read_cstr(buf, pos)
        size = struct.unpack_from('<i', buf, pos)[0]
        pos += 4
        attrs[name] = buf[pos:pos + size]
        pos += size
    pos += 1  # header terminator
    channels = _parse_chlist(attrs['channels'])
    compression = attrs['compression'][0]
    assert compression in _LINES_PER_CHUNK, \
        "Unsupported EXR compression %d (only NONE/ZIPS/ZIP)" % compression
    xmin, ymin, xmax, ymax = struct.unpack('<4i', attrs['dataWindow'])
    h, w = ymax - ymin + 1, xmax - xmin + 1
    line_order = attrs.get('lineOrder', b'\x00')[0]
    assert line_order == 0, "Only increasing-Y EXR is supported"
    for name, ptype, xs, ys in channels:
        assert xs == 1 and ys == 1, \
            "Subsampled EXR channels are not supported"

    lpc = _LINES_PER_CHUNK[compression]
    n_chunks = -(-h // lpc)
    pos += 8 * n_chunks  # skip the line offset table; chunks follow
    out = {name: np.empty((h, w), _PIXEL_DTYPES[ptype])
           for name, ptype, _, _ in channels}
    bytes_per_line = sum(
        w * np.dtype(_PIXEL_DTYPES[pt]).itemsize for _, pt, _, _ in channels)
    for _ in range(n_chunks):
        y, size = struct.unpack_from('<ii', buf, pos)
        pos += 8
        data = buf[pos:pos + size]
        pos += size
        y0 = y - ymin
        n_lines = min(lpc, h - y0)
        raw = _unzip_chunk(data, n_lines * bytes_per_line) \
            if compression else data
        off = 0
        for line in range(y0, y0 + n_lines):
            for name, ptype, _, _ in channels:
                dt = np.dtype(_PIXEL_DTYPES[ptype])
                row = np.frombuffer(raw, dt, count=w, offset=off)
                out[name][line] = row
                off += w * dt.itemsize
    return {k: v.astype(np.float32) if v.dtype == np.float16 else v
            for k, v in out.items()}


def read_exr(path):
    """Reads an EXR into an (H, W, 3) float32 RGB array (linear).

    Channel fallbacks mirror common single-channel files: a luminance
    ('Y') or lone channel is broadcast to RGB.
    """
    ch = read_exr_channels(path)
    if all(c in ch for c in 'RGB'):
        return np.stack([ch['R'], ch['G'], ch['B']], axis=-1)
    if 'Y' in ch:
        return np.stack([ch['Y']] * 3, axis=-1).astype(np.float32)
    names = sorted(ch)
    if len(names) >= 3:
        return np.stack([ch[n] for n in names[:3]], axis=-1)
    return np.stack([ch[names[0]]] * 3, axis=-1).astype(np.float32)
