"""Host-side IO: json, npy/npz, globs, output dirs, PNG images
(counterpart of nerfactor_tpu/utils/io.py).

Images are 8- or 16-bit PNGs (and animated PNGs), read and written here
with ``zlib`` and ``struct`` alone, so the port needs no image codec
package (the GPU machine has no ``imageio``). Reading handles all five
PNG filter types; writing uses filter 0 ("None") on every row.
"""

import glob
import json
import os
import shutil
import struct
import zlib
from os.path import dirname, exists

import numpy as np


def read_json(path):
    with open(path, 'r') as h:
        return json.load(h)


def write_json(data, path):
    if dirname(path):
        os.makedirs(dirname(path), exist_ok=True)
    with open(path, 'w') as h:
        json.dump(data, h, indent=4, sort_keys=True)


def load_np(np_f):
    """A .npy array, or the dict of arrays of a .npz."""
    with open(np_f, 'rb') as h:
        if np_f.endswith('.npy'):
            return np.load(h)
        return dict(np.load(h, allow_pickle=True))


def save_np(arr, path):
    os.makedirs(dirname(path), exist_ok=True)
    with open(path, 'wb') as h:
        np.save(h, arr)


def prepare_outdir(outdir, overwrite=False):
    """Creates ``outdir``; an existing one is wiped only with
    ``overwrite`` (else kept as it is, so a run resumes in it)."""
    if os.path.isdir(outdir) and overwrite:
        shutil.rmtree(outdir)
    os.makedirs(outdir, exist_ok=True)


def all_exist(path_dict):
    return all(exists(v) for v in path_dict.values())


def sortglob(directory, filename='*', ext=None):
    """Sorted glob of ``directory/filename[.ext]``; ``ext`` may be a tuple."""
    if ext is None:
        return sorted(glob.glob(os.path.join(directory, filename)))
    if isinstance(ext, str):
        ext = (ext,)
    paths = []
    for e in ext:
        paths += glob.glob(os.path.join(directory,
                                        filename + '.' + e.lstrip('.')))
    return sorted(paths)

_SIGNATURE = b'\x89PNG\r\n\x1a\n'
# PNG color type <-> channel count (gray, RGB, gray+alpha, RGBA)
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}
_COLOR_TYPES = {v: k for k, v in _CHANNELS.items()}


def _unfilter(ftype, line, prev, bpp):
    """Reconstructs one scanline (uint8) from its filtered bytes."""
    if ftype == 0:
        return line
    if ftype == 1:  # Sub: running sum over same-channel bytes
        return (np.cumsum(line.reshape(-1, bpp).astype(np.int64), axis=0)
                % 256).astype(np.uint8).reshape(-1)
    if ftype == 2:  # Up
        return line + prev
    if ftype not in (3, 4):
        raise ValueError("Unknown PNG filter type %d" % ftype)
    out = np.zeros_like(line)
    left = np.zeros(bpp, np.int64)
    up_left = np.zeros(bpp, np.int64)
    for i in range(0, line.size, bpp):
        up = prev[i:i + bpp].astype(np.int64)
        if ftype == 3:  # Average
            pred = (left + up) // 2
        else:  # Paeth
            p = left + up - up_left
            pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - up_left)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, up, up_left))
        cur = (line[i:i + bpp].astype(np.int64) + pred) % 256
        out[i:i + bpp] = cur
        left, up_left = cur, up
    return out


def read_png(path):
    """Decodes a non-interlaced 8/16-bit gray, gray+alpha, RGB or RGBA PNG
    into a uint8/uint16 array: (H, W) for gray, else (H, W, C)."""
    with open(path, 'rb') as f:
        data = f.read()
    if data[:8] != _SIGNATURE:
        raise ValueError("Not a PNG file: %s" % path)
    pos, idat, header = 8, [], None
    while pos < len(data):
        length, ctype = struct.unpack('>I4s', data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if ctype == b'IHDR':
            header = struct.unpack('>IIBBBBB', body)
        elif ctype == b'IDAT':
            idat.append(body)
        elif ctype == b'IEND':
            break
    if header is None:
        raise ValueError("PNG without IHDR: %s" % path)
    w, h, depth, color, _, _, interlace = header
    if depth not in (8, 16) or color not in _CHANNELS or interlace:
        raise ValueError(
            "Unsupported PNG (bit depth %d, color type %d, interlace %d): %s"
            % (depth, color, interlace, path))
    ch = _CHANNELS[color]
    bpp = ch * depth // 8
    raw = np.frombuffer(zlib.decompress(b''.join(idat)), np.uint8)
    raw = raw.reshape(h, w * bpp + 1)
    rows = np.zeros((h, w * bpp), np.uint8)
    prev = rows[0]
    for y in range(h):
        rows[y] = _unfilter(raw[y, 0], raw[y, 1:], prev, bpp)
        prev = rows[y]
    if depth == 16:
        arr = rows.view('>u2').astype(np.uint16).reshape(h, w, ch)
    else:
        arr = rows.reshape(h, w, ch)
    return arr[:, :, 0] if ch == 1 else arr


def _chunk(ctype, body):
    crc = zlib.crc32(ctype + body) & 0xffffffff
    return struct.pack('>I', len(body)) + ctype + body + struct.pack('>I', crc)


def _png_rows(arr):
    """(IHDR body, zlib-compressed scanlines with filter 0) of a
    uint8/uint16 (H, W) or (H, W, 1-4) array."""
    arr = np.asarray(arr)
    if arr.dtype not in (np.uint8, np.uint16):
        raise ValueError("PNG pixels must be uint8 or uint16, got %s"
                         % arr.dtype)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    h, w, ch = arr.shape
    if ch not in _COLOR_TYPES:
        raise ValueError("PNG takes 1-4 channels, got %d" % ch)
    depth = 8 * arr.dtype.itemsize
    rows = arr.astype(arr.dtype.newbyteorder('>')).view(np.uint8)
    raw = np.concatenate(
        [np.zeros((h, 1), np.uint8), rows.reshape(h, -1)], axis=1)
    header = struct.pack('>IIBBBBB', w, h, depth, _COLOR_TYPES[ch], 0, 0, 0)
    return header, zlib.compress(raw.tobytes(), 6)


def write_png(arr, path):
    """Encodes a uint8/uint16 (H, W) or (H, W, 1-4) array as a PNG."""
    header, data = _png_rows(arr)
    with open(path, 'wb') as f:
        f.write(_SIGNATURE + _chunk(b'IHDR', header) + _chunk(b'IDAT', data)
                + _chunk(b'IEND', b''))


def write_apng(frames, path, duration_ms=1000):
    """Encodes same-shaped uint8/uint16 frames as an animated PNG that
    loops forever, each frame shown ``duration_ms``."""
    headers, datas = zip(*(_png_rows(f) for f in frames))
    if len(set(headers)) != 1:
        raise ValueError("APNG frames must share shape and dtype")
    w, h = struct.unpack('>II', headers[0][:8])
    chunks = [_chunk(b'IHDR', headers[0]),
              _chunk(b'acTL', struct.pack('>II', len(frames), 0))]
    seq = 0
    for i, data in enumerate(datas):
        # Full-frame region, no disposal, source blend
        chunks.append(_chunk(b'fcTL', struct.pack(
            '>IIIIIHHBB', seq, w, h, 0, 0, duration_ms, 1000, 0, 0)))
        seq += 1
        if i == 0:
            chunks.append(_chunk(b'IDAT', data))
        else:
            chunks.append(_chunk(b'fdAT', struct.pack('>I', seq) + data))
            seq += 1
    with open(path, 'wb') as f:
        f.write(_SIGNATURE + b''.join(chunks) + _chunk(b'IEND', b''))


def load_img(path, force_rgba=False):
    """Loads a PNG into a float32 array in [0, 1]."""
    arr = read_png(path)
    arr = arr.astype(np.float32) / np.iinfo(arr.dtype).max
    if force_rgba and (arr.ndim == 2 or arr.shape[2] == 3):
        if arr.ndim == 2:
            arr = np.dstack([arr] * 3)
        arr = np.concatenate([arr, np.ones_like(arr[:, :, :1])], axis=2)
    return arr


def write_img(arr_0to1, path, clip=True):
    """Writes a float [0, 1] (or uint8) array as a PNG; returns the uint8
    pixels written."""
    os.makedirs(dirname(path), exist_ok=True)
    arr = np.asarray(arr_0to1)
    if arr.dtype != np.uint8:
        if clip:
            arr = np.clip(arr, 0.0, 1.0)
        arr = (arr * 255).astype(np.uint8)
    write_png(arr, path)
    return arr
