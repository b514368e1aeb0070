"""Self-contained Radiance .hdr (RGBE) reader (the reader of
nerfactor_tpu/utils/hdr.py, so the port loads .hdr probes without the JAX
package).

The reference loads its test light probes from .hdr files via
xiuminglib's io.hdr (nerfactor/models/nerfactor.py:169-179); this image
ships no HDR codec (imageio's freeimage plugin is absent), so the
format is implemented directly: ASCII header, `-Y H +X W` resolution
line, and new-style RLE scanlines of RGBE quadruples.
"""

import numpy as np


def _rgbe_to_float(rgbe):
    """(..., 4) uint8 -> (..., 3) float32, f = ldexp((c+0.5)/256, e-128)."""
    rgbe = rgbe.astype(np.int32)
    exp = rgbe[..., 3]
    scale = np.where(exp == 0, 0.0,
                     np.ldexp(1.0 / 256.0, exp - 128)).astype(np.float64)
    return ((rgbe[..., :3] + 0.5) * scale[..., None]).astype(np.float32)


def read_hdr(path):
    """Reads a Radiance .hdr into an (H, W, 3) float32 array (linear)."""
    with open(path, 'rb') as f:
        magic = f.readline().strip()
        assert magic in (b'#?RADIANCE', b'#?RGBE'), \
            "Not a Radiance HDR file: %s" % path
        while True:
            line = f.readline().strip()
            if not line:
                break  # blank line ends the header
        res = f.readline().decode('ascii').split()
        assert res[0] == '-Y' and res[2] == '+X', \
            "Unsupported HDR orientation: %s" % ' '.join(res)
        h, w = int(res[1]), int(res[3])
        data = f.read()
    img = np.zeros((h, w, 4), np.uint8)
    pos = 0
    for y in range(h):
        if w < 8 or w > 0x7fff or data[pos] != 2 or data[pos + 1] != 2:
            # Flat (non-RLE) scanline
            row = np.frombuffer(data[pos:pos + 4 * w], np.uint8)
            img[y] = row.reshape(w, 4)
            pos += 4 * w
            continue
        assert (data[pos + 2] << 8 | data[pos + 3]) == w, \
            "Scanline width mismatch"
        pos += 4
        for c in range(4):
            x = 0
            while x < w:
                count = data[pos]
                pos += 1
                if count > 128:  # run
                    img[y, x:x + count - 128, c] = data[pos]
                    pos += 1
                    x += count - 128
                else:  # literal
                    img[y, x:x + count, c] = np.frombuffer(
                        data[pos:pos + count], np.uint8)
                    pos += count
                    x += count
    return _rgbe_to_float(img)
