"""Light sphere and light probes (counterpart of
nerfactor_tpu/ops/light.py).

The light parameterization is the contract shared with the JAX package
and the reference (brdf/renderer.py:184-219): an equirectangular sphere
of h x 2h pixels plus per-pixel solid angles. Host-side NumPy throughout.
"""

from collections import OrderedDict

import numpy as np

from nerfactor_tpu_torch.ops import img as imgops
from nerfactor_tpu_torch.utils import exr as exrutil, hdr as hdrutil


def gen_light_xyz(envmap_h, envmap_w, envmap_radius=1e2):
    """World XYZ (h, w, 3) of every environment-map pixel and its solid
    angle (h, w), float64; the solid angles sum to 4 pi."""
    # OpenEXR "latlong": lat in [pi/2, -pi/2] top-down, lng in [pi, -pi]
    # left-right; polar rows/seam columns are excluded by the step offsets
    lat_step_size = np.pi / (envmap_h + 2)
    lng_step_size = 2 * np.pi / (envmap_w + 2)
    lats = np.linspace(
        np.pi / 2 - lat_step_size, -np.pi / 2 + lat_step_size, envmap_h)
    lngs = np.linspace(
        np.pi - lng_step_size, -np.pi + lng_step_size, envmap_w)
    lngs, lats = np.meshgrid(lngs, lats)
    z = envmap_radius * np.sin(lats)
    x = envmap_radius * np.cos(lats) * np.cos(lngs)
    y = envmap_radius * np.cos(lats) * np.sin(lngs)
    xyz = np.dstack((x, y, z))
    sin_colat = np.sin(np.pi / 2 - lats)
    areas = 4 * np.pi * sin_colat / np.sum(sin_colat)
    return xyz, areas


def make_olat_envmaps(light_h, light_w, olat_inten=200.0, ambient_inten=0.0,
                      limit=None):
    """Ordered dict name -> (h, w, 3) one-light-at-a-time map, named
    '%04d-%04d' by pixel, optionally over an ambient floor."""
    olat = OrderedDict()
    ambient = ambient_inten * np.ones((light_h, light_w, 3), dtype=np.float32)
    n_i = light_h if limit is None else min(limit, light_h)
    n_j = light_w if limit is None else min(limit, light_w)
    for i in range(n_i):
        for j in range(n_j):
            envmap = np.zeros((light_h, light_w, 3), dtype=np.float32)
            envmap[i, j, :] = olat_inten
            olat['%04d-%04d' % (i, j)] = envmap + ambient
    return olat


def vis_light(light_probe, h=None, gamma=4.0):
    """Tonemaps an HDR light probe to a uint8 thumbnail (gamma tonemap,
    reference util/light.py:27-45)."""
    light_probe = np.asarray(light_probe, dtype=np.float32)
    if h is not None and light_probe.shape[0] != h:
        light_probe = imgops.resize(light_probe, new_h=h)
    maxv = light_probe.max()
    norm = light_probe / maxv if maxv > 0 else light_probe
    img = np.power(norm, 1.0 / gamma)
    return (np.clip(img, 0.0, 1.0) * 255).astype(np.uint8)


def load_light(path, envmap_inten=1.0, envmap_h=None):
    """Loads a light probe (.npy, .hdr or .exr, the kinds the test CLI
    globs for; or 'point', the sphere renderer's small square light, of
    height ``envmap_h`` or 16), optionally resized and scaled (reference
    brdf/renderer.py:222-249)."""
    if path == 'point':
        h = 16 if envmap_h is None else envmap_h
        envmap = np.zeros((h, 2 * h, 3), dtype=np.float32)
        i, j, d = -h // 4, -int(2 * h * 7 / 8), 2
        envmap[(i - d):(i + d), (j - d):(j + d), :] = 1
    elif path.endswith('.npy'):
        envmap = np.load(path).astype(np.float32)
    elif path.endswith('.hdr'):
        envmap = hdrutil.read_hdr(path)
    elif path.endswith('.exr'):
        envmap = exrutil.read_exr(path)
    else:
        raise ValueError("Unsupported light probe: %s" % path)
    if envmap_h is not None and envmap.shape[0] != envmap_h:
        envmap = imgops.resize(envmap, new_h=envmap_h)
    return envmap_inten * envmap
