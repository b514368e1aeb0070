"""MERL BRDF database on NumPy: the binary reader, one material's table
and nearest-neighbour lookup, and the coordinate transforms (counterpart
of brdf_tpu/merl.py).

The MERL 100 database (Matusik et al. 2003) stores each material as a
(phi_d, theta_h, theta_d) = (180, 90, 90) cube per channel, with a
quadratic mapping along theta_h (reference brdf/merl/merl.py and
third_party/nielsen2015on/coordinateFunctions.py, e.g. the 0.105
half-pixel offset in the theta_h unmapping). Public format: three int32
dims, then float64 values, channel-major, with per-channel scales (1.0,
1.15, 1.66) / 1500.
"""

from os.path import basename

import numpy as np

# BRDF cube layout used throughout: (phi_d, theta_h, theta_d)
BRDF_SHAPE = (180, 90, 90)
_CHANNEL_SCALES = np.array([1.0, 1.15, 1.66]) / 1500.0


def read_merl_brdf(path):
    """Reads a .binary MERL file into a (180, 90, 90, 3) float64 cube laid
    out as (phi_d, theta_h, theta_d, rgb). Invalid entries are
    negative."""
    with open(path, 'rb') as h:
        dims = np.fromfile(h, dtype=np.int32, count=3)
        n = int(np.prod(dims))
        if n != int(np.prod(BRDF_SHAPE)):
            raise ValueError("Unexpected MERL dims %s in %s" % (dims, path))
        vals = np.fromfile(h, dtype=np.float64, count=3 * n)
    # Native layout: channel-major, (theta_h, theta_d, phi_d)
    cube = vals.reshape(3, 90, 90, 180) * _CHANNEL_SCALES[:, None, None, None]
    return np.transpose(cube, (3, 1, 2, 0))


def write_merl_brdf(path, cube):
    """Writes a (180, 90, 90, 3) (phi_d, theta_h, theta_d, rgb) cube as a
    .binary MERL file, the inverse of :func:`read_merl_brdf`."""
    native = np.transpose(np.asarray(cube, np.float64), (3, 1, 2, 0)) \
        / _CHANNEL_SCALES[:, None, None, None]
    with open(path, 'wb') as h:
        np.array([90, 90, 180], np.int32).tofile(h)
        native.ravel().tofile(h)


def merl_to_rusink(merl_coords):
    """BRDF cube indices -> Rusinkiewicz angles (phi_d, theta_h, theta_d),
    radians."""
    shp = BRDF_SHAPE
    c = np.asarray(merl_coords, dtype=float).reshape(-1, 3).copy()
    c[:, 0] = c[:, 0] / (shp[0] - 1) * np.pi
    c[:, 1] = np.square((c[:, 1] + 0.105) / shp[1]) * (np.pi / 2)
    c[:, 2] = c[:, 2] / (shp[2] - 1) * (np.pi / 2)
    return c


def merl_rusink_grid():
    """(180 * 90 * 90, 3) Rusinkiewicz angles of every cube entry, in the
    cube's C order."""
    ind = np.indices(BRDF_SHAPE).reshape(3, -1).T
    return merl_to_rusink(ind)


class MERL:
    """One MERL material read from ``path``: its (rusink | rgb) table of
    valid entries and a nearest-neighbour lookup in it."""

    def __init__(self, path):
        self.name = basename(path)[:-len('.binary')]
        self.cube_rgb = read_merl_brdf(path)
        rusink_rgb = np.hstack((merl_rusink_grid(),
                                self.cube_rgb.reshape(-1, 3)))
        # (n_valid, 6): rows with an invalid (negative) channel dropped
        self.tbl = rusink_rgb[(rusink_rgb[:, 3:] > 0).all(axis=1)]
        self._kdtree = None

    def get_characterstic_slice(self):
        """The phi_d = 90 deg slice of reflectance, rotated so theta_d is
        vertical: (90, 90, 3)."""
        cslice = self.cube_rgb[self.cube_rgb.shape[0] // 2]
        return np.rot90(cslice, axes=(0, 1))

    def query(self, qrusink):
        """Nearest-neighbour reflectance (rows of rgb) of each row of
        Rusinkiewicz angles, through a k-d tree over the table (scipy's
        cKDTree, queried on every core: the same neighbours as one
        worker)."""
        from scipy.spatial import cKDTree
        if self._kdtree is None:
            self._kdtree = cKDTree(self.tbl[:, :3])
        _, ind = self._kdtree.query(qrusink, workers=-1)
        return self.tbl[ind, 3:]


def dirs_to_rusink(a, b):
    """(N, 3) directions in local frames -> (N, 3) Rusinkiewicz angles,
    phi_d in [0, pi) (NumPy twin of ops.geom.dir2rusink)."""
    def normalize(x):
        return x / np.linalg.norm(x, axis=-1, keepdims=True)

    def rot_vec(vec, axis, angle):
        axis = np.asarray(axis, dtype=float).reshape(1, 3)
        cos_a = np.cos(angle).reshape(-1, 1)
        sin_a = np.sin(angle).reshape(-1, 1)
        dot = vec @ axis.T
        return vec * cos_a + axis * dot * (1 - cos_a) \
            + np.cross(np.broadcast_to(axis, vec.shape), vec) * sin_a

    a = normalize(np.asarray(a, float).reshape(-1, 3))
    b = normalize(np.asarray(b, float).reshape(-1, 3))
    h = normalize((a + b) / 2)
    theta_h = np.arccos(np.clip(h[:, 2], -1, 1))
    phi_h = np.arctan2(h[:, 1], h[:, 0])
    diff = rot_vec(rot_vec(b, (0, 0, 1), -phi_h), (0, 1, 0), -theta_h)
    theta_d = np.arccos(np.clip(diff[:, 2], -1, 1))
    phi_d = np.mod(np.arctan2(diff[:, 1], diff[:, 0]), np.pi)
    return np.column_stack((phi_d, theta_h, theta_d))


def dir2rusink(ldir, vdir):
    """ldir (H, W, L, 3), vdir (H, W, 3), both in local frames -> (H, W,
    L, 3) Rusinkiewicz angles of every (pixel, light) pair."""
    vdir_rep = np.tile(vdir[:, :, None, :], (1, 1, ldir.shape[2], 1))
    rusink = dirs_to_rusink(vdir_rep.reshape(-1, 3), ldir.reshape(-1, 3))
    return rusink.reshape(ldir.shape)


def characteristic_slice_rusink():
    """(theta_d, theta_h) = (90, 90, 3) angles of the phi_d = 90 deg
    slice, rotated so theta_d is vertical."""
    ind = np.indices(BRDF_SHAPE[1:])  # theta_h, theta_d
    phi_i = np.full_like(ind[0], BRDF_SHAPE[0] // 2)
    coords = np.stack((phi_i, ind[0], ind[1]), axis=-1)
    rusink = merl_to_rusink(coords).reshape(BRDF_SHAPE[1:] + (3,))
    return np.rot90(rusink, axes=(0, 1))


def characteristic_slice_as_img(cslice, clip_percentile=80, gamma=2.2):
    """A characteristic slice of reflectance as a gamma-encoded uint8
    image, clipped at its ``clip_percentile``-th percentile."""
    maxv = np.percentile(cslice, clip_percentile)
    if maxv <= 0:
        maxv = max(cslice.max(), 1e-8)
    cslice_0to1 = np.clip(cslice, 0, maxv) / maxv
    cslice_gamma = np.power(cslice_0to1, 1 / gamma)
    return (cslice_gamma * 255).astype(np.uint8)
