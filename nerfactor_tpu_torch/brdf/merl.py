"""MERL BRDF coordinates (NumPy; counterpart of the parts of
brdf_tpu/merl.py the BRDF prior's test table and visualization use).

The MERL 100 database (Matusik et al. 2003) stores each material as a
(phi_d, theta_h, theta_d) = (180, 90, 90) cube per channel, with a
quadratic mapping along theta_h (reference brdf/merl/merl.py and
third_party/nielsen2015on/coordinateFunctions.py, e.g. the 0.105
half-pixel offset in the theta_h unmapping).
"""

import numpy as np

# BRDF cube layout used throughout: (phi_d, theta_h, theta_d)
BRDF_SHAPE = (180, 90, 90)


def merl_to_rusink(merl_coords):
    """BRDF cube indices -> Rusinkiewicz angles (phi_d, theta_h, theta_d),
    radians."""
    shp = BRDF_SHAPE
    c = np.asarray(merl_coords, dtype=float).reshape(-1, 3).copy()
    c[:, 0] = c[:, 0] / (shp[0] - 1) * np.pi
    c[:, 1] = np.square((c[:, 1] + 0.105) / shp[1]) * (np.pi / 2)
    c[:, 2] = c[:, 2] / (shp[2] - 1) * (np.pi / 2)
    return c


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
