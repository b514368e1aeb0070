"""Perspective (OpenCV-convention) camera and projection-matrix
decomposition on NumPy and SciPy (the port's own copy of
data_gen_tpu/camera.py; the reference uses cv2.decomposeProjectionMatrix
and xiuminglib's PerspCam, data_gen/dtu_mvs/*.py)."""

import numpy as np
from scipy.linalg import rq


def decompose_projection(P):
    """3x4 projection matrix -> (K, R, cam_center) with K upper
    triangular (positive diagonal) and R a world-to-camera rotation.

    Matches cv2.decomposeProjectionMatrix semantics: P ~ K [R | -R c].
    """
    P = np.asarray(P, np.float64)
    M = P[:, :3]
    K, R = rq(M)
    # Force positive K diagonal
    signs = np.sign(np.diag(K))
    signs[signs == 0] = 1
    T = np.diag(signs)
    K = K @ T
    R = T @ R
    if np.linalg.det(R) < 0:
        K = -K
        R = -R
    # Camera center: P c_h = 0 (right null vector)
    _, _, vt = np.linalg.svd(P)
    c_h = vt[-1]
    c = c_h[:3] / c_h[3]
    K = K / K[2, 2]
    return K, R, c


class PerspCam:
    """Pinhole camera in the CV convention: x right, y down, z forward.

    ``ext_mat`` is the 3x4 world-to-camera [R | t]; ``int_mat`` the 3x3
    K. ``gen_rays`` shoots one (or spp) rays through each pixel,
    returning (H, W, spp, 3) world-space directions -- same contract the
    reference relies on (surf_from_mvs.py:119-126)."""

    def __init__(self, int_mat, ext_mat, imh=None, imw=None):
        self.int_mat = np.asarray(int_mat, np.float64)
        self.ext_mat = np.asarray(ext_mat, np.float64)
        self.imh = imh if imh is not None else int(
            round(2 * self.int_mat[1, 2]))
        self.imw = imw if imw is not None else int(
            round(2 * self.int_mat[0, 2]))

    @classmethod
    def from_lookat(cls, int_mat, loc, lookat, up=(0, 0, 1), imh=None,
                    imw=None):
        loc = np.asarray(loc, np.float64)
        fwd = np.asarray(lookat, np.float64) - loc
        fwd /= np.linalg.norm(fwd)
        right = np.cross(fwd, np.asarray(up, np.float64))
        right /= np.linalg.norm(right)
        down = np.cross(fwd, right)
        R = np.stack([right, down, fwd], axis=0)  # world -> cam
        t = -R @ loc
        return cls(int_mat, np.concatenate([R, t[:, None]], axis=1),
                   imh=imh, imw=imw)

    @property
    def loc(self):
        R, t = self.ext_mat[:, :3], self.ext_mat[:, 3]
        return -R.T @ t

    def gen_rays(self, spp=1):
        """(H, W, spp, 3) world-space ray directions through pixel
        (sub)samples."""
        sps = int(np.sqrt(spp))
        if sps ** 2 != spp:
            raise ValueError("spp must be a square number, got %r" % spp)
        h, w = self.imh, self.imw
        offs = (np.arange(sps) + 0.5) / sps
        ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing='ij')
        sub = np.stack(np.meshgrid(offs, offs, indexing='ij'),
                       axis=-1).reshape(-1, 2)  # (spp, 2) of (dy, dx)
        px = xs[:, :, None] + sub[None, None, :, 1]
        py = ys[:, :, None] + sub[None, None, :, 0]
        pix_h = np.stack([px, py, np.ones_like(px)], axis=-1)  # (H,W,S,3)
        K_inv = np.linalg.inv(self.int_mat)
        dirs_cam = pix_h @ K_inv.T
        R = self.ext_mat[:, :3]
        dirs_world = dirs_cam @ R  # = R.T applied to each dir
        return dirs_world
