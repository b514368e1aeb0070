"""NumPy sphere renderer for BRDF visualization and the prior's test
table (counterpart of brdf_tpu/renderer.py, on the port's light and IO
helpers).

Renders a sphere at the origin, viewed from -Z, under a light-stage
approximation of an environment map (direct illumination only), as
brdf/renderer.py:23-181 of the reference. Host-side and offline.
"""

from os.path import join

import numpy as np

from nerfactor_tpu_torch.ops.light import gen_light_xyz, load_light, vis_light
from nerfactor_tpu_torch.utils import io as ioutil


def _normalize(x, axis=-1):
    return x / np.linalg.norm(x, axis=axis, keepdims=True)


def _gen_world2local_np(normal):
    """World->local frames (rows: tangent, binormal, normal); normals
    must not be colinear with +Z."""
    t = np.cross(normal, np.array((0, 0, 1), dtype=float))
    if (t == 0).all(axis=-1).any():
        raise ValueError("Found zero tangents (normal colinear with +Z?)")
    t = _normalize(t)
    b = np.cross(normal, t)
    return np.stack((t, b, normal), axis=normal.ndim - 1)


class SphereRenderer:
    def __init__(self, envmap_path, out_dir, envmap_inten=1.0, envmap_h=None,
                 ims=128, spp=1, debug=False):
        self.out_dir = out_dir
        self.ims = int(ims)
        self.sps = self._spp2sps(spp)
        self.cam_dist = 10.0
        self.xyz, self.is_fg = self._gen_scene()
        self.normal = _normalize(self.xyz + 1e-12, axis=2)  # center: origin
        self.world2local = _gen_world2local_np(self.normal)
        envmap = load_light(envmap_path, envmap_inten=envmap_inten,
                            envmap_h=envmap_h)
        if debug:
            ioutil.write_img(vis_light(envmap),
                             join(out_dir, 'debug', 'light.png'))
        self.lxyz, self.lareas = gen_light_xyz(*envmap.shape[:2])
        self.ldir = self.gen_light_dir(local=True)
        self.vdir = self.gen_view_dir(local=True)
        self.lcos = self.ldir @ np.array((0.0, 0.0, 1.0))
        is_fg_rep = np.tile(self.is_fg[:, :, None],
                            (1, 1, self.ldir.shape[2]))
        self.lvis = np.logical_and(is_fg_rep, self.lcos > 0).astype(float)
        self.lcontrib = self.calc_light_contrib(envmap)

    @staticmethod
    def _spp2sps(spp):
        sps = np.sqrt(spp)
        if sps != int(sps):
            raise ValueError("`spp` must be a square integer")
        return int(sps)

    def _gen_scene(self, sphere_radius=0.4):
        """Sphere at the origin; camera at (0, 0, -cam_dist) looking at
        the origin with +Y up; the focal length makes the sphere project
        to ``sphere_radius`` in normalized image coordinates."""
        res = self.ims * self.sps
        sample_w = 1 / (self.sps + 1)
        x = np.linspace(sample_w, self.ims - sample_w, res,
                        endpoint=True) / self.ims
        uu, vv = np.meshgrid(x, x)  # uu: columns, vv: rows
        dist = np.sqrt((uu - 0.5) ** 2 + (vv - 0.5) ** 2)
        is_fg = dist <= sphere_radius
        height = np.sqrt(
            np.where(is_fg, sphere_radius ** 2 - dist ** 2, 0.0))
        depth = self.cam_dist - height
        # Pinhole backprojection with normalized focal = cam_dist; camera
        # x and y map to world -x and -y
        xs_cam = depth * (uu - 0.5) / self.cam_dist
        ys_cam = depth * (vv - 0.5) / self.cam_dist
        xyz = np.dstack((-xs_cam, -ys_cam, depth - self.cam_dist))
        xyz[~is_fg] = 0.0
        return xyz, is_fg

    def gen_view_dir(self, local=False):
        cam_loc = np.array((0.0, 0.0, -self.cam_dist))
        vdir = cam_loc[None, None, :] - self.xyz
        if local:
            vdir = np.einsum('ijkl,ijl->ijk', self.world2local, vdir)
        return _normalize(vdir, axis=2)

    def gen_light_dir(self, local=False):
        lxyz_flat = np.reshape(self.lxyz, (-1, 3))
        ldir = lxyz_flat[None, None, :, :] - self.xyz[:, :, None, :]
        if local:
            ldir = np.einsum('ijkl,ijnl->ijnk', self.world2local, ldir)
        return _normalize(ldir, axis=3)

    def calc_light_contrib(self, light):
        light = np.reshape(light, (-1, 3))
        res = self.ims * self.sps
        light = np.tile(light[None, None, :, :], (res, res, 1, 1))
        lareas = np.reshape(self.lareas, (-1,))
        lareas = np.tile(lareas[None, None, :], (res, res, 1))
        lvis = np.tile(self.lvis[:, :, :, None], (1, 1, 1, 3))
        light = lvis * light
        return light * self.lcos[:, :, :, None] * lareas[:, :, :, None]

    def render(self, brdf, white_bg=True):
        """``brdf``: H x W x L x 3, the shape of ``lcontrib``."""
        render = np.sum(brdf * self.lcontrib, axis=2)
        is_fg_rgb = np.dstack([self.is_fg] * 3)
        render[~is_fg_rgb] = 1.0 if white_bg else 0.0
        render_sum = np.zeros((self.ims, self.ims, 3), dtype=render.dtype)
        for i in range(self.sps):
            for j in range(self.sps):
                render_sum += render[i::self.sps, j::self.sps, :]
        return render_sum / (self.sps ** 2)
