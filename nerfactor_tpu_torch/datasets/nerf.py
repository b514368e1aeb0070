"""NeRF dataset: rays from per-view metadata.json (+ rgba.png for train and
vali views); counterpart of nerfactor_tpu/datasets/nerf.py, on the port's
PNG reader and resize.

Views live in ``{train,val,test}_???`` dirs; rays come from a 4x4
cam_transform_mat and a pinhole cam_angle_x (reference
datasets/nerf.py:172-215). A train batch is ``n_rays_per_step`` uniformly
random pixels of one view; a vali/test batch is all rays of a view, and
so is a train batch with ``always_all_rays`` (geometry distillation).
``spp`` (a square) casts sqrt(spp) x sqrt(spp) rays per pixel, in every
mode.
"""

from os.path import basename, dirname, join, exists

import numpy as np

from nerfactor_tpu_torch.datasets.base import Dataset as BaseDataset
from nerfactor_tpu_torch.ops import img as imgops
from nerfactor_tpu_torch.utils import io as ioutil
from nerfactor_tpu_torch.utils.logging import Logger

logger = Logger(loggee="datasets/nerf")


class Dataset(BaseDataset):
    array_keys = ('rayo', 'rayd', 'rgb')

    def __init__(self, config, mode, debug=False, always_all_rays=False,
                 spp=1, seed=0):
        sps = int(round(np.sqrt(spp)))
        if sps * sps != spp:
            raise ValueError("Samples per pixel must be a square number so "
                             "that samples per side are integers, got %r"
                             % spp)
        self.sps = sps
        self.always_all_rays = always_all_rays
        super().__init__(config, mode, debug=debug, seed=seed)

    def _get_batch_size(self):
        if self.mode == 'train':
            return self.config.getint('n_rays_per_step')
        # All rays of one view
        hw = self._get_cached(self.files[0])['hw']
        return int(np.prod(hw)) * self.sps ** 2

    def _mode_dirs(self):
        mode_str = 'val' if self.mode == 'vali' else self.mode
        return join(self.config.get('data_root'), '%s_???' % mode_str)

    def _glob(self):
        paths = ioutil.sortglob(self._mode_dirs(), 'metadata.json')
        if self.mode != 'test':
            kept = [p for p in paths if exists(self._rgba_path(p))]
            for p in sorted(set(paths) - set(kept)):
                logger.warn("Dropping camera %s: no rgba.png next to it", p)
            paths = kept
        logger.info("Number of '%s' views: %d", self.mode, len(paths))
        return paths

    @staticmethod
    def _parse_id(metadata_path):
        return basename(dirname(metadata_path))

    @staticmethod
    def _rgba_path(metadata_path):
        return join(dirname(metadata_path), 'rgba.png')

    def _load_rgba(self, metadata_path):
        rgba = ioutil.load_img(self._rgba_path(metadata_path))
        if rgba.ndim != 3 or rgba.shape[2] != 4:
            raise ValueError("Expected an HxWx4 RGBA image, got shape %s"
                             % (rgba.shape,))
        return rgba

    def _camera(self, metadata_path):
        """(id, imh, imw, rayo, rayd) of one view."""
        imh = self.config.getint('imh')
        metadata = ioutil.read_json(metadata_path)
        imw = int(imh / metadata['imh'] * metadata['imw'])
        cam_to_world = np.array([
            float(x) for x in metadata['cam_transform_mat'].split(',')
        ]).reshape(4, 4)
        rayo, rayd = self._gen_rays(cam_to_world, metadata['cam_angle_x'],
                                    imh, imw)
        return self._parse_id(metadata_path), imh, imw, rayo, rayd

    def _load_one(self, metadata_path):
        id_, imh, imw, rayo, rayd = self._camera(metadata_path)
        if self.mode == 'test':
            rgb = np.zeros((imh * self.sps, imw * self.sps, 3), np.float32)
        else:
            rgba = self._load_rgba(metadata_path)
            if imh != rgba.shape[0]:
                rgba = imgops.resize(rgba, new_h=imh)
            rgb, alpha = rgba[:, :, :3], rgba[:, :, 3]
            white_bg = self.config.getboolean('white_bg')
            bg = np.ones_like(rgb) if white_bg else np.zeros_like(rgb)
            rgb = imgops.alpha_blend(rgb, alpha, bg).astype(np.float32)
        return {'id': id_, 'hw': (imh, imw),
                'rayo': rayo.astype(np.float32),
                'rayd': rayd.astype(np.float32), 'rgb': rgb}

    def _postprocess(self, data, rng):
        out = {'id': data['id'], 'hw': data['hw']}
        if self.mode in ('vali', 'test') or self.always_all_rays:
            for k in self.array_keys:
                out[k] = data[k].reshape(-1, 3)
            return out
        n_pix = data['rayo'].shape[0] * data['rayo'].shape[1]
        sel = rng.integers(0, n_pix, size=self.bs)
        for k in self.array_keys:
            out[k] = data[k].reshape(-1, 3)[sel]
        return out

    def _gen_rays(self, to_world, angle_x, imh, imw):
        """Pinhole rays in world space, ``sps`` x ``sps`` a pixel (reference
        datasets/nerf.py:172-215, incl. the optional NDC path)."""
        near = self.config.getfloat('near')
        ndc = self.config.getboolean('ndc')
        cam_loc = to_world[:3, 3]
        sps = self.sps
        rayo = np.tile(cam_loc[None, None, :], (imh * sps, imw * sps, 1))
        xs, ys = np.meshgrid(np.linspace(0, imw, imw * sps, endpoint=False),
                             np.linspace(0, imh, imh * sps, endpoint=False))
        fl = 0.5 * imw / np.tan(0.5 * angle_x)
        rayd = np.stack(
            ((xs - 0.5 * imw) / fl, -(ys - 0.5 * imh) / fl,
             -np.ones_like(xs)), axis=-1)
        rayd = np.sum(rayd[:, :, np.newaxis, :] * to_world[:3, :3], axis=-1)
        if ndc:
            cv2gl_rot = np.diag((1.0, -1.0, -1.0))
            rayo = rayo.dot(cv2gl_rot)
            rayd = rayd.dot(cv2gl_rot)
            t = -(near + rayo[..., 2]) / rayd[..., 2]
            rayo = rayo + t[..., None] * rayd
            o1 = -1. / (imw / (2. * fl)) * rayo[..., 0] / rayo[..., 2]
            o2 = -1. / (imh / (2. * fl)) * rayo[..., 1] / rayo[..., 2]
            o3 = 1. + 2. * near / rayo[..., 2]
            d1 = -1. / (imw / (2. * fl)) * (
                rayd[..., 0] / rayd[..., 2] - rayo[..., 0] / rayo[..., 2])
            d2 = -1. / (imh / (2. * fl)) * (
                rayd[..., 1] / rayd[..., 2] - rayo[..., 1] / rayo[..., 2])
            d3 = -2. * near / rayo[..., 2]
            rayo = np.dstack((o1, o2, o3))
            rayd = np.dstack((d1, d2, d3))
        return rayo, rayd
