"""Views with geometry buffers made from an MVS mesh (counterpart of
nerfactor_tpu/datasets/mvs_shape.py; reference
nerfactor/datasets/mvs_shape.py).

The same arrays as ``nerf_shape``, but everything lives under
``mvs_root``, as data_gen/dtu_surf_from_mvs.py writes it: per view a
``{train,val,test}_???`` folder with metadata.json (imh, imw, cam_loc),
rgba.png (train and val), alpha.png, xyz.npy, normal.npy and lvis.npy.
Ray origins are the metadata's ``cam_loc``; ray directions are zeros,
which neither the shape nor the joint model reads (their view directions
come from ``rayo`` and ``xyz``). Train batches sample foreground rays as
``nerf_shape`` does, with the same numpy Generator calls as the JAX
package.
"""

from os.path import join

import numpy as np

from nerfactor_tpu_torch.datasets.nerf_shape import Dataset as BaseDataset
from nerfactor_tpu_torch.ops import img as imgops
from nerfactor_tpu_torch.utils import io as ioutil
from nerfactor_tpu_torch.utils.logging import Logger

logger = Logger(loggee="datasets/mvs_shape")


class Dataset(BaseDataset):
    def _glob(self):
        mvs_root = self.config.get('mvs_root')
        mode_str = 'val' if self.mode == 'vali' else self.mode
        if self.debug:
            logger.warn("Debug mode: restricting the glob to one view")
            metadata_dir = join(mvs_root, '%s_000' % mode_str)
        else:
            metadata_dir = join(mvs_root, '%s_???' % mode_str)
        metadata_paths, incomplete_paths = [], []
        for metadata_path in ioutil.sortglob(metadata_dir, 'metadata.json'):
            view_dir = join(mvs_root, self._parse_id(metadata_path))
            paths = {k: join(view_dir, f) for k, f in (
                ('xyz', 'xyz.npy'), ('normal', 'normal.npy'),
                ('lvis', 'lvis.npy'), ('alpha', 'alpha.png'))}
            if self.mode != 'test':
                paths['rgba'] = join(view_dir, 'rgba.png')
            if ioutil.all_exist(paths):
                metadata_paths.append(metadata_path)
                self.meta2buf[metadata_path] = paths
            else:
                incomplete_paths.append(metadata_path)
        if incomplete_paths:
            logger.warn(
                "Dropping views with missing geometry buffers:\n\t%s",
                incomplete_paths)
        logger.info("Number of '%s' views: %d", self.mode,
                    len(metadata_paths))
        return metadata_paths

    def _load_one(self, metadata_path):
        imh = self.config.getint('imh')
        metadata = ioutil.read_json(metadata_path)
        h, w = metadata['imh'], metadata['imw']
        cam_loc = np.array(metadata['cam_loc'])
        rayo = np.tile(cam_loc[None, None, :], (h, w, 1)).astype(np.float32)
        rayd = np.zeros_like(rayo)  # read by neither model
        paths = self.meta2buf[metadata_path]
        xyz = ioutil.load_np(paths['xyz'])
        normal = ioutil.load_np(paths['normal'])
        if self.debug:
            logger.warn("Faking light visibility for faster debugging")
            light_h = self.config.getint('light_h')
            lvis = 0.5 * np.ones(
                normal.shape[:2] + (2 * light_h * light_h,), np.float32)
        else:
            # Memory-mapped: training reads only the sampled rows
            lvis = np.load(paths['lvis'], mmap_mode='r')
        if self.mode == 'test':
            alpha = ioutil.load_img(paths['alpha'])
            rgb = np.zeros_like(xyz)
        else:
            rgba = ioutil.load_img(paths['rgba'])
            if rgba.ndim != 3 or rgba.shape[2] != 4:
                raise ValueError("Expected an HxWx4 RGBA image, got shape %s"
                                 % (rgba.shape,))
            rgb = rgba[:, :, :3]
            if self.config.getboolean('use_nerf_alpha', fallback=False):
                alpha = ioutil.load_img(paths['alpha'])
            else:
                alpha = rgba[:, :, 3]
        if alpha.ndim == 3:
            alpha = alpha[:, :, 0]
        if imh != xyz.shape[0]:
            xyz = imgops.resize(xyz, new_h=imh)
            normal = imgops.resize(normal, new_h=imh)
            lvis = imgops.resize(np.asarray(lvis, np.float32), new_h=imh)
            alpha = imgops.resize(alpha, new_h=imh)
            rgb = imgops.resize(rgb, new_h=imh)
            rayo = imgops.resize(rayo, new_h=imh)
            rayd = imgops.resize(rayd, new_h=imh)
        if np.isclose(xyz, rayo).all(axis=2).any():
            raise ValueError("Found XYZs coinciding with the camera")
        norm = np.linalg.norm(normal, axis=2, keepdims=True)
        normal = normal / np.maximum(norm, 1e-12)
        return {
            'id': self._parse_id(metadata_path),
            'hw': tuple(xyz.shape[:2]),
            'rayo': rayo.astype(np.float32),
            'rayd': rayd.astype(np.float32),
            'rgb': rgb.astype(np.float32),
            'alpha': alpha.astype(np.float32),
            'xyz': xyz.astype(np.float32),
            'normal': normal.astype(np.float32),
            # Clipped and cast after ray selection (nerf_shape)
            'lvis': lvis,
        }
