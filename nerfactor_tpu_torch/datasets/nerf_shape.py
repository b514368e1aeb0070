"""Views joined with their distilled geometry buffers (xyz, normal, lvis,
alpha from geometry_from_nerf); counterpart of
nerfactor_tpu/datasets/nerf_shape.py, on the port's PNG reader and resize.

Training samples ``n_rays_per_step`` rays of one view from its foreground
(alpha > 0.9) only, with the same numpy Generator calls as the JAX
package, so both draw the same rays from the same seed.
"""

from os.path import join

import numpy as np

from nerfactor_tpu_torch.datasets.nerf import Dataset as BaseDataset
from nerfactor_tpu_torch.ops import img as imgops
from nerfactor_tpu_torch.utils import io as ioutil
from nerfactor_tpu_torch.utils.logging import Logger

logger = Logger(loggee="datasets/nerf_shape")


class Dataset(BaseDataset):
    array_keys = ('rayo', 'rayd', 'rgb', 'alpha', 'xyz', 'normal', 'lvis')

    def __init__(self, config, mode, debug=False, seed=0):
        self.meta2buf = {}
        # Host->device transfer dtype of the (rays, n_lights) lvis
        # buffers: float16 halves the largest batch payload; the train
        # step upcasts to f32. Values are in [0, 1], so f16 costs ~1e-3
        # absolute.
        self.lvis_transfer_dtype = np.dtype(config.get(
            'lvis_transfer_dtype', fallback='float32'))
        if self.lvis_transfer_dtype not in (np.dtype(np.float32),
                                            np.dtype(np.float16)):
            raise ValueError("lvis_transfer_dtype must be float32 or "
                             "float16")
        super().__init__(config, mode, debug=debug, seed=seed)

    def _glob(self):
        nerf_root = self.config.get('data_nerf_root')
        metadata_dir = self._mode_dirs()
        if self.debug:
            logger.warn("Debug mode: restricting the glob to one view")
            metadata_dir = metadata_dir.replace('_???', '_002')
        metadata_paths, incomplete_paths = [], []
        for metadata_path in ioutil.sortglob(metadata_dir, 'metadata.json'):
            id_ = self._parse_id(metadata_path)
            paths = {k: join(nerf_root, id_, f) for k, f in (
                ('xyz', 'xyz.npy'), ('normal', 'normal.npy'),
                ('lvis', 'lvis.npy'), ('alpha', 'alpha.png'))}
            if self.mode != 'test':
                paths['rgba'] = self._rgba_path(metadata_path)
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
        id_, imh, imw, rayo, rayd = self._camera(metadata_path)
        paths = self.meta2buf[metadata_path]
        xyz = ioutil.load_np(paths['xyz'])
        normal = ioutil.load_np(paths['normal'])
        if self.debug:
            logger.warn("Faking light visibility for faster debugging")
            light_h = self.config.getint('light_h')
            lvis = 0.5 * np.ones(
                normal.shape[:2] + (2 * light_h * light_h,), np.float32)
        else:
            # H x W x 512 f32 is 512 MB per view at 512 px: memory-map it;
            # training then reads only the sampled rows
            lvis = np.load(paths['lvis'], mmap_mode='r')
        if self.mode == 'test':
            alpha = ioutil.load_img(paths['alpha'])
            rgb = np.zeros_like(xyz)
        else:
            rgba = self._load_rgba(metadata_path)
            rgb = rgba[:, :, :3]
            if self.config.getboolean('use_nerf_alpha', fallback=False):
                alpha = ioutil.load_img(paths['alpha'])
            else:
                alpha = rgba[:, :, 3]
        if alpha.ndim == 3:
            alpha = alpha[:, :, 0]
        # Resize everything to the target image height
        if imh != xyz.shape[0]:
            xyz = imgops.resize(xyz, new_h=imh)
            normal = imgops.resize(normal, new_h=imh)
            lvis = imgops.resize(np.asarray(lvis, np.float32), new_h=imh)
            alpha = imgops.resize(alpha, new_h=imh)
            rgb = imgops.resize(rgb, new_h=imh)
        if np.isclose(xyz, rayo).all(axis=2).any():
            raise ValueError("Found XYZs coinciding with the camera")
        norm = np.linalg.norm(normal, axis=2, keepdims=True)
        normal = normal / np.maximum(norm, 1e-12)
        return {
            'id': id_, 'hw': (imh, imw),
            'rayo': rayo.astype(np.float32),
            'rayd': rayd.astype(np.float32),
            'rgb': rgb.astype(np.float32),
            'alpha': alpha.astype(np.float32),
            'xyz': xyz.astype(np.float32),
            'normal': normal.astype(np.float32),
            # Clipped and cast after ray selection, so a memory-mapped
            # lvis is never read whole at train time
            'lvis': lvis,
        }

    def _postprocess(self, data, rng, alpha_thres=0.9):
        out = {'id': data['id'], 'hw': data['hw']}
        dims = (('rayo', 3), ('rayd', 3), ('rgb', 3), ('alpha', 1),
                ('xyz', 3), ('normal', 3), ('lvis', data['lvis'].shape[2]))
        if self.mode in ('vali', 'test'):
            sel = slice(None)
        else:
            alpha = data['alpha'].reshape(-1)
            fg = np.flatnonzero(alpha > alpha_thres)
            if fg.size == 0:
                raise ValueError(
                    "No foreground pixel above threshold to sample")
            sel = fg[rng.integers(0, fg.size, size=self.bs)]
        for k, d in dims:
            out[k] = data[k].reshape(-1, d)[sel]
        out['lvis'] = np.clip(np.asarray(out['lvis'], np.float32), 0.0,
                              1.0).astype(self.lvis_transfer_dtype)
        return out
