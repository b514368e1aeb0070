"""MERL BRDF table dataset (counterpart of
nerfactor_tpu/datasets/brdf_merl.py; reference datasets/brdf_merl.py).

Elements are BRDF identities. Train/vali elements come from
train_<name>.npz / vali_<name>.npz tables of (rusink, refl) rows; the test
element is one shared table of Rusinkiewicz coordinates, evaluated for
every seen identity and then for the identities interpolated between a
seeded choice of materials, named '<i>_<w1>_<mat1>_<w2>_<mat2>'
(reference :47-61). Training samples ``n_rays_per_step`` rows of one
identity with replacement, with the JAX package's numpy calls.
"""

from os.path import basename

import numpy as np

from nerfactor_tpu_torch.datasets.base import Dataset as BaseDataset
from nerfactor_tpu_torch.utils import io as ioutil
from nerfactor_tpu_torch.utils.logging import Logger

logger = Logger(loggee="datasets/brdf_merl")


# Test identities interpolated: between consecutive materials of a
# seeded choice of up to N_IDEN, N_BETWEEN steps each (reference :47-61)
N_IDEN, N_BETWEEN = 20, 11


class Dataset(BaseDataset):
    # Keys that go to the device; the rest is host-side metadata
    array_keys = ('rusink', 'refl', 'i')

    def __init__(self, config, mode, debug=False, seed=0):
        root = config.get('data_root')
        train_paths = ioutil.sortglob(root, 'train_*.npz')
        vali_paths = ioutil.sortglob(root, 'vali_*.npz')
        test_paths = ioutil.sortglob(root, 'test*.npz')
        if len(test_paths) != 1:
            raise ValueError(
                "There should be one table of test coordinates, shared by "
                "all identities, in %s" % root)
        self.brdf_names = [
            basename(x)[len('train_'):-len('.npz')] for x in train_paths]
        self.test_data = ioutil.load_np(test_paths[0])
        # Test identities: the seen ones, then those interpolated between
        # consecutive materials of a seeded random choice
        test_ids = list(self.brdf_names)
        rng = np.random.RandomState(seed)
        mats = rng.choice(self.brdf_names, min(N_IDEN, len(self.brdf_names)),
                          replace=False)
        i = 0
        for mat1, mat2 in zip(mats[:-1], mats[1:]):
            for a in np.linspace(1, 0, N_BETWEEN, endpoint=True):
                test_ids.append(f'{i:06d}_{a:f}_{mat1}_{1 - a:f}_{mat2}')
                i += 1
        self.paths = {
            'train': train_paths, 'vali': vali_paths, 'test': test_ids}
        super().__init__(config, mode, debug=debug, seed=seed)

    def _get_batch_size(self):
        return self.config.getint('n_rays_per_step')

    def get_n_brdfs(self):
        return len(self.paths[self.mode])

    def _glob(self):
        paths = self.paths[self.mode]
        logger.info("Number of '%s' identities: %d", self.mode, len(paths))
        return paths

    def _load_one(self, path):
        if self.mode == 'test':
            id_ = path  # a test identity's name
            data = self.test_data
            i = self.brdf_names.index(id_) if id_ in self.brdf_names else -1
            rusink = np.asarray(data['rusink'], np.float32)
            refl = np.zeros((rusink.shape[0], 1), dtype=np.float32)
        else:
            data = ioutil.load_np(path)
            id_ = str(data['name'][()])
            i = int(data['i'][()])
            rusink = np.asarray(data['rusink'], np.float32)
            refl = np.asarray(data['refl'], np.float32)
        return {
            'id': id_,
            'i': np.asarray(i, dtype=np.int32),
            'envmap_h': int(data['envmap_h'][()]),
            'ims': int(data['ims'][()]),
            'spp': int(data['spp'][()]),
            'rusink': rusink,
            'refl': refl,
        }

    def _postprocess(self, data, rng):
        if self.mode in ('vali', 'test'):
            return dict(data)
        # Training: rows drawn with replacement
        sel = rng.integers(0, data['rusink'].shape[0], size=self.bs)
        out = dict(data)
        out['rusink'] = data['rusink'][sel]
        out['refl'] = data['refl'][sel]
        return out
