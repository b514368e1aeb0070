"""The PyTorch port's two DTU converters vs the JAX package's (CPU):
``dtu_make_dataset`` (the processed layout: cameras.npz + image/) and
``dtu_make_dataset_from_raw`` (pos_???.txt + rectified ``*_3_*`` images),
on one scan that tools/synth_dtu.py writes in both layouts (6 views at
64 x 80, converted at --h 32). The outputs are held with
tests/test_torch_data_gen.py's comparison (JSON within 1e-6 relative,
the resized images within one 8-bit level), and the converted views are
read back by the port's nerf dataset.
"""

import os
from os.path import join

import numpy as np
import pytest

from nerfactor_tpu_torch.data_gen import dtu_make_dataset as tdtu
from nerfactor_tpu_torch.data_gen import dtu_make_dataset_from_raw as traw
from nerfactor_tpu_torch.tools import synth_dtu
from nerfactor_tpu_torch.utils import config as tconfig, io as tio
from tests.test_torch_data_gen import assert_trees_match

IMH, IMW, N_VIEWS, OUT_H = 64, 80, 6, 32


@pytest.fixture(scope='module')
def scan(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('dtu'))
    scan = synth_dtu.make_scan(root, imh=IMH, imw=IMW, n_views=N_VIEWS,
                               subdiv=1, seed=2)
    # Decoys under another lighting condition, which the raw converter
    # must not glob (it takes '*_3_*', the most diffuse)
    for i in range(N_VIEWS):
        tio.write_img(np.zeros((IMH, IMW, 3), np.float32),
                      join(scan['img_dir'], 'rect_%03d_5_r5000.png' % (i + 1)))
    scan['processed'] = synth_dtu.make_processed(scan, join(root, 'proc'))
    return scan


def run_both(jmod, tmod, argv_of, tmp_path_factory, name):
    out = {}
    for pkg, mod in (('jax', jmod), ('port', tmod)):
        out[pkg] = str(tmp_path_factory.mktemp('%s_%s' % (name, pkg)))
        out[pkg + '_run'] = mod.main(argv_of(out[pkg]))
    return out


def read_back(root):
    """The converted views through the port's nerf dataset: train views
    and a batch, the vali views' full-image rays."""
    from nerfactor_tpu_torch.datasets.nerf import Dataset
    parser = tconfig.read_config(tconfig.resolve_config_path('nerf.ini'))
    tconfig.apply_override(parser, 'data_root=%s,imh=%d,n_rays_per_step=16'
                           % (root, OUT_H))
    config = tconfig.Config(parser)
    train = Dataset(config, 'train')
    batch = next(iter(train.build_pipeline(prefetch=0)))
    assert batch['rayo'].shape == batch['rgb'].shape == (16, 3)
    assert np.isfinite(batch['rayd']).all()
    vali = Dataset(config, 'vali')
    vbatch = next(iter(vali.build_pipeline(prefetch=0)))
    assert vbatch['rgb'].shape == (OUT_H * OUT_H * IMW // IMH, 3)
    return train.get_n_views(), vali.get_n_views()


def check_layout(root, run):
    assert run['views'] == {'train': 4, 'val': 2, 'test': 120}
    assert (run['imh'], run['imw']) == (OUT_H, OUT_H * IMW // IMH)
    meta = tio.read_json(join(root, 'train_000', 'metadata.json'))
    assert (meta['imh'], meta['imw']) == (OUT_H, OUT_H * IMW // IMH)
    mat = np.array([float(x) for x in
                    meta['cam_transform_mat'].split(',')]).reshape(4, 4)
    # Spherified: cameras near the unit sphere
    assert abs(np.linalg.norm(mat[:3, 3]) - 1.0) < 0.3
    rgba = tio.load_img(join(root, 'train_000', 'rgba.png'))
    assert rgba.shape == (OUT_H, OUT_H * IMW // IMH, 4)
    assert rgba[:, :, 3].min() > 0.99  # the all-one alpha appended
    assert read_back(root) == (4, 2)


def test_dtu_make_dataset_matches_jax(scan, tmp_path_factory):
    from data_gen_tpu import dtu_make_dataset as jdtu
    out = run_both(jdtu, tdtu, lambda o: [
        '--scene_dir', scan['processed'], '--outroot', o, '--h',
        str(OUT_H), '--n_vali', '2'], tmp_path_factory, 'dtu')
    assert_trees_match(out['port'], out['jax'], resized=True)
    check_layout(out['port'], out['port_run'])


def test_dtu_make_dataset_from_raw_matches_jax(scan, tmp_path_factory):
    from data_gen_tpu import dtu_make_dataset_from_raw as jraw
    img_root = os.path.dirname(scan['img_dir'])
    name = os.path.basename(scan['img_dir'])

    def argv(o):
        return ['--cam_dir', scan['cam_dir'], '--img_root', img_root,
                '--scenes', name, '--outroot', o, '--h', str(OUT_H),
                '--n_vali', '2']
    out = run_both(jraw, traw, argv, tmp_path_factory, 'dtu_raw')
    assert_trees_match(join(out['port'], name), join(out['jax'], name),
                       resized=True)
    check_layout(join(out['port'], name), out['port_run'][name])
    meta = tio.read_json(join(out['port'], name, 'train_000',
                              'metadata.json'))
    assert '_3_' in os.path.basename(meta['original_path'])
    # Skip-if-done guard: a second run leaves the scene as it is
    stamp = os.path.getmtime(join(out['port'], name, 'train_000',
                                  'rgba.png'))
    assert traw.main(argv(out['port'])) == {}
    assert os.path.getmtime(join(out['port'], name, 'train_000',
                                 'rgba.png')) == stamp


def test_processed_and_raw_layouts_agree(scan, tmp_path_factory):
    """The two port converters on the same cameras and images: the same
    images and the same camera angle; the poses agree once each converter
    has recentred and spherified its own (the processed layout's scale
    matrix normalizes them first)."""
    a = str(tmp_path_factory.mktemp('agree_proc'))
    b = str(tmp_path_factory.mktemp('agree_raw'))
    tdtu.main(['--scene_dir', scan['processed'], '--outroot', a, '--h',
               str(OUT_H), '--n_vali', '2'])
    name = os.path.basename(scan['img_dir'])
    traw.main(['--cam_dir', scan['cam_dir'], '--img_root',
               os.path.dirname(scan['img_dir']), '--scenes', name,
               '--outroot', b, '--h', str(OUT_H), '--n_vali', '2'])
    b = join(b, name)
    for view in ('train_000', 'val_001'):
        np.testing.assert_array_equal(
            tio.read_png(join(a, view, 'rgba.png')),
            tio.read_png(join(b, view, 'rgba.png')))
        ma = tio.read_json(join(a, view, 'metadata.json'))
        mb = tio.read_json(join(b, view, 'metadata.json'))
        np.testing.assert_allclose(ma['cam_angle_x'], mb['cam_angle_x'],
                                   rtol=1e-6)
        pa = np.array([float(x) for x in ma['cam_transform_mat'].split(',')])
        pb = np.array([float(x) for x in mb['cam_transform_mat'].split(',')])
        np.testing.assert_allclose(pa, pb, atol=1e-4)
