"""The PyTorch port's dataset converters vs the JAX package's (CPU): the
MERL converter on fake full-size binaries, the COLMAP/LLFF real-capture
converter on a synthetic capture of JPEG and PNG views, the pose math,
and the port's JPEG reading. Each runs both converters on the same
inputs, made with numpy from a seed, and compares their outputs:

  * JSON and metadata: equal, floats (also those of the comma-joined
    ``cam_transform_mat``) within 1e-6 relative;
  * arrays of host NumPy math (the npz tables): equal;
  * images that went through the resize: within one 8-bit level (the
    packages resize with jax.image.resize and F.interpolate);
  * images that did not: equal.

Also: the converted tables feed the port's brdf_merl dataset and the
converted capture its nerf dataset. tests/test_torch_dtu_make_dataset.py
holds the two DTU converters the same way, with this file's comparison.
"""

import json
import os
import subprocess
import sys
from os.path import dirname, join, relpath

import numpy as np
import pytest

from nerfactor_tpu.utils import io as jio
from nerfactor_tpu_torch.data_gen import merl_make_dataset as tmerl
from nerfactor_tpu_torch.data_gen import nerf_real_make_dataset as treal
from nerfactor_tpu_torch.data_gen import poses as tposes
from nerfactor_tpu_torch.tools import synth_llff
from nerfactor_tpu_torch.utils import config as tconfig, io as tio

REPO = dirname(dirname(os.path.abspath(__file__)))
FLOAT_RTOL = 1e-6


# ------ comparing two converted trees ------

def _floats(s):
    try:
        return [float(x) for x in s.split(',')]
    except ValueError:
        return None


def assert_json_close(got, want, where=''):
    """Equal structure; numbers within FLOAT_RTOL relative (1e-12
    absolute for exact zeros), a string of comma-joined floats likewise,
    every other value equal."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), where
        for k in want:
            assert_json_close(got[k], want[k], '%s.%s' % (where, k))
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            assert_json_close(g, w, '%s[%d]' % (where, i))
    elif isinstance(want, (int, float)) and not isinstance(want, bool):
        assert type(got) is type(want), (where, got, want)
        np.testing.assert_allclose(got, want, rtol=FLOAT_RTOL, atol=1e-12,
                                   err_msg=where)
    elif isinstance(want, str) and _floats(want) is not None \
            and ',' in want:
        np.testing.assert_allclose(_floats(got), _floats(want),
                                   rtol=FLOAT_RTOL, atol=1e-12,
                                   err_msg=where)
    else:
        assert got == want, (where, got, want)


def tree_files(root):
    return sorted(relpath(join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def pixels(path):
    """Integer pixels of an 8-bit PNG, decoded by the port."""
    return tio.read_png(path).astype(int)


def assert_trees_match(got_root, want_root, resized):
    """The two converters' outputs: the same files; JSON within
    FLOAT_RTOL; PNG pixels within one 8-bit level where the images went
    through the resize (``resized``), else equal; npz arrays equal."""
    files = tree_files(want_root)
    assert tree_files(got_root) == files
    for f in files:
        got, want = join(got_root, f), join(want_root, f)
        if f.endswith('.json'):
            assert_json_close(tio.read_json(got), tio.read_json(want), f)
        elif f.endswith('.png'):
            g, w = pixels(got), pixels(want)
            assert g.shape == w.shape, f
            assert np.abs(g - w).max() <= (1 if resized else 0), f
        elif f.endswith('.npz'):
            g, w = np.load(got), np.load(want)
            assert sorted(g.files) == sorted(w.files), f
            for k in w.files:
                assert g[k].dtype == w[k].dtype, (f, k)
                np.testing.assert_array_equal(g[k], w[k], err_msg=f + k)
        else:
            raise AssertionError("unexpected file %s" % f)
    return files


# ------ MERL conversion ------

def write_fake_merl(path, seed):
    """Full-size MERL .binary with random positive reflectance (as
    tests/test_data_gen.py's fake)."""
    rng = np.random.RandomState(seed)
    dims = np.array([90, 90, 180], np.int32)
    vals = rng.rand(3, 90, 90, 180).astype(np.float64) * 100.0
    with open(path, 'wb') as h:
        dims.tofile(h)
        vals.ravel().tofile(h)


@pytest.fixture(scope='module')
def merl_runs(tmp_path_factory):
    indir = str(tmp_path_factory.mktemp('merl_bin'))
    for seed, name in enumerate(('fake-red', 'fake-blue')):
        write_fake_merl(join(indir, name + '.binary'), seed=seed + 3)
    from data_gen_tpu import merl_make_dataset as jmerl
    out = {}
    for pkg, mod in (('jax', jmerl), ('port', tmerl)):
        out[pkg] = str(tmp_path_factory.mktemp('merl_npz_' + pkg))
        out[pkg + '_run'] = mod.main([
            '--indir', indir, '--outdir', out[pkg], '--envmap_h', '4',
            '--ims', '32', '--spp', '1'])
    return out


def test_merl_tables_match_jax(merl_runs):
    files = assert_trees_match(merl_runs['port'], merl_runs['jax'],
                               resized=False)
    assert 'test.npz' in files
    for sub in ('cslice', 'cslice_achromatic', 'render',
                'render_achromatic'):
        assert join('vis', sub, 'fake-red.png') in files
    run = merl_runs['port_run']
    assert run['materials'] == ['fake-blue', 'fake-red']
    n_total = 180 * 90 * 90
    for name in run['materials']:
        train = np.load(join(merl_runs['port'], 'train_%s.npz' % name))
        vali = np.load(join(merl_runs['port'], 'vali_%s.npz' % name))
        assert train['rusink'].shape[0] + vali['rusink'].shape[0] == n_total
        assert (train['refl'] > 0).all()
    test = np.load(join(merl_runs['port'], 'test.npz'))
    assert test['rusink'].shape[0] == run['test_rows'] > 90 * 90


def test_merl_feeds_port_brdf_dataset(merl_runs):
    """The port's tables load through the port's brdf_merl dataset, in
    every mode."""
    from nerfactor_tpu_torch.datasets.brdf_merl import Dataset
    parser = tconfig.read_config(tconfig.resolve_config_path('brdf.ini'))
    tconfig.apply_override(
        parser, 'data_root=%s,n_rays_per_step=64' % merl_runs['port'])
    config = tconfig.Config(parser)
    batch = next(iter(Dataset(config, 'train').build_pipeline(prefetch=0)))
    assert batch['rusink'].shape == (64, 3) and batch['refl'].shape == (64, 1)
    vali = next(iter(Dataset(config, 'vali').build_pipeline(prefetch=0)))
    assert vali['rusink'].shape[0] == vali['refl'].shape[0] > 0
    test_ds = Dataset(config, 'test')
    test = next(iter(test_ds.build_pipeline(prefetch=0, no_shuffle=True)))
    assert test['id'] in test_ds.brdf_names and int(test['ims']) == 32


# ------ COLMAP/LLFF ingestion ------

@pytest.fixture(scope='module')
def real_runs(tmp_path_factory):
    """A synthetic capture of 6 views at 48 x 64, JPEG and PNG in turn,
    converted at --h 32 by both packages."""
    scene = str(tmp_path_factory.mktemp('llff'))
    synth_llff.make_capture(scene, n_views=6, imh=48, imw=64,
                            ext=['jpg', 'png'] * 3, seed=1)
    from data_gen_tpu import nerf_real_make_dataset as jreal
    out = {'scene': scene}
    for pkg, mod in (('jax', jreal), ('port', treal)):
        out[pkg] = str(tmp_path_factory.mktemp('real_' + pkg))
        out[pkg + '_run'] = mod.main([
            '--scene_dir', scene, '--outroot', out[pkg], '--h', '32',
            '--n_vali', '2'])
    return out


def test_real_capture_matches_jax(real_runs):
    files = assert_trees_match(real_runs['port'], real_runs['jax'],
                               resized=True)
    run = real_runs['port_run']
    assert run['views'] == {'train': 4, 'val': 2, 'test': 120}
    assert (run['imh'], run['imw']) == (32, 43)
    for f in ('transforms_train.json', 'transforms_val.json',
              'transforms_test.json', 'test_000/nn.png',
              'test_119/metadata.json', 'val_001/rgba.png'):
        assert f in files
    meta = tio.read_json(join(real_runs['port'], 'train_000',
                              'metadata.json'))
    assert meta['original_path'].endswith('img_001.png')  # 0 is a vali view
    assert (meta['imh'], meta['imw']) == (32, 43)
    mat = np.array(_floats(meta['cam_transform_mat'])).reshape(4, 4)
    np.testing.assert_allclose(mat[3], [0, 0, 0, 1])
    rgba = tio.load_img(join(real_runs['port'], 'train_000', 'rgba.png'))
    assert rgba.shape == (32, 43, 4) and rgba[..., 3].min() == 1.0


def test_real_capture_spherified(real_runs):
    """After spherification all cameras sit near the unit sphere, and
    the test spiral's cameras on a circle of radius below 1."""
    dists = []
    for v in tio.sortglob(real_runs['port'], 'train_???'):
        meta = tio.read_json(join(v, 'metadata.json'))
        dists.append(np.linalg.norm(np.array(_floats(
            meta['cam_transform_mat'])).reshape(4, 4)[:3, 3]))
    np.testing.assert_allclose(dists, 1.0, rtol=0.2)
    with open(join(real_runs['port'], 'transforms_test.json')) as h:
        test = json.load(h)['frames']
    locs = np.array([np.array(f['transform_matrix'])[:3, 3] for f in test])
    np.testing.assert_allclose(locs[:, 2], locs[0, 2], atol=1e-6)
    radii = np.linalg.norm(locs[:, :2], axis=1)
    np.testing.assert_allclose(radii, radii[0], rtol=1e-6)
    assert radii[0] < 1.0


def test_real_capture_feeds_port_nerf_dataset(real_runs):
    from nerfactor_tpu_torch.datasets.nerf import Dataset
    parser = tconfig.read_config(tconfig.resolve_config_path('nerf.ini'))
    tconfig.apply_override(parser, 'data_root=%s,imh=32,n_rays_per_step=16'
                           % real_runs['port'])
    config = tconfig.Config(parser)
    ds = Dataset(config, 'train')
    assert ds.get_n_views() == 4
    batch = next(iter(ds.build_pipeline(prefetch=0)))
    assert batch['rayo'].shape == batch['rgb'].shape == (16, 3)
    vali = next(iter(Dataset(config, 'vali').build_pipeline(prefetch=0)))
    assert vali['rgb'].shape == (32 * 43, 3)


def test_recenter_poses_identity_matches_jax():
    """Recentring puts the average pose at the identity, and the port's
    pose math is the JAX package's bit for bit (float64 and float32
    inputs keep their dtypes)."""
    from data_gen_tpu import poses as jposes
    from tests import synth
    cams = []
    for az_deg in (-30, -15, 0, 15, 30):
        az, el = np.deg2rad(az_deg), np.deg2rad(25.0)
        loc = 3.0 * np.array([np.cos(el) * np.cos(az),
                              np.cos(el) * np.sin(az), np.sin(el)])
        cams.append(synth.look_at_c2w(loc))
    hwf = np.array([32.0, 48.0, 60.0]).reshape(3, 1)
    poses = np.stack(
        [np.concatenate([c[:3, :4], hwf], axis=1) for c in cams])
    rec = tposes.recenter_poses(poses)
    avg = tposes.average_pose(rec)
    np.testing.assert_allclose(avg[:3, :3], np.eye(3), atol=1e-6)
    np.testing.assert_allclose(avg[:3, 3], 0.0, atol=1e-6)
    for dtype in (np.float64, np.float32):
        p = poses.astype(dtype)
        got, want = tposes.recenter_poses(p), jposes.recenter_poses(p)
        assert got.dtype == want.dtype == dtype
        np.testing.assert_array_equal(got, want)
        got = tposes.spherify_poses(got)
        want = jposes.spherify_poses(want)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)


def test_load_img_jpeg_matches_jax(tmp_path):
    """The port reads a JPEG (through PIL) into the JAX package's pixels
    (imageio, whose JPEG decoder is PIL's), color and gray."""
    from PIL import Image
    rng = np.random.RandomState(4)
    for name, arr in (('rgb.jpg', rng.rand(20, 30, 3)),
                      ('gray.JPEG', rng.rand(20, 30))):
        path = str(tmp_path / name)
        Image.fromarray((arr * 255).astype(np.uint8)).save(path, quality=80)
        got, want = tio.load_img(path), jio.load_img(path)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(tio.load_img(path, force_rgba=True),
                                      jio.load_img(path, force_rgba=True))


def test_jpeg_without_pil_raises(tmp_path):
    """Where PIL is missing, a JPEG raises; a PNG still reads."""
    png = str(tmp_path / 'a.png')
    tio.write_img(np.full((2, 3, 3), 0.5, np.float32), png)
    code = ("import sys\n"
            "sys.modules['PIL'] = None\n"
            "from nerfactor_tpu_torch.utils import io\n"
            "assert io.load_img(sys.argv[1]).shape == (2, 3, 3)\n"
            "try:\n"
            "    io.load_img(sys.argv[2])\n"
            "except ImportError:\n"
            "    print('raised')\n")
    proc = subprocess.run(
        [sys.executable, '-c', code, png, str(tmp_path / 'b.jpg')],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip() == 'raised'
