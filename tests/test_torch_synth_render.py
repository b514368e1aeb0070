"""The PyTorch port's synthetic-render module and debug loader vs the JAX
package's (CPU): ``write_view_metadata``, ``relabel_transforms`` and
``save_test_nearest_inputs`` on the same inputs, the Blender-Cycles body
of both modules under tests/fake_bpy.py's fake ``bpy`` (as
tests/test_nerf_synth_render_bpy.py drives the JAX one), the clear error
without Blender, and ``debug/dataloader.py`` on one scene.

Limits: JSON equal; images equal, but for the nearest-input composites
(their light-probe inset goes through the resize: within one 8-bit
level); EXR passes byte for byte; the debug loader's batch equal.
"""

import importlib
import json
import os
import sys
import types
from os.path import join

import numpy as np
import pytest

from nerfactor_tpu_torch.data_gen import nerf_synth_render as tsynth
from nerfactor_tpu_torch.utils import config as tconfig, io as tio
from tests import fake_bpy, synth
from tests.test_torch_data_gen import tree_files


def test_write_view_metadata_matches_jax(tmp_path):
    from data_gen_tpu.nerf_synth_render import write_view_metadata
    mat = np.arange(16, dtype=float).reshape(4, 4)
    args = (mat, 0.69, 'lego.blend', 'interior.hdr', 3, 512, 128)
    got = tsynth.write_view_metadata(str(tmp_path / 'port'), *args)
    want = write_view_metadata(str(tmp_path / 'jax'), *args)
    assert got == want
    meta = tio.read_json(str(tmp_path / 'port' / 'metadata.json'))
    assert meta == tio.read_json(str(tmp_path / 'jax' / 'metadata.json'))
    parsed = np.array([float(x) for x in
                       meta['cam_transform_mat'].split(',')]).reshape(4, 4)
    np.testing.assert_array_equal(parsed, mat)
    assert meta['imh'] == meta['imw'] == 512 and meta['spp'] == 128


def _fake_renders(out, rng):
    """Fake transforms and rendered rgba for train/val (test views
    empty), as tests/test_synth_render_helpers.py writes them."""
    for mode, n, dist in (('train', 3, 4.0), ('val', 1, 4.2),
                          ('test', 2, 4.4)):
        frames = [{'file_path': './orig/%d' % i,
                   'transform_matrix': c2w.tolist()}
                  for i, c2w in enumerate(synth.ring_cameras(n, dist=dist))]
        with open(join(out, 'cam_%s.json' % mode), 'w') as h:
            json.dump({'camera_angle_x': 0.69, 'frames': frames}, h)
        for i in range(n):
            vdir = join(out, '%s_%03d' % (mode, i))
            os.makedirs(vdir, exist_ok=True)
            if mode != 'test':
                tio.write_img(rng.rand(16, 16, 4).astype(np.float32),
                              join(vdir, 'rgba.png'))
    np.save(join(out, 'light.npy'), rng.rand(8, 16, 3).astype(np.float32))


def test_relabel_and_nearest_inputs_match_jax(tmp_path):
    from data_gen_tpu import nerf_synth_render as jsynth
    outs = {}
    for pkg, mod in (('jax', jsynth), ('port', tsynth)):
        out = outs[pkg] = str(tmp_path / pkg)
        os.makedirs(out)
        _fake_renders(out, np.random.RandomState(0))
        for mode in ('train', 'val', 'test'):
            angle, relabeled = mod.relabel_transforms(
                join(out, 'cam_%s.json' % mode), mode, out,
                vali_first_n=None)
            assert angle == 0.69
            assert relabeled[0]['file_path'] == './%s_000/rgba' % mode
        mod.save_test_nearest_inputs(out, join(out, 'light.npy'))
    files = tree_files(outs['jax'])
    assert tree_files(outs['port']) == files
    for f in files:
        got, want = join(outs['port'], f), join(outs['jax'], f)
        if f.endswith('.json'):
            assert tio.read_json(got) == tio.read_json(want), f
        elif f.endswith('.png'):
            g, w = tio.read_png(got).astype(int), tio.read_png(want).astype(
                int)
            assert g.shape == w.shape == (16, 16, 3 if 'nn' in f else 4), f
            assert np.abs(g - w).max() <= (1 if f.endswith('nn.png') else 0)
    for i in range(2):
        assert 'test_%03d/nn.png' % i in files
    # vali_first_n and debug cut the frames
    _, frames = tsynth.relabel_transforms(
        join(outs['port'], 'cam_train.json'), 'val', str(tmp_path),
        vali_first_n=2)
    assert len(frames) == 2
    _, frames = tsynth.relabel_transforms(
        join(outs['port'], 'cam_train.json'), 'train', str(tmp_path),
        debug=True)
    assert len(frames) == 1


# ------ the Blender body under the fake bpy ------

def install_port_bpy(mp):
    """fake_bpy.install for the port's module: fresh fake ``bpy`` and
    ``mathutils`` in sys.modules, the port's nerf_synth_render reloaded
    against them. Returns (module, fake)."""
    fake = fake_bpy.FakeBpy()
    bpy_mod = types.ModuleType('bpy')
    for attr in ('data', 'context', 'ops'):
        setattr(bpy_mod, attr, getattr(fake, attr))
    bpy_mod._fake = fake
    mathutils_mod = types.ModuleType('mathutils')
    mathutils_mod.Matrix = fake_bpy.Matrix
    mathutils_mod.Vector = fake_bpy.Vector
    mp.setitem(sys.modules, 'bpy', bpy_mod)
    mp.setitem(sys.modules, 'mathutils', mathutils_mod)
    module = importlib.reload(tsynth)
    assert module.HAS_BPY
    return module, fake


@pytest.fixture
def fake_blender():
    """Both packages' modules, each against its own fake Blender; the
    bpy-less modules come back after the test."""
    from _pytest.monkeypatch import MonkeyPatch
    mods = {}
    mp = MonkeyPatch()
    mods['jax'] = fake_bpy.install(mp)
    mp.undo()
    mp = MonkeyPatch()
    mods['port'] = install_port_bpy(mp)
    yield mods
    mp.undo()
    importlib.reload(mods['jax'][0])
    importlib.reload(tsynth)


def _write_blender_inputs(root):
    """The inputs of tests/test_nerf_synth_render_bpy.py: 2 train, 2 val,
    2 test cameras, a .npy light, a test HDR and an OLAT."""
    cam_dir = join(root, 'cams')
    os.makedirs(cam_dir)
    idx = 0
    for mode in ('train', 'val', 'test'):
        frames = []
        for _ in range(2):
            mat = np.eye(4)
            mat[:3, 3] = [2.0 + idx, idx, 4.0]
            frames.append({'file_path': './orig/r_%d' % idx,
                           'transform_matrix': mat.tolist()})
            idx += 1
        with open(join(cam_dir, 'transforms_%s.json' % mode), 'w') as h:
            json.dump({'camera_angle_x': 0.6911, 'frames': frames}, h)
    light = join(root, 'light.npy')
    np.save(light, np.random.RandomState(0).rand(4, 8, 3).astype(np.float32))
    tld = join(root, 'test_lights')
    os.makedirs(tld)
    with open(join(tld, 'studio.hdr'), 'wb') as h:
        h.write(b'fake-hdr')
    with open(join(tld, 'olat-0000-0000.json'), 'w') as h:
        json.dump({'point_location': [0.0, 0.0, 4.0]}, h)
    blend = join(root, 'scene.blend')
    with open(blend, 'wb') as h:
        h.write(b'fake-blend')
    return ['--scene_path', blend, '--cam_dir', cam_dir, '--light_path',
            light, '--test_light_dir', tld, '--light_inten', '3', '--res',
            '16', '--spp', '8', '--add_glossy_albedo', '--vali_first_n', '1']


def test_render_pipeline_under_fake_bpy_matches_jax(fake_blender, tmp_path):
    argv = _write_blender_inputs(str(tmp_path))
    outs = {}
    for pkg, (module, _) in fake_blender.items():
        outs[pkg] = str(tmp_path / ('render_' + pkg))
        module.main(argv + ['--outdir', outs[pkg]])
    files = tree_files(outs['jax'])
    assert tree_files(outs['port']) == files
    views = sorted({f.split('/')[0] for f in files if '/' in f})
    assert views == ['test_000', 'test_001', 'train_000', 'train_001',
                     'val_000']
    for f in files:
        got, want = join(outs['port'], f), join(outs['jax'], f)
        if f.endswith('.json'):
            assert tio.read_json(got) == tio.read_json(want), f
        elif f.endswith('.png'):
            g, w = tio.read_png(got).astype(int), tio.read_png(want).astype(
                int)
            assert g.shape == w.shape, f
            assert np.abs(g - w).max() <= (1 if f.endswith('nn.png') else 0)
        else:
            with open(got, 'rb') as a, open(want, 'rb') as b:
                assert a.read() == b.read(), f
    vd = join(outs['port'], 'train_000')
    albedo = tio.load_img(join(vd, 'albedo.png'))
    expect = (np.asarray(fake_bpy.DIFFUSE_COLOR)
              + np.asarray(fake_bpy.GLOSSY_COLOR))
    np.testing.assert_allclose(albedo[0, 0, :3], expect, atol=1 / 128)
    normal = tio.load_img(join(vd, 'normal.png'))
    np.testing.assert_allclose(
        normal[0, 0, :3], (np.asarray(fake_bpy.NORMAL_VALUE) + 1) / 2,
        atol=1 / 128)
    # Scene hygiene in the port's fake Blender
    fake = fake_blender['port'][1]
    names = [o.name for o in fake.data.objects]
    assert 'Camera' in names and 'Lego' in names
    for gone in ('Empty.001', 'BackgroundPlane', 'Sun', 'Glow', 'refball'):
        assert gone not in names, names
    assert not fake.data.objects['Lego'].hide_render
    # A second run skips every existing output
    stamp = os.path.getmtime(join(vd, 'rgba.png'))
    fake_blender['port'][0].main(argv + ['--outdir', outs['port']])
    assert os.path.getmtime(join(vd, 'rgba.png')) == stamp


def test_main_without_bpy_raises_clear_error(tmp_path):
    module = importlib.reload(tsynth)
    assert not module.HAS_BPY
    with pytest.raises(SystemExit, match='Blender'):
        module.main(['--scene_path', 'x', '--cam_dir', 'y',
                     '--light_path', 'z', '--outdir', str(tmp_path)])


# ------ the debug loader ------

def test_debug_dataloader_matches_jax(tmp_path):
    """Both loaders on one scene and INI: the port's returns the JAX
    one's batch (the same seeded ray sample)."""
    from nerfactor_tpu.debug import dataloader as jloader
    from nerfactor_tpu_torch.debug import dataloader as tloader
    root = str(tmp_path / 'scene')
    synth.make_scene(root, n_train=2, n_vali=1, n_test=1, imh=8)
    parser = tconfig.read_config(tconfig.resolve_config_path('nerf.ini'))
    tconfig.apply_override(parser,
                           'data_root=%s,imh=8,n_rays_per_step=16' % root)
    ini = str(tmp_path / 'exp.ini')
    tconfig.write_config(parser, ini)
    for mode, n_rays in (('train', 16), ('vali', 64)):
        got = tloader.main(['--config_ini', ini, '--mode', mode])
        want = jloader.main(['--config_ini', ini, '--mode', mode])
        assert got['rayo'].shape == (n_rays, 3)
        assert sorted(got) == sorted(want)
        for k in ('rayo', 'rayd', 'rgb'):
            np.testing.assert_array_equal(got[k], np.asarray(want[k]))
        assert got['id'] == want['id']
