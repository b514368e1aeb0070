"""The port's MVS path vs the JAX package (CPU): the ray tracer, the
DTU-style synthetic scan, dtu_surf_from_mvs, the mvs_shape dataset, the
shape_mvs.ini and nerfactor_mvs.ini stages and the MVS test video.

  * ``raytrace.intersect`` against the JAX tracer on seeded meshes (an
    icosphere and a triangle soup), with ray and triangle padding and rays
    that miss: hit mask and triangle index equal, ``t`` within 1e-6 +
    1e-5 |t| (rounding of its numerator and 1/det);
    ``face_normals`` equal; the PLY reader equal to the JAX package's
    copy on ASCII and binary files;
  * ``tools/synth_dtu.py`` writes the files of the ``dtu_scene`` fixture
    of tests/test_dtu_mvs.py: mesh and cameras byte for byte, images pixel
    for pixel;
  * both packages' dtu_surf_from_mvs on that scan at --h 16 --light_h 2:
    lights.npz, alpha and lvis equal, xyz and normal within 1e-5 (one f32
    rounding of the hit distance), the metadata equal, the resized
    images within one 8-bit level (resize antialiasing);
  * the mvs_shape datasets draw the same batches (train over two epochs,
    vali, test), exactly at the buffers' size and within 1e-5 resized;
  * both trainvali CLIs on shape_mvs.ini, then on nerfactor_mvs.ini from
    that shape checkpoint, each resuming one JAX-written ckpt-1 (f32
    chains, no jitter): ckpt-2 leaves within 1e-4;
  * test.py on the MVS joint checkpoint: the JAX CLI's files, and the
    frames both models compile for the video (the ``mvs_root`` layout)
    within one 8-bit level.
"""

import os
import shutil
from os.path import join

import imageio.v2 as imageio
import jax
import numpy as np
import pytest
import torch

from data_gen_tpu import dtu_surf_from_mvs as jdtu, meshio as jmeshio
from data_gen_tpu import raytrace as jraytrace
from nerfactor_tpu import test as jtest, trainvali as jtrainvali
from nerfactor_tpu.datasets.mvs_shape import Dataset as JDataset
from nerfactor_tpu.models.brdf import Model as JBRDFModel
from nerfactor_tpu.models.nerfactor import Model as JModel
from nerfactor_tpu.utils import ckpt as jckpt, config as configutil
from nerfactor_tpu.utils import io as jio, vis as jvis
from nerfactor_tpu_torch import test as ttest, trainvali as ttrainvali
from nerfactor_tpu_torch.data_gen import dtu_surf_from_mvs as tdtu
from nerfactor_tpu_torch.data_gen import meshio as tmeshio
from nerfactor_tpu_torch.data_gen import raytrace as traytrace
from nerfactor_tpu_torch.datasets.mvs_shape import Dataset as TDataset
from nerfactor_tpu_torch.models.nerfactor import Model as TModel
from nerfactor_tpu_torch.tools import synth_dtu
from nerfactor_tpu_torch.utils import ckpt as tckpt, io as tio, vis as tvis
from tests.test_dtu_mvs import dtu_scene  # noqa: F401 (fixture)
from tests.test_torch_nerfactor import _experiment, _files
from tests.test_torch_serving_compile import (
    assert_same_frames, captured_frames)

H, LIGHT_H = 16, 2
DTU_ARGS = ['--h', str(H), '--light_h', str(LIGHT_H), '--n_vali', '1',
            '--n_test', '3', '--lvis_eps', '0.05']
N_RAYS = 64


def soup(seed, n_tris=300, n_rays=1000):
    """A seeded triangle soup in a box and rays through it, a third of
    them pointing away from everything."""
    rng = np.random.RandomState(seed)
    verts = rng.uniform(-1, 1, (3 * n_tris, 3)).astype(np.float32)
    faces = np.arange(3 * n_tris).reshape(n_tris, 3)
    rayo = rng.uniform(-3, 3, (n_rays, 3)).astype(np.float32)
    rayd = (rng.uniform(-0.5, 0.5, (n_rays, 3)) - rayo).astype(np.float32)
    rayd[::3] = rayo[::3] * 2  # away from the box
    return verts, faces, rayo, rayd


def sphere_rays(seed, n_rays=777):
    verts, faces = synth_dtu.icosphere(r=1.0, subdiv=2)
    rng = np.random.RandomState(seed)
    rayo = rng.randn(n_rays, 3)
    rayo = (5.0 * rayo / np.linalg.norm(rayo, axis=1, keepdims=True))
    rayd = -rayo + rng.uniform(-1.5, 1.5, rayo.shape)  # some miss
    return verts, faces, rayo.astype(np.float32), rayd.astype(np.float32)


@pytest.mark.parametrize('mesh', ['sphere', 'soup'])
@pytest.mark.parametrize('chunks', [(4096, 8192), (64, 256)])
def test_intersect_matches_jax(mesh, chunks):
    verts, faces, rayo, rayd = (sphere_rays(0) if mesh == 'sphere'
                                else soup(1))
    ray_chunk, tri_chunk = chunks
    j_hit, j_t, j_idx = jraytrace.intersect(rayo, rayd, verts, faces,
                                            ray_chunk=ray_chunk,
                                            tri_chunk=tri_chunk)
    t_hit, t_t, t_idx = traytrace.intersect(rayo, rayd, verts, faces,
                                            ray_chunk=ray_chunk,
                                            tri_chunk=tri_chunk)
    assert t_hit.dtype == torch.bool and t_t.dtype == torch.float32
    assert 0.2 < j_hit.mean() < 0.9  # hits and misses both
    np.testing.assert_array_equal(t_hit.numpy(), j_hit)
    np.testing.assert_array_equal(t_idx.numpy(), j_idx)
    assert (t_idx.numpy()[~j_hit] == -1).all()
    assert np.isinf(t_t.numpy()[~j_hit]).all()
    np.testing.assert_allclose(t_t.numpy()[j_hit], j_t[j_hit], rtol=1e-5,
                               atol=1e-6)
    # Ray chunking never changes a ray's answer
    again = traytrace.intersect(torch.from_numpy(rayo),
                                torch.from_numpy(rayd), verts, faces,
                                ray_chunk=100, tri_chunk=tri_chunk)
    for a, b in zip(again, (t_hit, t_t, t_idx)):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(traytrace.face_normals(verts, faces),
                                  jraytrace.face_normals(verts, faces))


@pytest.mark.parametrize('fmt', ['ascii', 'binary'])
def test_read_ply_matches_jax(tmp_path, fmt):
    verts, faces = synth_dtu.icosphere(subdiv=1)
    path = str(tmp_path / 'mesh.ply')
    if fmt == 'ascii':
        tmeshio.write_ply(path, verts, faces)
    else:
        with open(path, 'wb') as h:
            h.write(b'ply\nformat binary_little_endian 1.0\n')
            h.write(b'element vertex %d\n' % len(verts))
            h.write(b'property float x\nproperty float y\n'
                    b'property float z\n')
            h.write(b'element face %d\n' % len(faces))
            h.write(b'property list uchar int vertex_indices\nend_header\n')
            h.write(verts.astype('<f4').tobytes())
            for f in faces:
                h.write(np.uint8(3).tobytes() + f.astype('<i4').tobytes())
    got, want = tmeshio.read_ply(path), jmeshio.read_ply(path)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got[1], faces)
    with open(path, 'r+b') as h:
        h.write(b'plx')
    with pytest.raises(ValueError, match='Not a PLY'):
        tmeshio.read_ply(path)


def test_synth_dtu_writes_the_fixture_files(dtu_scene,  # noqa: F811
                                            tmp_path):
    got = synth_dtu.make_scan(str(tmp_path))
    np.testing.assert_array_equal(got['center'], dtu_scene['center'])
    for key in ('cam_dir', 'img_dir', 'surf_dir'):
        names = sorted(os.listdir(dtu_scene[key]))
        assert sorted(os.listdir(got[key])) == names and names
        for name in names:
            a, b = join(got[key], name), join(dtu_scene[key], name)
            if name.endswith('.png'):
                np.testing.assert_array_equal(tio.load_img(a),
                                              jio.load_img(b))
            else:
                with open(a, 'rb') as fa, open(b, 'rb') as fb:
                    assert fa.read() == fb.read(), name


@pytest.fixture(scope='module')
def surf(tmp_path_factory):
    """The synthetic scan cast by both packages' dtu_surf_from_mvs."""
    root = str(tmp_path_factory.mktemp('tmvs'))
    scan = synth_dtu.make_scan(join(root, 'scan'))
    args = ['--cam_dir', scan['cam_dir'], '--img_dir', scan['img_dir'],
            '--surf_dir', scan['surf_dir']] + DTU_ARGS
    jdtu.main(args + ['--outdir', join(root, 'surf_jax')])
    run = tdtu.main(args + ['--outdir', join(root, 'surf_port'),
                            '--device', 'cpu'])
    return {'root': root, 'jax': join(root, 'surf_jax'),
            'port': join(root, 'surf_port'), 'run': run}


def test_dtu_surf_from_mvs_matches_jax(surf):
    names = sorted(os.listdir(surf['jax']))
    assert names == sorted(os.listdir(surf['port']))
    views = [n for n in names if not n.endswith('.npz')]
    assert views == ['test_000', 'test_001', 'test_002', 'train_000',
                     'train_001', 'train_002', 'val_000']
    jl, tl = (np.load(join(surf[k], 'lights.npz')) for k in ('jax', 'port'))
    for k in ('lxyzs', 'lareas'):
        np.testing.assert_array_equal(tl[k], jl[k])
    for view in views:
        jdir, tdir = join(surf['jax'], view), join(surf['port'], view)
        assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir))
        assert tio.read_json(join(tdir, 'metadata.json')) == \
            jio.read_json(join(jdir, 'metadata.json'))
        alpha = tio.load_img(join(tdir, 'alpha.png'))
        np.testing.assert_array_equal(alpha, jio.load_img(join(jdir,
                                                               'alpha.png')))
        assert 0.02 < (alpha > 0.5).mean() < 0.9
        for f, tol in (('xyz.npy', 1e-5), ('normal.npy', 1e-5),
                       ('lvis.npy', 0)):
            a, b = np.load(join(tdir, f)), np.load(join(jdir, f))
            assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
            np.testing.assert_allclose(a, b, rtol=tol, atol=tol, err_msg=f)
        for f in ('rgba.png', 'nn.png'):  # resized: one 8-bit level
            if os.path.exists(join(jdir, f)):
                np.testing.assert_allclose(tio.load_img(join(tdir, f)),
                                           jio.load_img(join(jdir, f)),
                                           rtol=0, atol=1 / 255 + 1e-6)
    run = surf['run']
    assert run['n_faces'] == 320 and sorted(run['views']) == views
    n_fg = (tio.load_img(join(surf['port'], 'train_000', 'alpha.png'))
            > 0).sum()
    assert run['views']['train_000']['rays'] == H * H + n_fg * 2 * LIGHT_H ** 2


def mvs_config(surf, name, ini, extra=''):
    outdir = join(surf['root'], name, 'run')
    return _experiment(outdir, ini, ','.join(
        ['mvs_root=%s' % surf['jax'], 'imh=%d' % H, 'light_h=%d' % LIGHT_H,
         'n_rays_per_step=%d' % N_RAYS] + ([extra] if extra else [])))


@pytest.mark.parametrize('imh', [H, H // 2])
def test_mvs_shape_batches_match_jax(surf, imh):
    config = mvs_config(surf, 'data_%d' % imh, 'shape_mvs.ini',
                        'imh=%d' % imh)
    for mode, epochs in (('train', 2), ('vali', 1), ('test', 1)):
        pj = JDataset(config, mode).build_pipeline(prefetch=0,
                                                   no_shuffle=mode != 'train')
        pt = TDataset(config, mode).build_pipeline(prefetch=0,
                                                   no_shuffle=mode != 'train')
        for _ in range(epochs):
            batches = list(zip(pj, pt))
            assert len(batches) == {'train': 3, 'vali': 1, 'test': 3}[mode]
            for bj, bt in batches:
                assert bj['id'] == bt['id'] and bj['hw'] == bt['hw']
                assert tuple(bt['hw']) == (imh, imh)
                for k in JDataset.array_keys:
                    if imh == H:
                        np.testing.assert_array_equal(bt[k], bj[k],
                                                      err_msg=k)
                    else:
                        np.testing.assert_allclose(bt[k], bj[k], rtol=1e-5,
                                                   atol=1e-5, err_msg=k)
                assert not bt['rayd'].any()


def _brdf_experiment(root):
    """A JAX-written BRDF prior at test width (three materials)."""
    tables = join(root, 'brdf_npz')
    os.makedirs(tables)
    for mat in ('alum-bronze', 'pearl-paint', 'red-plastic'):
        np.savez(join(tables, 'train_%s.npz' % mat),
                 rusink=np.zeros((4, 3), np.float32),
                 refl=np.ones((4, 1), np.float32))
    out = join(root, 'merl', 'lr1e-2')
    config = _experiment(out, 'brdf.ini', 'data_root=%s,mlp_width=16,'
                         'mlp_depth=2,mlp_skip_at=1' % tables)
    params = JBRDFModel(config).init_params(jax.random.PRNGKey(1))
    params['latent_code'] = params['latent_code'] * 50
    ckpt = join(out, 'checkpoints', 'ckpt-50')
    jckpt.save_pytree({'params': params}, ckpt)
    return ckpt


def resume_both(ini, override, jroot, troot):
    """JAX trainvali to epoch 1, then both CLIs from that ckpt-1 to epoch
    2; returns (JAX run dir, port run dir)."""
    xname = configutil.get_xname(configutil.read_config(
        configutil.resolve_config_path(ini)))

    def run(pkg, outroot, epochs, *args):
        pkg.main(['--config', ini, '--config_override', override
                  + ',outroot=%s,epochs=%d' % (outroot, epochs), *args])
        return join(outroot, xname)

    jdir = run(jtrainvali, jroot, 1)
    shutil.copytree(jdir, join(troot, xname))
    shutil.copy(jdir + '.ini', join(troot, xname + '.ini'))
    run(jtrainvali, jroot, 2)
    tdir = run(ttrainvali, troot, 2, '--device', 'cpu')
    jleaves = tckpt.read_leaves(join(jdir, 'checkpoints', 'ckpt-2'))
    tleaves = tckpt.read_leaves(join(tdir, 'checkpoints', 'ckpt-2'))
    assert [a.shape for a in jleaves] == [a.shape for a in tleaves]
    for g, w in zip(tleaves, jleaves):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)
    return jdir, tdir


def test_mvs_stages_and_video_match_jax(surf, monkeypatch):
    root = surf['root']
    common = ','.join([
        'mvs_root=%s' % surf['jax'], 'imh=%d' % H, 'light_h=%d' % LIGHT_H,
        'n_rays_per_step=%d' % N_RAYS, 'mlp_width=16', 'mlp_depth=2',
        'mlp_skip_at=1', 'mlp_chunk=8192', 'xyz_jitter_std=0',
        'bf16_big_chains=False', 'ckpt_period=1', 'vali_period=2',
        'vali_batches=1'])
    jshape, tshape = resume_both('shape_mvs.ini', common,
                                 join(root, 'shape_jax'),
                                 join(root, 'shape_port'))
    assert os.path.exists(join(tshape, 'vis_vali', 'epoch000000002',
                               'all.html'))
    probes = join(root, 'envmaps')
    os.makedirs(probes)
    rng = np.random.RandomState(0)
    for name in ('courtyard', 'sunset'):
        np.save(join(probes, name + '.npy'),
                rng.rand(LIGHT_H, 2 * LIGHT_H, 3).astype(np.float32))
    joint = common + ',' + ','.join([
        'brdf_model_ckpt=%s' % _brdf_experiment(root),
        'shape_model_ckpt=%s' % join(jshape, 'checkpoints', 'ckpt-2'),
        'test_envmap_dir=%s' % probes])
    jjoint, tjoint = resume_both('nerfactor_mvs.ini', joint,
                                 join(root, 'joint_jax'),
                                 join(root, 'joint_port'))
    # test.py on the JAX run's ckpt-2, each package in its own copy; the
    # video's frames captured from both models' compile
    shutil.copytree(jjoint, jjoint + '_t')
    shutil.copy(jjoint + '.ini', jjoint + '_t.ini')
    tcalls = captured_frames(monkeypatch, tvis)
    jcalls = captured_frames(monkeypatch, jvis)
    jtest.main(['--ckpt', join(jjoint, 'checkpoints', 'ckpt-2')])
    got = ttest.main(['--ckpt', join(jjoint + '_t', 'checkpoints', 'ckpt-2'),
                      '--device', 'cpu'])
    jax_root = join(jjoint, 'vis_test', 'ckpt-2')
    files = _files(jax_root)
    assert _files(got['outroot']) == files
    for f in files:
        if f.endswith('.png'):
            a = imageio.imread(join(got['outroot'], f)).astype(int)
            b = imageio.imread(join(jax_root, f)).astype(int)
            assert a.shape == b.shape and np.abs(a - b).max() <= 1, f
    (tframes, tpath, _), = tcalls
    (jframes, jpath, _), = jcalls
    assert tpath == got['outroot'] + '.mp4'
    n_olat = LIGHT_H * LIGHT_H  # the top half of the 2 x 4 lights
    assert len(tframes) == 3 + n_olat + 2 * 2 * 3
    assert_same_frames(tframes, jframes)
    config = configutil.Config(configutil.read_config(tjoint + '.ini'))
    model = TModel(config, device='cpu')
    assert model.n_lights == 2 * LIGHT_H ** 2
    np.testing.assert_array_equal(
        model.lxyz.numpy(),
        np.load(join(surf['jax'], 'lights.npz'))['lxyzs'].astype(np.float32))
    assert JModel(config).n_lights == model.n_lights
