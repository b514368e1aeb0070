"""The PyTorch port's BRDF prior (brdf.ini, explore_brdf_space) vs the JAX
package (CPU).

On synthetic MERL-format tables (3 materials of random Rusinkiewicz rows;
a shared test table in the reference's [characteristic slice | sphere
render] layout at ims 8 under a 4 x 8 'point' light) with width-16 MLPs:

  * the loss and every gradient leaf (the latent table included) against
    the JAX model's for each ``loss_transform``;
  * ``lookup_z``, and ``interp_z`` by lerp and (``normalize_z``) by slerp,
    and ``geom.slerp`` itself;
  * the dataset: the same training rows, vali tables and test identities;
  * both trainvali CLIs resume one JAX-written ckpt-1 and reach the same
    ckpt-3, which restores in the JAX package;
  * ``explore_brdf_space`` against the JAX CLI on one checkpoint;
  * ``bar_chart`` and ``make_video`` against the JAX helpers, and the MERL
    helpers and sphere renderer against brdf_tpu's;
  * the joint model of both packages restores a BRDF checkpoint the
    port's CLI wrote.
"""

import os
import shutil
from os.path import join

import imageio.v2 as imageio
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brdf_tpu import merl as jmerl, renderer as jrenderer
from nerfactor_tpu import explore_brdf_space as jexplore
from nerfactor_tpu import trainvali as jtrainvali
from nerfactor_tpu.datasets.brdf_merl import Dataset as JDataset
from nerfactor_tpu.datasets.nerf_shape import Dataset as JShapeDataset
from nerfactor_tpu.models.brdf import Model as JModel
from nerfactor_tpu.models.nerfactor import Model as JJointModel
from nerfactor_tpu.ops import geom as jgeom
from nerfactor_tpu.parallel import train as jtrain
from nerfactor_tpu.utils import ckpt as jckpt, config as configutil
from nerfactor_tpu.utils import vis as jvis
from nerfactor_tpu_torch import explore_brdf_space as texplore
from nerfactor_tpu_torch import trainvali as ttrainvali
from nerfactor_tpu_torch.brdf import merl as tmerl, renderer as trenderer
from nerfactor_tpu_torch.datasets.brdf_merl import Dataset as TDataset
from nerfactor_tpu_torch.models.brdf import Model as TModel
from nerfactor_tpu_torch.models.nerfactor import BRDF_PARAM_KEYS
from nerfactor_tpu_torch.models.nerfactor import Model as TJointModel
from nerfactor_tpu_torch.ops import geom as tgeom
from nerfactor_tpu_torch.utils import ckpt as tckpt, vis as tvis
from tests.test_torch_nerfactor import (
    _experiment, _files, build_scene, joint_override)
from tests.test_torch_train import LOSS_TOL, rel_norm

MATERIALS = ('alum-bronze', 'pearl-paint', 'red-plastic')
ENVMAP_H, IMS, N_ROWS = 4, 8, 128


def write_tables(root):
    """train_/vali_<name>.npz per material and the shared test.npz, in
    the format of data_gen_tpu/merl_make_dataset.py."""
    os.makedirs(root)
    rng = np.random.RandomState(0)
    common = {'envmap_h': ENVMAP_H, 'ims': IMS, 'spp': 1}
    for i, name in enumerate(MATERIALS):
        rusink = (rng.rand(300, 3) * [np.pi, np.pi / 2, np.pi / 2]).astype(
            np.float32)
        refl = (0.02 + rng.rand(300, 1) * (i + 1)).astype(np.float32)
        for mode, rows in (('train', slice(0, 256)), ('vali', slice(256, 300))):
            np.savez(join(root, '%s_%s.npz' % (mode, name)), i=i, name=name,
                     rusink=rusink[rows], refl=refl[rows], **common)
    ren = trenderer.SphereRenderer('point', None, envmap_h=ENVMAP_H,
                                   envmap_inten=40, ims=IMS)
    render = tmerl.dir2rusink(ren.ldir, ren.vdir)[ren.lvis.astype(bool)]
    np.savez(join(root, 'test.npz'), rusink=np.vstack((
        tmerl.characteristic_slice_rusink().reshape(-1, 3),
        render)).astype(np.float32), **common)


@pytest.fixture(scope='module')
def scene(tmp_path_factory):
    scene = build_scene(tmp_path_factory)
    scene['tables'] = join(scene['root'], 'merl_npz')
    write_tables(scene['tables'])
    return scene


def brdf_override(scene, name, extra=''):
    return ','.join([
        'data_root=%s' % scene['tables'],
        'outroot=%s' % join(scene['out'], name), 'mlp_width=16',
        'mlp_depth=2', 'mlp_skip_at=1',
        'n_rays_per_step=%d' % N_ROWS] + ([extra] if extra else []))


def make_brdf(scene, name, extra=''):
    """(config, JAX model, JAX params) of a BRDF experiment."""
    config = _experiment(join(scene['out'], name, 'run'), 'brdf.ini',
                         brdf_override(scene, name, extra))
    model = JModel(config)
    params = model.init_params(jax.random.PRNGKey(5))
    params['latent_code'] = params['latent_code'] * 50  # spread the codes
    return config, model, params


def train_batch(config):
    batch = next(iter(JDataset(config, 'train').build_pipeline(prefetch=0)))
    return {k: np.asarray(batch[k]) for k in JDataset.array_keys}


@pytest.mark.parametrize('transform', ['log', 'divide', 'none'])
def test_brdf_loss_and_grads_match_jax(scene, transform):
    config, jmodel, jparams = make_brdf(scene, 'grads_' + transform,
                                        'loss_transform=' + transform)
    arrays = train_batch(config)

    def loss_fn(p):
        pred, gt, kwargs, _ = jmodel.apply(
            p, {k: jnp.asarray(v) for k, v in arrays.items()}, mode='train')
        return jnp.mean(jmodel.compute_loss(p, pred, gt, **kwargs))

    want_loss, want = jax.value_and_grad(loss_fn)(jparams)
    model = TModel(config, device='cpu')
    params = tckpt.tree_map(lambda t: t.requires_grad_(),
                            tckpt.params_from_jax(jparams))
    pred, gt, kwargs, to_vis = model.apply(
        params, {k: torch.from_numpy(v) for k, v in arrays.items()},
        mode='train', generator=torch.Generator())
    assert sorted(to_vis) == ['brdf', 'brdf_reci', 'gt_brdf', 'z']
    loss = torch.mean(model.compute_loss(params, pred, gt, **kwargs))
    got = torch.autograd.grad(loss, tckpt.tree_leaves(params))
    loss_tol, grad_tol = LOSS_TOL['f32']
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=loss_tol)
    want_leaves = jax.tree_util.tree_leaves(want)
    assert len(want_leaves) == len(got) == 7  # the latent table last
    assert got[-1].shape == (len(MATERIALS), 3)
    for i, (g, w) in enumerate(zip(got, want_leaves)):
        assert rel_norm(g.numpy(), w) <= grad_tol, (i, rel_norm(g.numpy(), w))


def test_weight_bridge_carries_the_brdf_tree(scene):
    """params_from_jax / params_to_jax carry the BRDF tree, the latent
    table included, both ways with its leaves in JAX flatten order."""
    _, _, jparams = make_brdf(scene, 'bridge')
    tparams = tckpt.params_from_jax(jparams)
    jleaves = jax.tree_util.tree_leaves(jparams)
    assert [tuple(t.shape) for t in tckpt.tree_leaves(tparams)] == \
        [w.shape for w in jleaves]
    back = tckpt.params_to_jax(tparams)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(jparams)
    for g, w in zip(jax.tree_util.tree_leaves(back), jleaves):
        np.testing.assert_array_equal(g, np.asarray(w))


@pytest.mark.parametrize('interp', ['lerp', 'slerp'])
def test_lookup_and_interp_z_match_jax(scene, interp):
    config, jmodel, jparams = make_brdf(
        scene, 'z_' + interp, 'normalize_z=%s' % (interp == 'slerp'))
    model = TModel(config, device='cpu')
    params = tckpt.params_from_jax(jparams)
    ind = np.asarray([2, 0, 1, 2])
    np.testing.assert_allclose(
        model.lookup_z(params, torch.from_numpy(ind)).numpy(),
        np.asarray(jmodel.lookup_z(jparams, jnp.asarray(ind))), rtol=1e-6)
    for w in (1.0, 0.7, 0.3, 0.0):
        np.testing.assert_allclose(
            model.interp_z(params, w, 0, 1 - w, 2).numpy(),
            np.asarray(jmodel.interp_z(jparams, w, 0, 1 - w, 2)),
            rtol=1e-5, atol=1e-6)
    if interp == 'slerp':
        with pytest.raises(ValueError, match='sum to 1'):
            model.interp_z(params, 0.5, 0, 0.6, 2)


def test_slerp_matches_jax():
    rng = np.random.RandomState(3)
    p0, p1 = rng.randn(2, 1, 5).astype(np.float32)
    p0 /= np.linalg.norm(p0)
    p1 /= np.linalg.norm(p1)
    for a, b in ((p0, p1), (p0.T, p1.T)):
        for t in (0.0, 0.25, 0.5, 1.0):
            np.testing.assert_allclose(
                tgeom.slerp(torch.from_numpy(a), torch.from_numpy(b),
                            t).numpy(),
                np.asarray(jgeom.slerp(jnp.asarray(a), jnp.asarray(b), t)),
                rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match='singleton'):
        tgeom.slerp(torch.ones(2, 2), torch.ones(2, 2), 0.5)


def test_dataset_matches_jax(scene):
    config, _, _ = make_brdf(scene, 'data')
    for mode in ('train', 'vali', 'test'):
        dj, dt = JDataset(config, mode), TDataset(config, mode)
        assert dt.paths == dj.paths and dt.brdf_names == dj.brdf_names
        assert dt.get_n_brdfs() == dj.get_n_brdfs()
        pj, pt = dj.build_pipeline(prefetch=0), dt.build_pipeline(prefetch=0)
        for _ in range(2 if mode == 'train' else 1):
            for bj, bt in zip(pj, pt):
                assert sorted(bt) == sorted(bj)
                for k in bj:
                    np.testing.assert_array_equal(bt[k], bj[k], err_msg=k)
    ids = TDataset(config, 'test').paths['test']
    # Seen identities first, then 2 x 11 interpolated between materials
    assert ids[:3] == list(MATERIALS) and len(ids) == 3 + 2 * 11
    assert ids[3].startswith('000000_1.000000_')


def _jax_state_template(config):
    params = JModel(config).init_params(jax.random.PRNGKey(0))
    return {'params': params,
            'opt_state': jtrain.build_optimizer(config).init(params)}


def test_cli_resumes_jax_checkpoint_like_jax(scene):
    """Both CLIs resume one JAX-written ckpt-1 and train epochs 2-3 on the
    same rows; their ckpt-3 params agree to 1e-4, the port's restores in
    the JAX package, and the port's vali writes the JAX files."""
    override = brdf_override(scene, 'cli', 'ckpt_period=1,vali_period=3,'
                             'vali_batches=2')

    def run(pkg, outroot, epochs):
        ov = override.replace(join(scene['out'], 'cli'), outroot)
        pkg.main(['--config', 'brdf.ini', '--config_override',
                  ov + ',epochs=%d' % epochs, '--device', 'cpu'])
        return join(outroot, 'lr1e-2')

    jroot, troot = join(scene['out'], 'cli'), join(scene['out'], 'cli_port')
    jdir = run(jtrainvali, jroot, 1)
    shutil.copytree(jdir, join(troot, 'lr1e-2'))
    shutil.copy(jdir + '.ini', join(troot, 'lr1e-2.ini'))
    run(jtrainvali, jroot, 3)
    tdir = run(ttrainvali, troot, 3)
    jleaves = tckpt.read_leaves(join(jdir, 'checkpoints', 'ckpt-3'))
    tleaves = tckpt.read_leaves(join(tdir, 'checkpoints', 'ckpt-3'))
    assert [a.shape for a in jleaves] == [a.shape for a in tleaves]
    assert int(tleaves[0]) == int(jleaves[0]) == 9  # optimizer steps
    for g, w in zip(tleaves[-7:], jleaves[-7:]):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)
    config = configutil.Config(configutil.read_config(tdir + '.ini'))
    back = jckpt.CheckpointManager(join(tdir, 'checkpoints')).restore(
        _jax_state_template(config))
    for g, w in zip(jax.tree_util.tree_leaves(back), tleaves):
        np.testing.assert_array_equal(np.asarray(g), w)
    vali = 'vis_vali/epoch000000003'
    assert _files(join(tdir, vali)) == _files(join(jdir, vali))
    assert 'batch000000001/log10_brdf.png' in _files(join(tdir, vali))


def _identity_z(pkg, model, params, id_, i):
    """The latent code explore_brdf_space gives a test identity."""
    if i == -1:
        _, w1, mat1, w2, mat2 = id_.split('_')
        return model.interp_z(params, float(w1), model.brdf_names.index(mat1),
                              float(w2), model.brdf_names.index(mat2))
    ind = [i]
    return model.lookup_z(params, jnp.asarray(ind) if pkg == 'jax'
                          else torch.as_tensor(ind))


def test_explore_matches_jax(scene):
    """Both CLIs on one checkpoint (in two copies of the experiment):
    the same files and identities, the slice and render images within
    1/255, and every identity's reflectance within 1e-5."""
    config, jmodel, jparams = make_brdf(scene, 'explore')
    run = join(scene['out'], 'explore', 'run')
    jckpt.save_pytree({'params': jparams},
                      join(run, 'checkpoints', 'ckpt-2'))
    shutil.copytree(run, run + '_port')
    shutil.copy(run + '.ini', run + '_port.ini')
    jexplore.main(['--ckpt', join(run, 'checkpoints', 'ckpt-2')])
    got = texplore.main(['--ckpt', join(run + '_port', 'checkpoints',
                                        'ckpt-2'), '--device', 'cpu'])
    jroot = join(run, 'vis_test')
    troot = join(run + '_port', 'vis_test')
    files = _files(jroot)
    assert _files(troot) == files
    assert got['outroot'] == join(troot, 'ckpt-2')
    assert 'ckpt-2.apng' in files or 'ckpt-2.mp4' in files
    n_iden = 3 + 2 * 11
    assert sum(f.endswith('render.png') for f in files) == n_iden
    for f in files:
        if f.endswith(('render.png', 'cslice.png')):
            a = imageio.imread(join(troot, f)).astype(int)
            b = imageio.imread(join(jroot, f)).astype(int)
            assert a.shape == b.shape and np.abs(a - b).max() <= 1, f
        elif f.endswith('.json'):
            with open(join(troot, f)) as a, open(join(jroot, f)) as b:
                assert a.read() == b.read(), f
    model = TModel(config, device='cpu')
    params = tckpt.params_from_jax(jparams)
    for batch in JDataset(config, 'test').build_pipeline(prefetch=0):
        arrays = {k: np.asarray(batch[k]) for k in JDataset.array_keys}
        i = int(arrays['i'])
        want = jmodel.apply(
            jparams, {k: jnp.asarray(v) for k, v in arrays.items()},
            mode='test', z_override=_identity_z(
                'jax', jmodel, jparams, batch['id'], i))[3]['brdf']
        with torch.no_grad():
            have = model.apply(
                params, {k: torch.from_numpy(v) for k, v in arrays.items()},
                mode='test', z_override=_identity_z(
                    'torch', model, params, batch['id'], i))[3]['brdf']
        np.testing.assert_allclose(have.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-7, err_msg=batch['id'])


def test_bar_chart_and_make_video_match_jax(tmp_path):
    rng = np.random.RandomState(2)
    for i, values in enumerate((rng.randn(3), rng.rand(3, 64),
                                np.asarray([1.0, np.nan, 1.0]))):
        a = tvis.bar_chart(values, str(tmp_path / ('t%d.png' % i)))
        b = jvis.bar_chart(values, str(tmp_path / ('j%d.png' % i)))
        np.testing.assert_array_equal(imageio.imread(a), imageio.imread(b))
    frames = [(rng.rand(9, 11, 3) * 255).astype(np.uint8) for _ in range(4)]
    a = tvis.make_video(frames, str(tmp_path / 't' / 'v.mp4'), fps=2)
    b = jvis.make_video(frames, str(tmp_path / 'j' / 'v.mp4'), fps=2)
    assert os.path.basename(a) == os.path.basename(b)
    with open(a, 'rb') as fa, open(b, 'rb') as fb:
        assert fa.read() == fb.read()
    assert tvis.make_video([], str(tmp_path / 'none.mp4')) is None


def test_merl_helpers_and_renderer_match_brdf_tpu():
    merl = jmerl.MERL()
    np.testing.assert_array_equal(tmerl.characteristic_slice_rusink(),
                                  merl.get_characterstic_slice_rusink())
    ind = np.random.RandomState(0).randint(0, 90, (50, 3))
    np.testing.assert_array_equal(tmerl.merl_to_rusink(ind),
                                  jmerl.merl_to_rusink(ind))
    kw = dict(envmap_h=ENVMAP_H, envmap_inten=40, ims=IMS, spp=4)
    t = trenderer.SphereRenderer('point', None, **kw)
    j = jrenderer.SphereRenderer('point', None, **kw)
    for k in ('xyz', 'normal', 'world2local', 'ldir', 'vdir', 'lvis',
              'lcontrib'):
        np.testing.assert_array_equal(getattr(t, k), getattr(j, k),
                                      err_msg=k)
    np.testing.assert_array_equal(tmerl.dir2rusink(t.ldir, t.vdir),
                                  merl.dir2rusink(j.ldir, j.vdir))
    brdf = np.random.RandomState(1).rand(*t.lcontrib.shape)
    np.testing.assert_array_equal(t.render(brdf), j.render(brdf))
    cslice = np.random.RandomState(2).rand(90, 90)
    np.testing.assert_array_equal(tmerl.characteristic_slice_as_img(cslice),
                                  merl.characteristic_slice_as_img(cslice))


def test_joint_restores_port_brdf_checkpoint(scene):
    """A BRDF checkpoint the port's CLI wrote ({'opt_state', 'params'})
    restores into the joint model of both packages bit for bit, latent
    table included, and the joint forwards then agree."""
    out = ttrainvali.main(['--config', 'brdf.ini', '--device', 'cpu',
                           '--config_override', brdf_override(
                               scene, 'port_brdf', 'epochs=2,ckpt_period=2,'
                               'vali_period=0')])['outdir']
    brdf_ckpt = join(out, 'checkpoints', 'ckpt-2')
    brdf_config = configutil.Config(configutil.read_config(out + '.ini'))
    trained = tckpt.restore_trained_params(brdf_ckpt, TModel(
        brdf_config, device='cpu').init_params(torch.Generator()))
    override = joint_override(scene, 'from_port_brdf',
                              'bf16_big_chains=False').replace(
        scene['brdf_ckpt'], brdf_ckpt)
    config = _experiment(join(scene['out'], 'from_port_brdf', 'run'),
                         'nerfactor.ini', override)
    jmodel = JJointModel(config)
    jparams = jmodel.init_params(jax.random.PRNGKey(3))
    tparams = TJointModel(config, device='cpu').init_params(
        torch.Generator().manual_seed(3))
    for k in BRDF_PARAM_KEYS:
        for t, j, w in zip(tckpt.tree_leaves(tparams[k]),
                           jax.tree_util.tree_leaves(jparams[k]),
                           tckpt.tree_leaves(trained[k])):
            assert torch.equal(t, w) and np.array_equal(np.asarray(j),
                                                        w.numpy()), k
    batch = list(JShapeDataset(config, 'test').build_pipeline(
        no_shuffle=True, prefetch=0))[-1]
    arrays = {k: np.asarray(batch[k], np.float32)
              for k in JShapeDataset.array_keys}
    _, _, _, want = jmodel.apply(
        jparams, {k: jnp.asarray(v) for k, v in arrays.items()}, mode='test')
    with torch.no_grad():
        _, _, _, got = TJointModel(config, device='cpu').apply(
            tckpt.params_from_jax(jparams),
            {k: torch.from_numpy(v) for k, v in arrays.items()}, mode='test')
    for k in ('pred_rgb', 'pred_brdf', 'pred_albedo'):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
