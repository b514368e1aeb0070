"""The PyTorch port's shape stage (shape.ini) vs the JAX package (CPU).

On the synthetic sphere scene of tests/test_torch_nerfactor.py (imh 8,
light_h 4, 2 train views) with width-16 shape MLPs:

  * the training loss and every gradient leaf against the JAX model's
    ``apply`` + ``compute_loss`` under ``jax.value_and_grad``, in f32 and
    with the shipped bf16 lvis chain, jitter on (the JAX noise, drawn from
    its key, fed to the port) and off;
  * the twin-merged jitter probes against a direct evaluation at the
    jittered points, one 2N-row chain call per head with a nonzero
    smoothness weight, and the raise without a noise source;
  * the chunked vali forward (chunks smaller than the view, so the last
    one is padded) against JAX's ``_forward_chunked``;
  * the train-mode dataset draws the JAX package's foreground rays;
  * both trainvali CLIs resume one JAX-written ckpt-1 and reach the same
    ckpt-3, which restores in the JAX package; vali writes the JAX files;
  * the joint model of both packages, with shape_mode=finetune, restores
    a shape checkpoint the port's CLI wrote.

The shape step on the card is held against the CPU in
tests/test_torch_shape_kernels.py.
"""

import shutil
from os.path import join

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfactor_tpu import trainvali as jtrainvali
from nerfactor_tpu.datasets.nerf_shape import Dataset as JDataset
from nerfactor_tpu.models.nerfactor import Model as JJointModel
from nerfactor_tpu.models.shape import Model as JModel
from nerfactor_tpu.parallel import train as jtrain
from nerfactor_tpu.utils import ckpt as jckpt, config as configutil
from nerfactor_tpu_torch import trainvali as ttrainvali
from nerfactor_tpu_torch.datasets.nerf_shape import Dataset as TDataset
from nerfactor_tpu_torch.models.nerfactor import Model as TJointModel
from nerfactor_tpu_torch.models.nerfactor import SHAPE_PARAM_KEYS
from nerfactor_tpu_torch.models.shape import Model as TModel
from nerfactor_tpu_torch.ops.math import safe_l2_normalize
from nerfactor_tpu_torch.utils import ckpt as tckpt, io as tio
from tests.test_torch_nerfactor import (
    IMH, LIGHT_H, _experiment, _files, build_scene, joint_override)
from tests.test_torch_train import LOSS_TOL, rel_norm

N_RAYS = 128


@pytest.fixture(scope='module')
def scene(tmp_path_factory):
    return build_scene(tmp_path_factory, n_train=2)


def shape_override(scene, name, extra=''):
    """--config_override of a shape experiment on the shipped shape.ini
    at test width."""
    return ','.join([
        'data_root=%s' % scene['root'],
        'data_nerf_root=%s' % join(scene['root'], 'surf'),
        'outroot=%s' % join(scene['out'], name),
        'imh=%d' % IMH, 'light_h=%d' % LIGHT_H, 'mlp_width=16',
        'mlp_depth=2', 'mlp_skip_at=1', 'mlp_chunk=8192',
        'n_rays_per_step=%d' % N_RAYS] + ([extra] if extra else []))


def make_shape(scene, name, extra=''):
    """(config, JAX model, JAX params) of a shape experiment."""
    config = _experiment(join(scene['out'], name, 'run'), 'shape.ini',
                         shape_override(scene, name, extra))
    model = JModel(config)
    return config, model, model.init_params(jax.random.PRNGKey(7))


def first_batch(config, mode='train'):
    batch = next(iter(JDataset(config, mode).build_pipeline(prefetch=0)))
    return {k: np.asarray(batch[k], np.float32) for k in JDataset.array_keys}


def port_inputs(arrays):
    return {k: torch.from_numpy(v) for k, v in arrays.items()}


@pytest.mark.parametrize('jitter', ['jitter', 'no_jitter'])
@pytest.mark.parametrize('mode', ['f32', 'bf16'])
def test_shape_loss_and_grads_match_jax(scene, mode, jitter):
    extra = [] if mode == 'bf16' else ['bf16_big_chains=False']
    if jitter == 'no_jitter':
        extra.append('xyz_jitter_std=0')
    config, jmodel, jparams = make_shape(scene, 'grads_%s_%s' % (mode, jitter),
                                         ','.join(extra))
    arrays = first_batch(config)
    key = jax.random.PRNGKey(11)

    def loss_fn(p):
        pred, gt, kwargs, _ = jmodel.apply(
            p, {k: jnp.asarray(v) for k, v in arrays.items()}, mode='train',
            key=key)
        return jnp.mean(jmodel.compute_loss(p, pred, gt, **kwargs))

    want_loss, want = jax.value_and_grad(loss_fn)(jparams)
    model = TModel(config, device='cpu')
    noise = None
    if jitter == 'jitter':
        noise = torch.from_numpy(np.array(
            model.xyz_jitter_std * jax.random.normal(key, (N_RAYS, 3))))
    params = tckpt.tree_map(lambda t: t.requires_grad_(),
                            tckpt.params_from_jax(jparams))
    pred, gt, kwargs, _ = model.apply(params, port_inputs(arrays),
                                      mode='train', jitter_noise=noise)
    assert (kwargs['lvis_jitter'] is not None) == (jitter == 'jitter')
    assert (kwargs['normal_jitter'] is not None) == (jitter == 'jitter')
    loss = torch.mean(model.compute_loss(params, pred, gt, **kwargs))
    got = torch.autograd.grad(loss, tckpt.tree_leaves(params))
    loss_tol, grad_tol = LOSS_TOL[mode]
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=loss_tol)
    want_leaves = jax.tree_util.tree_leaves(want)
    assert len(want_leaves) == len(got) == 12
    for i, (g, w) in enumerate(zip(got, want_leaves)):
        assert rel_norm(g.numpy(), w) <= grad_tol, (i, rel_norm(g, w))


def test_weight_bridge_carries_the_shape_tree(scene):
    """params_from_jax / params_to_jax carry the shape tree both ways,
    its leaves in JAX flatten order."""
    config, _, jparams = make_shape(scene, 'bridge')
    tparams = tckpt.params_from_jax(jparams)
    jleaves = jax.tree_util.tree_leaves(jparams)
    template = TModel(config, device='cpu').init_params(torch.Generator())
    assert [tuple(t.shape) for t in tckpt.tree_leaves(tparams)] == \
        [tuple(t.shape) for t in tckpt.tree_leaves(template)] == \
        [w.shape for w in jleaves]
    back = tckpt.params_to_jax(tparams)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(jparams)
    for g, w in zip(jax.tree_util.tree_leaves(back), jleaves):
        np.testing.assert_array_equal(g, np.asarray(w))


def test_twin_merged_probes_match_direct_eval(scene):
    """The jitter probes ride the main rows' chain calls (2N rows a head)
    and equal each head evaluated directly at xyz + noise."""
    config, _, jparams = make_shape(scene, 'twins')
    model = TModel(config, device='cpu')
    params = tckpt.params_from_jax(jparams)
    arrays = port_inputs(first_batch(config))
    noise = model.xyz_jitter_std * torch.randn(
        (N_RAYS, 3), generator=torch.Generator().manual_seed(3))
    _, _, kwargs, _ = model.apply(params, arrays, mode='train',
                                  jitter_noise=noise)
    xyz_j = arrays['xyz'] + noise
    np.testing.assert_allclose(
        kwargs['normal_jitter'].numpy(),
        safe_l2_normalize(model.pred_normal_at(params, xyz_j), dim=1).numpy(),
        rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        kwargs['lvis_jitter'].numpy(),
        model.pred_lvis_at(params, xyz_j, model.calc_ldir(xyz_j)).numpy(),
        rtol=1e-6, atol=1e-6)
    # The same jitter from a generator of that seed
    _, _, drawn, _ = model.apply(
        params, arrays, mode='train',
        generator=torch.Generator().manual_seed(3))
    assert torch.equal(drawn['lvis_jitter'], kwargs['lvis_jitter'])


def test_zero_weight_head_runs_without_twin(scene, monkeypatch):
    """One chain call per head: 2N rows where the smoothness weight is
    nonzero, N where it is zero."""
    config, _, jparams = make_shape(scene, 'one_twin',
                                    'normal_smooth_weight=0')
    model = TModel(config, device='cpu')
    rows = {}
    chain = model._chain

    def record(params, mlp_name, out_name, plan, x_raw, **kw):
        rows.setdefault(mlp_name, []).append(x_raw.shape[0])
        return chain(params, mlp_name, out_name, plan, x_raw, **kw)

    monkeypatch.setattr(model, '_chain', record)
    _, _, kwargs, _ = model.apply(
        tckpt.params_from_jax(jparams), port_inputs(first_batch(config)),
        mode='train', generator=torch.Generator().manual_seed(0))
    assert kwargs['normal_jitter'] is None
    assert kwargs['lvis_jitter'] is not None
    assert rows == {'normal_mlp': [N_RAYS],
                    'lvis_mlp': [2 * N_RAYS * model.n_lights]}


def test_train_mode_without_noise_raises(scene):
    """The JAX model drops the probes when its key is None; the port
    raises instead of training without the smoothness priors."""
    config, _, jparams = make_shape(scene, 'no_noise')
    model = TModel(config, device='cpu')
    arrays = port_inputs(first_batch(config))
    with pytest.raises(ValueError, match='jitter'):
        model.apply(tckpt.params_from_jax(jparams), arrays, mode='train')


@pytest.mark.parametrize('mode', ['f32', 'bf16'])
def test_chunked_vali_forward_matches_jax(scene, mode):
    extra = '' if mode == 'bf16' else 'bf16_big_chains=False'
    config, jmodel, jparams = make_shape(scene, 'chunks_' + mode, extra)
    arrays = first_batch(config, 'vali')
    n = arrays['xyz'].shape[0]
    chunk = 24
    assert n % chunk and n > chunk  # the last chunk is padded
    jmodel.eval_ray_chunk = chunk
    model = TModel(config, device='cpu')
    model.eval_ray_chunk = chunk
    _, _, _, want = jmodel.apply(
        jparams, {k: jnp.asarray(v) for k, v in arrays.items()}, mode='vali')
    with torch.no_grad():
        _, _, _, got = model.apply(tckpt.params_from_jax(jparams),
                                   port_inputs(arrays), mode='vali')
    assert sorted(got) == sorted(want)
    tol = 1e-2 if mode == 'bf16' else 1e-5
    for k in want:
        assert tuple(got[k].shape) == tuple(want[k].shape), k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=tol, atol=tol, err_msg=k)


def test_train_mode_draws_the_jax_rays(scene):
    config, _, _ = make_shape(scene, 'data')
    pj = JDataset(config, 'train', seed=5).build_pipeline(prefetch=0)
    pt = TDataset(config, 'train', seed=5).build_pipeline(prefetch=0)
    for _ in range(2):  # two epochs: reshuffled, resampled
        batches = list(zip(pj, pt))
        assert len(batches) == 2
        for bj, bt in batches:
            assert bj['id'] == bt['id']
            assert (bt['alpha'] > 0.9).all()
            for k in JDataset.array_keys:
                assert bt[k].dtype == bj[k].dtype, k
                np.testing.assert_array_equal(bt[k], bj[k], err_msg=k)


def _jax_state_template(config):
    model = JModel(config)
    params = model.init_params(jax.random.PRNGKey(0))
    return {'params': params,
            'opt_state': jtrain.build_optimizer(config).init(params)}


def test_cli_resumes_jax_checkpoint_like_jax(scene):
    """Both CLIs resume one JAX-written ckpt-1 and train epochs 2-3
    without jitter on the same rays; their ckpt-3 params agree to 1e-4,
    the port's ckpt-3 restores in the JAX package, and the port's vali
    writes the JAX vis's files, the images within 1/255."""
    override = shape_override(scene, 'cli', ','.join([
        'xyz_jitter_std=0', 'ckpt_period=1', 'vali_period=3',
        'vali_batches=1', 'bf16_big_chains=False']))

    def run(pkg, outroot, epochs):
        ov = override.replace(join(scene['out'], 'cli'), outroot)
        pkg.main(['--config', 'shape.ini', '--config_override',
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
    assert int(tleaves[0]) == int(jleaves[0]) == 6  # optimizer steps
    for g, w in zip(tleaves[-12:], jleaves[-12:]):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)
    config = configutil.Config(configutil.read_config(tdir + '.ini'))
    back = jckpt.CheckpointManager(join(tdir, 'checkpoints')).restore(
        _jax_state_template(config))
    for g, w in zip(jax.tree_util.tree_leaves(back), tleaves):
        np.testing.assert_array_equal(np.asarray(g), w)
    vali = 'vis_vali/epoch000000003'
    files = _files(join(jdir, vali))
    assert _files(join(tdir, vali)) == files
    assert {'all.html', 'batch000000000/pred_normal.png',
            'batch000000000/pred-vs-gt_lvis.apng'} <= set(files)
    for f in files:
        if f.endswith('.png'):
            got = tio.read_png(join(tdir, vali, f)).astype(int)
            want = tio.read_png(join(jdir, vali, f)).astype(int)
            assert got.shape == want.shape, f
            assert np.abs(got - want).max() <= 1, f


def test_joint_restores_port_shape_checkpoint(scene):
    """A shape checkpoint the port's CLI wrote ({'opt_state', 'params'})
    restores into the joint model of both packages (shape_mode=finetune)
    bit for bit, and the joint forwards then agree."""
    out = ttrainvali.main(['--config', 'shape.ini', '--device', 'cpu',
                           '--config_override', shape_override(
                               scene, 'port_shape', 'epochs=2,ckpt_period=2,'
                               'vali_period=0')])['outdir']
    shape_ckpt = join(out, 'checkpoints', 'ckpt-2')
    shape_config = configutil.Config(configutil.read_config(out + '.ini'))
    trained = tckpt.restore_trained_params(shape_ckpt, TModel(
        shape_config, device='cpu').init_params(torch.Generator()))
    override = joint_override(scene, 'from_port_shape',
                              'bf16_big_chains=False').replace(
        scene['shape_ckpt'], shape_ckpt)
    config = _experiment(join(scene['out'], 'from_port_shape', 'run'),
                         'nerfactor.ini', override)
    assert config.get('shape_mode') == 'finetune'
    jmodel = JJointModel(config)
    jparams = jmodel.init_params(jax.random.PRNGKey(3))
    tmodel = TJointModel(config, device='cpu')
    tparams = tmodel.init_params(torch.Generator().manual_seed(3))
    for k in SHAPE_PARAM_KEYS:
        for t, j, w in zip(tckpt.tree_leaves(tparams[k]),
                           jax.tree_util.tree_leaves(jparams[k]),
                           tckpt.tree_leaves(trained[k])):
            assert torch.equal(t, w) and np.array_equal(np.asarray(j),
                                                        w.numpy()), k
    batch = list(JDataset(config, 'test').build_pipeline(
        no_shuffle=True, prefetch=0))[-1]
    arrays = {k: np.asarray(batch[k], np.float32)
              for k in JDataset.array_keys}
    _, _, _, want = jmodel.apply(
        jparams, {k: jnp.asarray(v) for k, v in arrays.items()}, mode='test')
    with torch.no_grad():
        _, _, _, got = tmodel.apply(tckpt.params_from_jax(jparams),
                                    port_inputs(arrays), mode='test')
    for k in ('pred_rgb', 'pred_normal', 'pred_lvis', 'pred_albedo'):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
