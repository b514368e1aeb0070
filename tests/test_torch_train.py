"""The PyTorch port's training slice vs the JAX package (CPU).

On the synthetic sphere scene of tests/test_torch_nerfactor.py (imh 8,
light_h 4, width-16 MLPs, 3 train views) with BRDF and shape experiments
written by the JAX package:

  * the datasets draw the same rays as the JAX package's from the same seed;
  * the joint model's training loss and every gradient leaf against the
    JAX model's ``_forward_rays`` + ``compute_loss`` under
    ``jax.value_and_grad``, with the same jitter noise fed to both;
  * ``trainable_mask`` freezes the BRDF prior (and the shape MLPs under
    shape_mode=frozen) in ``make_train_step``;
  * the TF-exact amsgrad optimizer's trajectory against
    ``build_optimizer`` at gradient scales 1 and 1e-8, with and without
    clipping;
  * both packages' trainvali CLIs resume from one JAX-written ckpt-1 and
    reach the same ckpt-3, which restores in the JAX package; the port's
    CLI writes a profiler trace with its spans' summary beside it and
    refuses --multihost without a process group to join.
"""

import json
import shutil
from os.path import exists, join

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nerfactor_tpu import trainvali as jtrainvali
from nerfactor_tpu.datasets.nerf_shape import Dataset as JDataset
from nerfactor_tpu.models import losses as jlosses
from nerfactor_tpu.parallel import train as jtrain
from nerfactor_tpu.utils import ckpt as jckpt, config as configutil
from nerfactor_tpu.utils import metrics as jmetrics
from nerfactor_tpu_torch import trainvali as ttrainvali
from nerfactor_tpu_torch.datasets.nerf_shape import Dataset as TDataset
from nerfactor_tpu_torch.models import losses as tlosses
from nerfactor_tpu_torch.models.nerfactor import Model as TModel
from nerfactor_tpu_torch.parallel import train as ttrain
from nerfactor_tpu_torch.utils import ckpt as tckpt, metrics as tmetrics
from tests.test_torch_nerfactor import build_scene, joint_override, make_joint

N_RAYS = 64


@pytest.fixture(scope='module')
def scene(tmp_path_factory):
    return build_scene(tmp_path_factory, n_train=3)


def rel_norm(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def test_datasets_draw_the_same_rays(scene):
    _, config, _, _ = make_joint(scene, 'data',
                                 'n_rays_per_step=%d' % N_RAYS)
    for mode in ('train', 'vali'):
        pj = JDataset(config, mode).build_pipeline(prefetch=0)
        pt = TDataset(config, mode).build_pipeline(prefetch=0)
        for _ in range(2):  # two epochs: reshuffled, resampled
            batches = list(zip(pj, pt))
            assert len(batches) == (3 if mode == 'train' else 1)
            for bj, bt in batches:
                assert bj['id'] == bt['id']
                for k in JDataset.array_keys:
                    np.testing.assert_array_equal(bt[k], bj[k], err_msg=k)


def test_losses_and_metrics_match_jax():
    rng = np.random.RandomState(0)
    a, b = rng.rand(2, 5, 7).astype(np.float32)
    for name in ('l1', 'l2'):
        for keep in (False, True):
            np.testing.assert_allclose(
                tlosses.get_loss_fn(name)(torch.from_numpy(a),
                                          torch.from_numpy(b),
                                          keep_batch=keep).numpy(),
                np.asarray(jlosses.get_loss_fn(name)(a, b, keep_batch=keep)),
                rtol=1e-6)
    assert tlosses.parse_loss_and_weight('1e+2l1') == ('l1', 100.0)
    assert [w for w, _ in tlosses.init_wloss('l2,2l1')] == [1.0, 2.0]
    with pytest.raises(NotImplementedError, match="'nope'"):
        tlosses.get_loss_fn('nope')
    im1, im2 = (rng.rand(16, 16, 3) * 255).astype(np.uint8), \
        (rng.rand(16, 16, 3) * 255).astype(np.uint8)
    assert tmetrics.psnr(im1, im2) == jmetrics.psnr(im1, im2)
    assert tmetrics.ssim(im1, im2) == jmetrics.ssim(im1, im2)


def _train_batch(config):
    batch = next(iter(JDataset(config, 'train').build_pipeline(prefetch=0)))
    return {k: np.asarray(batch[k], np.float32) for k in JDataset.array_keys}


def _jax_loss_fn(jmodel, arrays, noise):
    """The JAX model's train-mode loss with ``noise`` as the jitter
    (its ``apply`` draws the noise from a key)."""
    arrays = {k: jnp.asarray(v) for k, v in arrays.items()}

    def loss_fn(p):
        out = jmodel._forward_rays(
            p, arrays['xyz'], arrays['rayo'], arrays['normal'],
            arrays['lvis'], jitter_noise=jnp.asarray(noise))
        kwargs = {k: out.get(k) for k in TModel.JITTER_KEYS}
        pred = {k: out[k] for k in ('rgb', 'normal', 'lvis', 'albedo',
                                    'brdf')}
        gt = {k: arrays[k] for k in ('rgb', 'normal', 'lvis', 'alpha')}
        return jnp.mean(jmodel.compute_loss(p, pred, gt, **kwargs))

    return loss_fn


# f32: summation order only. bf16 chains: both programs round at the same
# casts, but sums in another order move single roundings by one bf16 ulp
# (2^-8), which the gradients carry to ~1e-2 of a leaf's norm.
LOSS_TOL = {'f32': (1e-5, 1e-4), 'bf16': (1e-3, 2e-2)}


@pytest.mark.parametrize('mode', ['f32', 'bf16'])
def test_joint_loss_and_grads_match_jax(scene, mode):
    extra = 'n_rays_per_step=%d' % N_RAYS
    if mode == 'f32':
        extra += ',bf16_big_chains=False'
    _, config, jmodel, jparams = make_joint(scene, 'grads_' + mode, extra)
    arrays = _train_batch(config)
    noise = (0.01 * np.random.RandomState(0).randn(N_RAYS, 3)).astype(
        np.float32)
    want_loss, want = jax.value_and_grad(
        _jax_loss_fn(jmodel, arrays, noise))(jparams)
    model = TModel(config, device='cpu')
    params = tckpt.tree_map(lambda t: t.requires_grad_(),
                            tckpt.params_from_jax(jparams))
    pred, gt, kwargs, _ = model.apply(
        params, {k: torch.from_numpy(v) for k, v in arrays.items()},
        mode='train', jitter_noise=torch.from_numpy(noise))
    assert all(kwargs[k] is not None for k in TModel.JITTER_KEYS)
    loss = torch.mean(model.compute_loss(params, pred, gt, **kwargs))
    leaves = tckpt.tree_leaves(params)
    got = torch.autograd.grad(loss, leaves, allow_unused=True)
    loss_tol, grad_tol = LOSS_TOL[mode]
    np.testing.assert_allclose(loss.item(), float(want_loss),
                               rtol=loss_tol)
    want_leaves = jax.tree_util.tree_leaves(want)
    assert len(want_leaves) == len(got)
    for i, (g, w) in enumerate(zip(got, want_leaves)):
        g = np.zeros(w.shape, np.float32) if g is None else g.numpy()
        if not np.asarray(w).any():
            assert not g.any(), i
            continue
        assert rel_norm(g, w) <= grad_tol, (i, rel_norm(g, w))


@pytest.mark.parametrize('shape_mode', ['finetune', 'frozen'])
def test_trainable_mask_freezes_leaves(scene, shape_mode):
    _, config, _, jparams = make_joint(
        scene, 'mask_' + shape_mode, 'n_rays_per_step=%d,shape_mode=%s'
        % (N_RAYS, shape_mode))
    model = TModel(config, device='cpu')
    params = tckpt.params_from_jax(jparams)
    before = tckpt.tree_map(torch.clone, params)
    optimizer = ttrain.build_optimizer(config)
    mask = model.trainable_mask(params)
    assert (model.needs_dw_false_keys() >= {'normal_mlp', 'lvis_out'}) \
        == (shape_mode == 'frozen')
    with pytest.raises(ValueError, match='trainable_mask'):
        ttrain.make_train_step(model, optimizer)
    step = ttrain.make_train_step(model, optimizer, mask)
    state = optimizer.init(params)
    arrays = {k: torch.from_numpy(v) for k, v in _train_batch(config).items()}
    with pytest.raises(ValueError, match='jitter'):
        step(params, state, arrays)
    for _ in range(2):
        params, state, loss = step(params, state, arrays,
                                   generator=torch.Generator().manual_seed(0))
        assert torch.isfinite(loss)
    frozen = {'brdf_mlp', 'brdf_out', 'latent_code'}
    if shape_mode == 'frozen':
        frozen |= {'normal_mlp', 'normal_out', 'lvis_mlp', 'lvis_out'}
    for k in params:
        same = all(torch.equal(a, b) for a, b in zip(
            tckpt.tree_leaves(before[k]), tckpt.tree_leaves(params[k])))
        assert same == (k in frozen), k
    if shape_mode == 'frozen':
        bad = dict(mask, normal_mlp=tckpt.tree_map(lambda _: True,
                                                   mask['normal_mlp']))
        with pytest.raises(ValueError, match="'normal_mlp'"):
            ttrain.make_train_step(model, optimizer, bad)


def _opt_config(clip):
    parser = configutil.read_config(
        configutil.resolve_config_path('nerfactor.ini'))
    configutil.apply_override(parser, 'lr=5e-3,lr_decay_steps=10,'
                              'lr_decay_rate=0.1,' + {
                                  'none': 'clipnorm=-1,clipvalue=-1',
                                  'clipnorm': 'clipnorm=0.5,clipvalue=-1',
                                  'clipvalue': 'clipnorm=-1,clipvalue=0.01',
                              }[clip])
    return configutil.Config(parser)


@pytest.mark.parametrize('clip', ['none', 'clipnorm', 'clipvalue'])
@pytest.mark.parametrize('scale', [1.0, 1e-8])
def test_optimizer_trajectory_matches_jax(clip, scale):
    """20 steps of the TF-exact amsgrad with exponential decay. At scale
    1e-8 the step is ~lr m / eps, where eps placement decides everything.
    Parameters held to rtol 1e-5 (f32 rounding of lr_t and the moments);
    the state's leaves come out in the JAX layout."""
    rng = np.random.RandomState(1)
    params = {'a': [{'b': rng.randn(3).astype(np.float32),
                     'w': rng.randn(4, 3).astype(np.float32)}],
              'z': rng.randn(2, 2).astype(np.float32)}
    config = _opt_config(clip)
    jopt = jtrain.build_optimizer(config)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jstate = jopt.init(jp)
    topt = ttrain.build_optimizer(config)
    tp = tckpt.params_from_jax(params)
    tstate = topt.init(tp)
    for _ in range(20):
        grads = jax.tree_util.tree_map(
            lambda x: (scale * rng.randn(*x.shape)).astype(np.float32),
            params)
        updates, jstate = jopt.update(
            jax.tree_util.tree_map(jnp.asarray, grads), jstate, jp)
        jp = optax.apply_updates(jp, updates)
        steps, tstate = topt.update(
            tckpt.tree_leaves(tckpt.params_from_jax(grads)), tstate)
        for p, s in zip(tckpt.tree_leaves(tp), steps):
            p.add_(s)
        for g, w in zip(tckpt.tree_leaves(tp), jax.tree_util.tree_leaves(jp)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                       atol=1e-6)
    jleaves = jax.tree_util.tree_leaves(jstate)
    tleaves = tckpt.tree_leaves(tstate)
    assert len(jleaves) == len(tleaves)
    assert int(tleaves[0]) == int(jleaves[0]) == 20
    for g, w in zip(tleaves[1:], jleaves[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-30)


def test_cli_resumes_jax_checkpoint_like_jax(scene):
    """Both CLIs resume from one JAX-written ckpt-1 (params + optimizer
    state) and train epochs 2-3 (6 steps) without jitter on the same rays.
    Their ckpt-3 params agree to 1e-4 (f32 gradients differ in summation
    order; Adam's normalised step passes that on where |m| is near eps);
    the port's ckpt-3 restores in the JAX package, and its vali writes the
    images, flipbooks, metadata and HTML."""
    override = joint_override(scene, 'cli_jax', ','.join([
        'n_rays_per_step=%d' % N_RAYS, 'xyz_jitter_std=0', 'ckpt_period=1',
        'vali_period=3', 'vali_batches=1', 'bf16_big_chains=False']))

    def run(pkg, outroot, epochs, *args):
        ov = override.replace(join(scene['out'], 'cli_jax'), outroot)
        pkg.main(['--config', 'nerfactor.ini', '--config_override',
                  ov + ',epochs=%d' % epochs, '--device', 'cpu', *args])
        return join(outroot, 'lr5e-3')

    jroot = join(scene['out'], 'cli_jax')
    troot = join(scene['out'], 'cli_port')
    jdir = run(jtrainvali, jroot, 1)
    shutil.copytree(jdir, join(troot, 'lr5e-3'))
    shutil.copy(jdir + '.ini', join(troot, 'lr5e-3.ini'))
    run(jtrainvali, jroot, 3)
    tdir = run(ttrainvali, troot, 3, '--profile_steps', '2')
    jleaves = tckpt.read_leaves(join(jdir, 'checkpoints', 'ckpt-3'))
    tleaves = tckpt.read_leaves(join(tdir, 'checkpoints', 'ckpt-3'))
    assert len(jleaves) == len(tleaves)
    assert [a.shape for a in jleaves] == [a.shape for a in tleaves]
    assert int(tleaves[0]) == int(jleaves[0]) == 9  # optimizer steps
    config = configutil.Config(configutil.read_config(tdir + '.ini'))
    n_params = len(tckpt.tree_leaves(
        TModel(config, device='cpu').init_params(torch.Generator())))
    for g, w in zip(tleaves[-n_params:], jleaves[-n_params:]):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)
    # The port's checkpoint in the JAX package's manager
    back = jckpt.CheckpointManager(join(tdir, 'checkpoints')).restore(
        _jax_state_template(config))
    for g, w in zip(jax.tree_util.tree_leaves(back), tleaves):
        np.testing.assert_array_equal(np.asarray(g), w)
    vali = join(tdir, 'vis_vali', 'epoch000000003')
    for f in ('all.html', 'pred_light.png', 'batch000000000/pred_rgb.png',
              'batch000000000/pred-vs-gt_rgb.apng',
              'batch000000000/metadata.json'):
        assert exists(join(vali, f)), f
    with open(join(tdir, 'summary_train', 'scalars.jsonl')) as f:
        # epoch 1 from the JAX run the port resumed
        assert [json.loads(line)['step'] for line in f] == [1, 2, 3]
    assert exists(join(tdir, 'profile', 'trace.json'))
    # Beside the trace, the program's spans of the profiled steps (the
    # first call's wait for its batch among them) and its counters
    with open(join(tdir, 'profile', 'spans.json')) as f:
        spans = json.load(f)
    assert spans['spans']['program.train.next_batch']['count'] >= 1
    assert 'train._GraphSteps.groups' in spans['counters']
    with pytest.raises(ValueError, match='torchrun'):
        ttrainvali.main(['--config', 'nerfactor.ini', '--multihost'])


def _jax_state_template(config):
    """{'params', 'opt_state'} shaped as the JAX trainvali saves them."""
    from nerfactor_tpu.models.nerfactor import Model as JModel
    model = JModel(config)
    params = model.init_params(jax.random.PRNGKey(0))
    return {'params': params,
            'opt_state': jtrain.build_optimizer(config).init(params)}
