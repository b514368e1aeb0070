"""The port's GGX microfacet ablation (nerfactor_microfacet.ini) and the
other shipped joint INIs vs the JAX package (CPU).

On the synthetic sphere scene of tests/test_torch_nerfactor.py (imh 8,
light_h 4, width-16 MLPs) with JAX-written experiments:

  * ``microfacet_spec`` and ``microfacet_brdf``: values and the gradient
    of every input against JAX, over back-facing lights, grazing views,
    roughness near 0 and ``lambert_only``; values rtol 1e-3 (atol 1e-6)
    and gradients by relative norm 1e-3 (near the mirror direction at low
    roughness, D's (alpha^2 + tan^2)^2 carries one f32 rounding of the
    half vector ~10^3-fold: the two packages round the dot products in
    another order);
  * the microfacet model's loss and every gradient leaf against the JAX
    model's (the jitter noise fed to both), with the tolerances of
    tests/test_torch_train.py (the f32 lobe's gradients: see
    MICROFACET_GRAD_TOL_F32), and the same harness on every shipped joint
    INI that has no test of its own elsewhere (no_geom_opt: shape_mode
    nerf, no_geom_pretrain: scratch, no_smooth);
  * the microfacet model has no BRDF-prior leaves and no ``seen_z``, and
    never calls the BRDF prior's chain;
  * both trainvali CLIs resume one JAX-written ckpt-1 on
    nerfactor_microfacet.ini and reach the same ckpt-2 (rtol 1e-4, f32
    chains, no jitter); test.py then writes the JAX CLI's file set from
    it, its images within one 8-bit level.
"""

import os
import shutil
from os.path import dirname, join

import imageio.v2 as imageio
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfactor_tpu import test as jtest, trainvali as jtrainvali
from nerfactor_tpu.models.nerfactor import Model as JModel
from nerfactor_tpu.models.nerfactor_microfacet import Model as JMicroModel
from nerfactor_tpu.ops import microfacet as jmicro
from nerfactor_tpu.utils import ckpt as jckpt
from nerfactor_tpu_torch import test as ttest, trainvali as ttrainvali
from nerfactor_tpu_torch.models.nerfactor import Model as TModel
from nerfactor_tpu_torch.models.nerfactor_microfacet import (
    Model as TMicroModel)
from nerfactor_tpu_torch.ops import fused_rusink
from nerfactor_tpu_torch.ops import microfacet as tmicro
from nerfactor_tpu_torch.utils import ckpt as tckpt
from tests.test_torch_nerfactor import (
    _experiment, _files, build_scene, joint_override)
from tests.test_torch_train import (
    LOSS_TOL, N_RAYS, _jax_loss_fn, _train_batch, rel_norm)

MODELS = {'nerfactor': (JModel, TModel),
          'nerfactor_microfacet': (JMicroModel, TMicroModel)}


@pytest.fixture(scope='module')
def scene(tmp_path_factory):
    return build_scene(tmp_path_factory, n_train=3)


def make_variant(scene, ini, name, extra=''):
    """A joint experiment on the shipped ``ini`` at test width with a
    JAX-written ckpt-4: (ckpt, config, JAX model, JAX params)."""
    outdir = join(scene['out'], name, 'run')
    config = _experiment(outdir, ini, joint_override(scene, name, extra))
    jmodel = MODELS[config.get('model')][0](config)
    params = jmodel.init_params(jax.random.PRNGKey(3))
    ckpt = join(outdir, 'checkpoints', 'ckpt-4')
    jckpt.save_pytree({'params': params}, ckpt)
    return ckpt, config, jmodel, params


def lobe_inputs(seed, n=48, n_lights=24):
    """Seeded directions with the edge cases as rows: grazing views
    (v.n = 0), roughness near 0, lights behind the surface (most random
    lights are)."""
    rng = np.random.RandomState(seed)
    pts2l = rng.randn(n, n_lights, 3).astype(np.float32)
    pts2c = rng.randn(n, 3).astype(np.float32)
    normal = rng.randn(n, 3).astype(np.float32)
    normal[:4] = (0.0, 0.0, 1.0)
    pts2c[:4] = ((1.0, 0.0, 0.0), (0.0, 1.0, 0.0), (0.6, 0.8, 0.0),
                 (0.0, -2.0, 0.0))  # exactly grazing
    rough = rng.uniform(0.05, 1.0, (n, 1)).astype(np.float32)
    rough[4:8, 0] = (1e-4, 1e-3, 1e-2, 0.0)
    albedo = rng.rand(n, 3).astype(np.float32)
    return pts2l, pts2c, normal, rough, albedo


def test_lobe_inputs_cover_the_edge_cases():
    pts2l, pts2c, normal, _, _ = lobe_inputs(0)
    cos_l = np.einsum('nlc,nc->nl', pts2l, normal)
    assert (cos_l < 0).mean() > 0.3 and (cos_l > 0).mean() > 0.3
    assert (np.einsum('nc,nc->n', pts2c, normal)[:4] == 0).all()


@pytest.mark.parametrize('fn', ['spec', 'brdf', 'lambert_only',
                                'default_rough'])
@pytest.mark.parametrize('seed', [0, 1])
def test_microfacet_matches_jax(fn, seed):
    inputs = lobe_inputs(seed)
    f0 = 0.04 if seed else 0.91

    def call(mod, pts2l, pts2c, normal, rough, albedo):
        if fn == 'spec':
            return mod.microfacet_spec(pts2l, pts2c, normal, rough=rough,
                                       f0=f0)
        if fn == 'default_rough':
            return mod.microfacet_spec(pts2l, pts2c, normal,
                                       default_rough=0.2, f0=f0)
        return mod.microfacet_brdf(pts2l, pts2c, normal, albedo=albedo,
                                   rough=rough, f0=f0,
                                   lambert_only=fn == 'lambert_only')

    w = np.random.RandomState(9).randn(
        *np.shape(call(jmicro, *inputs))).astype(np.float32)
    want, want_g = jax.value_and_grad(
        lambda args: jnp.sum(call(jmicro, *args) * w))(
            tuple(jnp.asarray(x) for x in inputs))
    targs = [torch.from_numpy(x).requires_grad_() for x in inputs]
    out = call(tmicro, *targs)
    got = torch.sum(out * torch.from_numpy(w))
    got.backward()
    np.testing.assert_allclose(out.detach().numpy(),
                               np.asarray(call(jmicro, *inputs)),
                               rtol=1e-3, atol=1e-6)
    assert abs(got.item() - float(want)) <= 1e-4 * abs(float(want)) + 1e-5
    for i, (t, g) in enumerate(zip(targs, want_g)):
        g = np.asarray(g)
        if t.grad is None:
            assert not g.any(), i
            continue
        assert np.isfinite(t.grad.numpy()).all(), i
        assert rel_norm(t.grad.numpy(), g) <= 1e-3, (i, rel_norm(
            t.grad.numpy(), g))


# f32 gradients of the GGX lobe: at grazing views it divides by v.n, and
# the normal heads' gradients carry its rounding. Against the lobe in
# float64 (same model, seeded weights) the JAX package's f32 reads
# 3.0e-4-3.9e-4, the port's 6.8e-4-8.8e-4, and the two 3.4e-4-4.9e-4
# apart; every other leaf <= 1e-5.
MICROFACET_GRAD_TOL_F32 = 2e-3
SHIPPED_JOINT_INIS = [
    ('nerfactor_microfacet.ini', 'f32'), ('nerfactor_microfacet.ini', 'bf16'),
    ('nerfactor_no_geom_opt.ini', 'bf16'),
    ('nerfactor_no_geom_pretrain.ini', 'bf16'),
    ('nerfactor_no_smooth.ini', 'bf16')]


@pytest.mark.parametrize('ini,mode', SHIPPED_JOINT_INIS)
def test_shipped_joint_ini_loss_and_grads_match_jax(scene, ini, mode,
                                                    monkeypatch):
    extra = 'n_rays_per_step=%d' % N_RAYS
    if mode == 'f32':
        extra += ',bf16_big_chains=False'
    name = 'grads_%s_%s' % (ini[:-4], mode)
    _, config, jmodel, jparams = make_variant(scene, ini, name, extra)
    arrays = _train_batch(config)
    noise = (0.01 * np.random.RandomState(0).randn(N_RAYS, 3)).astype(
        np.float32)
    want_loss, want = jax.value_and_grad(
        _jax_loss_fn(jmodel, arrays, noise))(jparams)
    model = MODELS[config.get('model')][1](config, device='cpu')
    if not model.uses_learned_brdf:
        def no_prior(*args, **kwargs):
            raise AssertionError("the BRDF prior's chain was called")
        monkeypatch.setattr(fused_rusink, 'apply_rusink_chain', no_prior)
    params = tckpt.tree_map(lambda t: t.requires_grad_(),
                            tckpt.params_from_jax(jparams))
    assert sorted(params) == sorted(jparams)
    pred, gt, kwargs, _ = model.apply(
        params, {k: torch.from_numpy(v) for k, v in arrays.items()},
        mode='train', jitter_noise=torch.from_numpy(noise))
    loss = torch.mean(model.compute_loss(params, pred, gt, **kwargs))
    got = torch.autograd.grad(loss, tckpt.tree_leaves(params),
                              allow_unused=True)
    loss_tol, grad_tol = LOSS_TOL[mode]
    if mode == 'f32' and not model.uses_learned_brdf:
        grad_tol = MICROFACET_GRAD_TOL_F32
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=loss_tol)
    want_leaves = jax.tree_util.tree_leaves(want)
    assert len(want_leaves) == len(got)
    for i, (g, w) in enumerate(zip(got, want_leaves)):
        g = np.zeros(w.shape, np.float32) if g is None else g.numpy()
        if not np.asarray(w).any():
            assert not g.any(), i
            continue
        assert rel_norm(g, w) <= grad_tol, (i, rel_norm(g, w))


def test_microfacet_model_has_no_prior(scene):
    _, config, jmodel, jparams = make_variant(
        scene, 'nerfactor_microfacet.ini', 'no_prior',
        'n_rays_per_step=%d' % N_RAYS)
    model = TMicroModel(config, device='cpu')
    params = model.init_params(torch.Generator().manual_seed(0))
    assert sorted(params) == sorted(jparams) == [
        'albedo_mlp', 'albedo_out', 'brdf_z_mlp', 'brdf_z_out', 'light',
        'lvis_mlp', 'lvis_out', 'normal_mlp', 'normal_out']
    # The weight bridge round-trips the microfacet tree
    bridged = tckpt.params_from_jax(jparams)
    assert [tuple(t.shape) for t in tckpt.tree_leaves(bridged)] == \
        [tuple(t.shape) for t in tckpt.tree_leaves(params)]
    for a, b in zip(tckpt.tree_leaves(tckpt.params_to_jax(bridged)),
                    jax.tree_util.tree_leaves(jparams)):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert 'brdf' not in model.plans and model.z_dim == 1
    assert model.fresnel_f0 == 0.04
    assert model.needs_dw_false_keys() == frozenset()
    assert all(all(tckpt.tree_leaves(v))
               for v in model.trainable_mask(params).values())
    arrays = {k: torch.from_numpy(v) for k, v in _train_batch(config).items()}
    with torch.no_grad():
        pred, _, _, to_vis = model.apply(params, arrays, mode='vali')
    assert 'seen_z' not in to_vis
    rough = pred['brdf'].numpy()
    assert rough.shape == (arrays['xyz'].shape[0], 1)
    assert ((rough > 0) & (rough < 1)).all()  # the sigmoid head
    # The learned-prior model keeps its prior and its seen codes
    joint = TModel(_experiment(
        join(scene['out'], 'no_prior', 'joint'), 'nerfactor.ini',
        joint_override(scene, 'no_prior')), device='cpu')
    assert joint.needs_dw_false_keys() == frozenset({'brdf_mlp',
                                                     'brdf_out'})
    assert 'brdf' in joint.plans


def test_microfacet_clis_match_jax(scene):
    """Both trainvali CLIs resume one JAX-written ckpt-1 and train epoch
    2 on the same rays; the port's ckpt-2 is the JAX one's within 1e-4.
    test.py on that checkpoint writes the JAX test.py's files."""
    name = 'micro_cli'
    override = joint_override(scene, name, ','.join([
        'n_rays_per_step=%d' % N_RAYS, 'xyz_jitter_std=0', 'ckpt_period=1',
        'vali_period=2', 'vali_batches=1', 'bf16_big_chains=False']))

    def run(pkg, outroot, epochs, *args):
        ov = override.replace(join(scene['out'], name), outroot)
        pkg.main(['--config', 'nerfactor_microfacet.ini',
                  '--config_override', ov + ',epochs=%d' % epochs, *args])
        return join(outroot, 'lr5e-3')

    jroot, troot = join(scene['out'], name), join(scene['out'], name + '_pt')
    jdir = run(jtrainvali, jroot, 1)
    shutil.copytree(jdir, join(troot, 'lr5e-3'))
    shutil.copy(jdir + '.ini', join(troot, 'lr5e-3.ini'))
    run(jtrainvali, jroot, 2)
    tdir = run(ttrainvali, troot, 2, '--device', 'cpu')
    jleaves = tckpt.read_leaves(join(jdir, 'checkpoints', 'ckpt-2'))
    tleaves = tckpt.read_leaves(join(tdir, 'checkpoints', 'ckpt-2'))
    assert [a.shape for a in jleaves] == [a.shape for a in tleaves]
    assert int(tleaves[0]) == int(jleaves[0]) == 6  # optimizer steps
    for g, w in zip(tleaves, jleaves):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)
    vali = join(tdir, 'vis_vali', 'epoch000000002', 'batch000000000')
    brdf = imageio.imread(join(vali, 'pred_brdf.png'))
    assert brdf.ndim == 3 and (brdf[..., 0] == brdf[..., 2]).all()
    # test.py on the JAX run's ckpt-2, each package in its own copy
    shutil.copytree(jdir, jdir + '_t')
    shutil.copy(jdir + '.ini', jdir + '_t.ini')
    jtest.main(['--ckpt', join(jdir, 'checkpoints', 'ckpt-2')])
    got = ttest.main(['--ckpt', join(jdir + '_t', 'checkpoints', 'ckpt-2'),
                      '--device', 'cpu'])
    jax_root = join(jdir, 'vis_test', 'ckpt-2')
    files = _files(jax_root)
    assert _files(got['outroot']) == files
    assert 'batch000000002/pred_rgb_olat_0000-0000.png' in files
    assert os.path.isfile(got['video']) and dirname(got['video']) == \
        dirname(got['outroot'])
    for f in files:
        if f.endswith('.png'):
            a = imageio.imread(join(got['outroot'], f)).astype(int)
            b = imageio.imread(join(jax_root, f)).astype(int)
            assert a.shape == b.shape and np.abs(a - b).max() <= 1, f
