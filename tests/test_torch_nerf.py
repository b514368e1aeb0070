"""The PyTorch port's NeRF slice vs the JAX package (CPU).

At small widths (trunk 32 x 4 with the skip after layer 2, 8 coarse + 16
fine samples) and on the same inputs, made with numpy from a seed:

  * the NeRF ops (``safe_cumprod``, ``inv_transform_sample``, ``gen_z``,
    ``gen_z_fine``, ``accumulate_sigma``, ``accumulate``), with the JAX
    package's random draws replayed through the explicit-draw arguments;
  * the field's plain version (``nerf_reference``) against the JAX
    package's and against its Pallas kernel in interpret mode, forward
    and weight gradients, f32 and bf16;
  * the model: ``apply`` in train (perturbed, with sigma noise), vali and
    test modes (test across several eval chunks), ``compute_loss`` and its
    gradients, with ``fused_mlp`` and ``bf16_big_chains`` on and off and
    without views;
  * the weight bridge, and both packages' trainvali CLIs on nerf.ini
    resuming from one JAX-written ckpt-1; the port's nerf_test CLI.

Tolerances: f32 1e-5 (summation order), gradients 1e-4 relative norm; bf16
as stated at each test (the two programs round at other places).
"""

import json
import shutil
from os.path import exists, join

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfactor_tpu import nerf_test as jnerf_test
from nerfactor_tpu import trainvali as jtrainvali
from nerfactor_tpu.models import networks as jnet
from nerfactor_tpu.models.nerf import Model as JModel
from nerfactor_tpu.ops import math as jmath
from nerfactor_tpu.ops import pallas_mlp as pm
from nerfactor_tpu.ops import pallas_nerf as pn
from nerfactor_tpu.ops import sampling as jsampling
from nerfactor_tpu.utils import ckpt as jckpt, config as configutil
from nerfactor_tpu_torch import nerf_test as tnerf_test
from nerfactor_tpu_torch import trainvali as ttrainvali
from nerfactor_tpu_torch.models import networks as tnet
from nerfactor_tpu_torch.models.nerf import Model as TModel
from nerfactor_tpu_torch.ops import fused_nerf as fn
from nerfactor_tpu_torch.ops import math as tmath
from nerfactor_tpu_torch.ops import sampling as tsampling
from nerfactor_tpu_torch.utils import ckpt as tckpt, io as tio
from tests import synth

F32 = dict(rtol=1e-5, atol=1e-5)


def t(x):
    return torch.from_numpy(np.array(x, np.float32))


def rel_norm(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


# ------ ops ------

def test_safe_cumprod_matches_jax():
    x = np.random.RandomState(0).rand(5, 9).astype(np.float32)
    np.testing.assert_allclose(tmath.safe_cumprod(t(x)).numpy(),
                               np.asarray(jmath.safe_cumprod(x)), rtol=1e-6)


def _bins_jax(cdf, u):
    """The JAX package's bin indices (its compare-and-sum)."""
    ind = jnp.sum((u[:, :, None] >= cdf[:, None, :]).astype(jnp.int32), -1)
    return (np.asarray(jnp.maximum(0, ind - 1)),
            np.asarray(jnp.minimum(ind, cdf.shape[1] - 1)))


def test_searchsorted_picks_the_jax_bins():
    """searchsorted(right=True) against the compare-and-sum on one CDF,
    with zero-weight bins (repeated CDF values) and draws exactly on CDF
    values, 0 and 1."""
    rng = np.random.RandomState(1)
    w = rng.rand(6, 7).astype(np.float32)
    w[:, 2:4] = 0
    cdf = np.concatenate([np.zeros((6, 1), np.float32),
                          np.cumsum(w / w.sum(1, keepdims=True), 1)], 1)
    u = rng.rand(6, 12).astype(np.float32)
    u[:, :4] = cdf[:, [0, 2, 3, 4]]
    u[:, 4] = 1.0
    ind = torch.searchsorted(t(cdf), t(u), right=True)
    below, above = _bins_jax(jnp.asarray(cdf), jnp.asarray(u))
    np.testing.assert_array_equal(torch.clamp(ind - 1, min=0).numpy(), below)
    np.testing.assert_array_equal(
        torch.clamp(ind, max=cdf.shape[1] - 1).numpy(), above)


@pytest.mark.parametrize('det', [True, False])
def test_inv_transform_sample_matches_jax(det):
    rng = np.random.RandomState(2)
    val = np.sort(rng.uniform(2, 6, (16, 9)), 1).astype(np.float32)
    w = rng.rand(16, 9).astype(np.float32)
    w[:3] = 0  # empty rays: all bins of zero weight
    w[3:6, ::2] = 0
    key = jax.random.PRNGKey(3)
    want = jmath.inv_transform_sample(val, w, 24, det=det, key=key)
    u = None if det else t(jax.random.uniform(key, (16, 24)))
    got = tmath.inv_transform_sample(t(val), t(w), 24, det=det, u=u)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize('perturb', [False, True])
@pytest.mark.parametrize('lin_in_disp', [False, True])
def test_gen_z_matches_jax(lin_in_disp, perturb):
    key = jax.random.PRNGKey(4)
    want = jsampling.gen_z(2.0, 6.0, 8, 5, lin_in_disp=lin_in_disp,
                           perturb=perturb, key=key)
    got = tsampling.gen_z(2.0, 6.0, 8, 5, lin_in_disp=lin_in_disp,
                          perturb=perturb,
                          t_rand=t(jax.random.uniform(key, (5, 8))))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def _coarse(seed, n_rays=6, n=8):
    rng = np.random.RandomState(seed)
    z = np.sort(rng.uniform(2, 6, (n_rays, n)), 1).astype(np.float32)
    w = rng.rand(n_rays, n).astype(np.float32)
    return z, w


@pytest.mark.parametrize('perturb', [False, True])
def test_gen_z_fine_matches_jax(perturb):
    z, w = _coarse(5)
    key = jax.random.PRNGKey(6)
    want = jsampling.gen_z_fine(z, w, 16, perturb=perturb, key=key)
    u = t(jax.random.uniform(key, (6, 16))) if perturb else None
    got = tsampling.gen_z_fine(t(z), t(w), 16, perturb=perturb, u=u)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


@pytest.mark.parametrize('noise_std', [0.0, 0.5])
def test_accumulate_sigma_matches_jax(noise_std):
    z, _ = _coarse(7)
    rng = np.random.RandomState(8)
    sigma = rng.randn(6, 8).astype(np.float32)
    rayd = rng.randn(6, 3).astype(np.float32)
    key = jax.random.PRNGKey(9)
    want = jsampling.accumulate_sigma(sigma, z, rayd, noise_std=noise_std,
                                      key=key)
    got = tsampling.accumulate_sigma(
        t(sigma), t(z), t(rayd), noise_std=noise_std,
        noise=t(jax.random.normal(key, (6, 8))))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-7)


@pytest.mark.parametrize('white_bg', [False, True])
def test_accumulate_matches_jax(white_bg):
    z, w = _coarse(10)
    rgbs = np.random.RandomState(11).randn(6, 8, 4).astype(np.float32)
    want = jsampling.accumulate(rgbs, z, w / 8, white_bg)
    got = tsampling.accumulate(t(rgbs), t(z), t(w / 8), white_bg)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, err_msg=k)


@pytest.mark.parametrize('mode', ['f32', 'bf16'])
def test_apply_mlp_compute_dtype_matches_jax(mode):
    """bf16: the JAX package rounds the product and the bias sum apart,
    the port once after both; 1e-2 covers that bf16 ulp."""
    jd, td, tol = {'f32': (None, None, 1e-5),
                   'bf16': (jnp.bfloat16, torch.bfloat16, 1e-2)}[mode]
    spec = jnet.MLPSpec(27, [16, 16, 8], acts=['relu', 'relu', None],
                        skip_at=[1])
    p = spec.init(jax.random.PRNGKey(0))
    x = np.random.RandomState(0).randn(9, 27).astype(np.float32)
    tspec = tnet.MLPSpec(27, [16, 16, 8], acts=['relu', 'relu', None],
                         skip_at=[1])
    got = tspec.apply(tckpt.params_from_jax(p), t(x), compute_dtype=td)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(
        got.numpy(), np.asarray(spec.apply(p, jnp.asarray(x),
                                           compute_dtype=jd)),
        rtol=tol, atol=tol)


# ------ the field ------

def small_plan():
    return dict(n_freqs_xyz=10, n_freqs_view=4, width=32, depth=4,
                skip_at=2, act='relu', rgb_widths=(16, 3),
                rgb_acts=('relu', None))


def field_params(nplan, seed):
    """Glorot-uniform weights, small biases: (trunk, sigma, bottleneck,
    rgb) lists of numpy (w, b)."""
    rng = np.random.RandomState(seed)
    tp = nplan.trunk_plan
    width = tp.widths[-1]

    def dense(din, dout):
        lim = np.sqrt(6.0 / (din + dout))
        return (rng.uniform(-lim, lim, (din, dout)).astype(np.float32),
                (0.05 * rng.randn(dout)).astype(np.float32))
    trunk = [dense(d, w) for d, w in zip(pm.layer_in_dims(tp), tp.widths)]
    return (trunk, [dense(width, 1)], [dense(width, width)],
            [dense(width + fn.view_dim(nplan), nplan.rgb_widths[0]),
             dense(*nplan.rgb_widths)])


def field_inputs(n, seed):
    """Points in [-1.5, 1.5]^3 and unit view directions, (n, 3) f32;
    output cotangents (n, 3) and (n, 1) in [-1, 1]."""
    rng = np.random.RandomState(seed)
    pts = rng.uniform(-1.5, 1.5, (n, 3)).astype(np.float32)
    views = rng.randn(n, 3)
    views = (views / np.linalg.norm(views, axis=1, keepdims=True)).astype(
        np.float32)
    return (pts, views, rng.uniform(-1, 1, (n, 3)).astype(np.float32),
            rng.uniform(-1, 1, (n, 1)).astype(np.float32))


def torch_params(p, device='cpu'):
    return tuple([(t(w).to(device), t(b).to(device)) for w, b in g]
                 for g in p)


def plain_field(nplan, pts, views, drgb, dsig, params, td):
    """The plain version's (rgb, sigma) and its weight gradients for the
    output cotangents, flattened as ``fused_nerf.flatten``."""
    flat = [x.clone().requires_grad_() for x in fn.flatten(params)]
    rgb, sigma = fn.nerf_reference(nplan, pts, views,
                                   fn.unflatten(nplan, flat), td)
    grads = torch.autograd.grad([rgb, sigma], flat, [drgb, dsig])
    return rgb.detach(), sigma.detach(), list(grads)


def jax_field(nplan, p, pts, views, drgb, dsig, jd, kernel):
    """(rgb, sigma, flattened weight gradients) of the JAX package's
    nerf_reference, or of its Pallas kernel in interpret mode."""
    jp = tuple([(jnp.asarray(w), jnp.asarray(b)) for w, b in g] for g in p)

    def f(params):
        if kernel:
            return pn.apply_nerf(nplan, jnp.asarray(pts), jnp.asarray(views),
                                 params, compute_dtype=jd)
        return pn.nerf_reference(nplan, jnp.asarray(pts), jnp.asarray(views),
                                 params, compute_dtype=jd)
    pm.INTERPRET = kernel
    try:
        (rgb, sigma), vjp = jax.vjp(f, jp)
        (g,) = vjp((jnp.asarray(drgb), jnp.asarray(dsig)))
    finally:
        pm.INTERPRET = False
    flat = [np.asarray(x) for grp in g for pair in grp for x in pair]
    return np.asarray(rgb), np.asarray(sigma), flat


DTYPES = {'f32': (None, None), 'bf16': (jnp.bfloat16, torch.bfloat16)}
# (outputs abs + rel, weight gradients per-leaf relative norm). The plain
# versions of the two packages round at the same casts (readings over 3
# seeds <= 6.6e-7 and 7.9e-7 in f32 and bf16; the bf16 bound leaves room
# for one bf16 ulp where an f32 ulp moves a value across a rounding). The
# Pallas kernel's double-angle trig errs ~2^f ulp at octave f (10 octaves
# here): f32 readings <= 8.5e-5 and 2.1e-5. In bf16 the Pallas kernel also
# rounds the bottleneck and rgb layer 0's operands, and its backward rounds
# other cotangents than the plain version's autograd: readings <= 6.3e-3
# and 0.024-0.109.
FIELD_TOL = {('f32', False): (1e-5, 1e-4), ('f32', True): (2e-4, 1e-4),
             ('bf16', False): (1e-2, 2e-2), ('bf16', True): (2e-2, 0.2)}


@pytest.mark.parametrize('kernel', [False, True], ids=['reference', 'pallas'])
@pytest.mark.parametrize('mode', ['f32', 'bf16'])
def test_nerf_reference_matches_jax(mode, kernel):
    kw = small_plan()
    jplan, nplan = pn.make_nerf_plan(**kw), fn.make_nerf_plan(**kw)
    assert tuple(jplan.trunk_plan) == tuple(nplan.trunk_plan)
    p = field_params(nplan, seed=12)
    pts, views, drgb, dsig = field_inputs(70, seed=13)
    jd, td = DTYPES[mode]
    want = jax_field(jplan, p, pts, views, drgb, dsig, jd, kernel)
    got = plain_field(nplan, t(pts), t(views), t(drgb), t(dsig),
                      torch_params(p), td)
    tol, grad_tol = FIELD_TOL[mode, kernel]
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g.numpy(), w, rtol=tol, atol=tol)
    assert len(got[2]) == len(want[2])
    for i, (g, w) in enumerate(zip(got[2], want[2])):
        assert rel_norm(g, w) <= grad_tol, (i, rel_norm(g, w))


def test_nerf_param_packing_round_trips():
    nplan = fn.make_nerf_plan(**small_plan())
    p = torch_params(field_params(nplan, seed=14))
    dense, aux = fn.pack_params(nplan, p, torch.float32)
    off = fn.layout(nplan)
    assert (dense.numel(), aux.numel()) == (off['n_dense'], off['n_aux'])
    back = fn.unpack_grads(nplan, torch.cat([dense, aux]))
    for a, b in zip(fn.flatten(back), fn.flatten(p)):
        assert torch.equal(a, b)
    assert fn.kernel_supports(nplan)
    with pytest.raises(ValueError, match='do not fit'):
        fn.pack_params(fn.make_nerf_plan(**dict(small_plan(), width=16)), p,
                       torch.float32)


# ------ the model ------

IMH = 8
# 4 xyz octaves, not 10: the two packages' sums round the importance
# samples' depths apart by an ulp (another reduction order), and posenc
# multiplies a point's ulp by 2^(octaves - 1) before the field sees it
# (10 octaves here moved the fine depths by 3e-3; the field tests above
# run all 10)
MODEL_BASE = ('imh=%d,mlp_width=32,enc_depth=4,n_samples_coarse=8,'
              'n_samples_fine=16,n_rays_per_step=64,n_freqs_xyz=4,'
              'n_freqs_view=2' % IMH)
# name -> (override, bf16)
MODEL_CASES = {
    'fused_bf16': ('', True),
    'fused_f32': ('bf16_big_chains=False', False),
    'unfused_bf16': ('fused_mlp=False', True),
    'unfused_f32': ('fused_mlp=False,bf16_big_chains=False', False),
    'no_views': ('use_views=False,bf16_big_chains=False', False),
}


def nerf_config(extra='', **kv):
    parser = configutil.read_config(configutil.resolve_config_path(
        'nerf.ini'))
    override = ','.join([MODEL_BASE] + ['%s=%s' % x for x in kv.items()]
                        + ([extra] if extra else []))
    configutil.apply_override(parser, override)
    return configutil.Config(parser)


def model_pair(case, **kv):
    config = nerf_config(MODEL_CASES[case][0], **kv)
    jmodel = JModel(config)
    jparams = jmodel.init_params(jax.random.PRNGKey(15))
    return jmodel, jparams, TModel(config, device='cpu')


def ray_batch(n, seed):
    """Rays from a ring of cameras at distance 4 towards the origin."""
    rng = np.random.RandomState(seed)
    rayo = rng.randn(n, 3)
    rayo = 4 * rayo / np.linalg.norm(rayo, axis=1, keepdims=True)
    rayd = -rayo / 4 + 0.2 * rng.randn(n, 3)
    return {'rayo': rayo.astype(np.float32), 'rayd': rayd.astype(np.float32),
            'rgb': rng.rand(n, 3).astype(np.float32)}


def jax_draws(model, key, n_rays):
    """The draws the JAX model's train-mode render_rays makes from
    ``key``, as the port's explicit-draw arguments."""
    keys = jax.random.split(key, 3)
    return {'t_rand_coarse': t(jax.random.uniform(
                keys[0], (n_rays, model.n_samples_coarse))),
            'sigma_noise': t(jax.random.normal(
                keys[1], (n_rays, model.n_samples_coarse))),
            'u_fine': t(jax.random.uniform(
                keys[2], (n_rays, model.n_samples_fine)))}


def assert_vis_close(got, want, tol):
    assert sorted(got) == sorted(want)
    for k in want:
        assert tuple(got[k].shape) == tuple(want[k].shape), k
        np.testing.assert_allclose(got[k].detach().numpy(),
                                   np.asarray(want[k]), rtol=tol, atol=tol,
                                   err_msg=k)


# Test and vali renders: f32 summation order; bf16 roundings move sigma by
# ~1e-2, which the weights and the importance samples carry to the outputs
MODEL_TOL = {False: 1e-4, True: 3e-2}


@pytest.mark.parametrize('case', sorted(MODEL_CASES))
def test_model_eval_modes_match_jax(case):
    """vali on 64 rays, test on 64 rays in chunks of 24 (the last padded)."""
    jmodel, jparams, tmodel = model_pair(case)
    jmodel.eval_ray_chunk = tmodel.eval_ray_chunk = 24
    params = tckpt.params_from_jax(jparams)
    batch = ray_batch(64, seed=16)
    for mode in ('vali', 'test'):
        _, _, _, want = jmodel.apply(
            jparams, {k: jnp.asarray(v) for k, v in batch.items()}, mode=mode)
        with torch.no_grad():
            _, _, kwargs, got = tmodel.apply(
                params, {k: t(v) for k, v in batch.items()}, mode=mode)
        assert kwargs == {}
        assert_vis_close(got, want, MODEL_TOL[MODEL_CASES[case][1]])


# Train loss and gradients: f32 summation order (per-leaf relative norm
# 1e-4); bf16 as tests/test_torch_train.py's bf16 chains
GRAD_TOL = {False: (1e-5, 1e-4), True: (1e-2, 5e-2)}


@pytest.mark.parametrize('case', sorted(MODEL_CASES))
def test_model_train_loss_and_grads_match_jax(case):
    """Train mode with perturbed samples and sigma noise, the JAX model's
    draws replayed into the port's."""
    jmodel, jparams, tmodel = model_pair(case, noise_std=0.5)
    batch = ray_batch(64, seed=17)
    key = jax.random.PRNGKey(18)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(p):
        pred, gt, kw, to_vis = jmodel.apply(p, jbatch, mode='train', key=key)
        return jnp.mean(jmodel.compute_loss(p, pred, gt, **kw)), to_vis
    (want_loss, want_vis), want = jax.value_and_grad(
        loss_fn, has_aux=True)(jparams)
    params = tckpt.tree_map(lambda x: x.requires_grad_(),
                            tckpt.params_from_jax(jparams))
    pred, gt, kw, got_vis = tmodel.apply(
        params, {k: t(v) for k, v in batch.items()}, mode='train',
        **jax_draws(tmodel, key, 64))
    loss = torch.mean(tmodel.compute_loss(params, pred, gt, **kw))
    got = torch.autograd.grad(loss, tckpt.tree_leaves(params))
    bf16 = MODEL_CASES[case][1]
    loss_tol, grad_tol = GRAD_TOL[bf16]
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=loss_tol)
    assert_vis_close(got_vis, want_vis, MODEL_TOL[bf16])
    want_leaves = jax.tree_util.tree_leaves(want)
    assert len(got) == len(want_leaves)
    for i, (g, w) in enumerate(zip(got, want_leaves)):
        assert rel_norm(g, w) <= grad_tol, (i, rel_norm(g, w))


def test_model_train_draws_from_generator():
    """Without explicit draws, train mode draws from the generator: the
    same seed gives the same loss, another seed another; none raises."""
    _, jparams, tmodel = model_pair('fused_f32', noise_std=0.5)
    params = tckpt.params_from_jax(jparams)
    batch = {k: t(v) for k, v in ray_batch(16, seed=19).items()}

    def loss(seed):
        g = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            pred, gt, kw, _ = tmodel.apply(params, batch, generator=g)
            return tmodel.compute_loss(params, pred, gt, **kw)
    assert torch.equal(loss(0), loss(0))
    assert not torch.equal(loss(0), loss(1))
    with pytest.raises(ValueError, match='generator'):
        tmodel.apply(params, batch)
    with pytest.raises(ValueError, match='jitter'):
        tmodel.apply(params, batch, jitter_noise=torch.zeros(16, 3))


# ------ checkpoints and CLIs ------

@pytest.fixture(scope='module')
def scene(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('tnerf_data'))
    synth.make_scene(root, n_train=3, n_vali=1, n_test=3, imh=IMH)
    return {'root': root, 'out': str(tmp_path_factory.mktemp('tnerf_out'))}


def cli_override(scene, outroot, extra):
    return ','.join([MODEL_BASE, 'data_root=' + scene['root'],
                     'outroot=' + outroot, 'near=2', 'far=6', extra])


def test_weight_bridge_round_trips(scene):
    """A JAX-written NeRF checkpoint restores in the port into identical
    tensors, and the port's restores in the JAX package."""
    jmodel, jparams, tmodel = model_pair('fused_f32')
    path = join(scene['out'], 'bridge', 'checkpoints', 'ckpt-2')
    jckpt.save_pytree({'params': jparams}, path)
    got = tckpt.restore_trained_params(
        path, tmodel.init_params(torch.Generator()))
    assert sorted(got) == sorted(jparams) == [
        '%s_%s' % (lv, n) for lv in ('coarse', 'fine')
        for n in ('bottleneck', 'enc', 'rgb_out', 'sigma_out')]
    want = jax.tree_util.tree_leaves(jparams)
    for g, w in zip(tckpt.tree_leaves(got), want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    back_path = join(scene['out'], 'bridge', 'port', 'ckpt-1')
    tckpt.save_pytree({'params': got}, back_path)
    back = jckpt.restore_trained_params(back_path, jparams, None)
    for g, w in zip(jax.tree_util.tree_leaves(back), want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_cli_resumes_jax_checkpoint_like_jax(scene):
    """Both CLIs resume from one JAX-written ckpt-1 (params + optimizer
    state) on nerf.ini without perturbation or sigma noise, in f32, and
    train epochs 2-3 (6 steps) on the same rays. Their ckpt-3 params agree
    to 1e-4; the port's ckpt-3 restores in the JAX package; its vali
    writes the images, flipbooks, metadata and HTML."""
    extra = ('perturb=False,noise_std=0,bf16_big_chains=False,lr=5e-3,'
             'ckpt_period=1,vali_period=3,vali_batches=1')

    def run(pkg, outroot, epochs, *args):
        pkg.main(['--config', 'nerf.ini', '--config_override',
                  cli_override(scene, outroot, extra) + ',epochs=%d' % epochs,
                  *args])
        return join(outroot, 'lr5e-3')

    jroot, troot = join(scene['out'], 'cli_jax'), join(scene['out'], 'cli_port')
    jdir = run(jtrainvali, jroot, 1)
    shutil.copytree(jdir, join(troot, 'lr5e-3'))
    shutil.copy(jdir + '.ini', join(troot, 'lr5e-3.ini'))
    run(jtrainvali, jroot, 3)
    tdir = run(ttrainvali, troot, 3, '--device', 'cpu')
    jleaves = tckpt.read_leaves(join(jdir, 'checkpoints', 'ckpt-3'))
    tleaves = tckpt.read_leaves(join(tdir, 'checkpoints', 'ckpt-3'))
    assert [a.shape for a in jleaves] == [a.shape for a in tleaves]
    assert int(tleaves[0]) == int(jleaves[0]) == 9  # optimizer steps
    config = configutil.Config(configutil.read_config(tdir + '.ini'))
    jmodel = JModel(config)
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    n_params = len(jax.tree_util.tree_leaves(jparams))
    for g, w in zip(tleaves[-n_params:], jleaves[-n_params:]):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)
    from nerfactor_tpu.parallel import train as jtrain
    template = {'params': jparams,
                'opt_state': jtrain.build_optimizer(config).init(jparams)}
    back = jckpt.CheckpointManager(join(tdir, 'checkpoints')).restore(
        template)
    for g, w in zip(jax.tree_util.tree_leaves(back), tleaves):
        np.testing.assert_array_equal(np.asarray(g), w)
    vali = join(tdir, 'vis_vali', 'epoch000000003')
    for f in ('all.html', 'batch000000000/fine_rgb.png',
              'batch000000000/fine-vs-gt_rgb.apng',
              'batch000000000/fine-vs-coarse_depth.apng'):
        assert exists(join(vali, f)), f
    meta = tio.read_json(join(vali, 'batch000000000', 'metadata.json'))
    assert meta['id'] == 'val_000' and np.isfinite(meta['psnr'])
    with open(join(tdir, 'summary_train', 'scalars.jsonl')) as f:
        assert [json.loads(line)['step'] for line in f] == [1, 2, 3]


def test_nerf_test_cli_matches_jax(scene):
    """The port's nerf_test on the CPU writes every view's images and
    metadata.json; its fine render is the JAX package's within 1/255."""
    outroot = join(scene['out'], 'test_cli')
    ttrainvali.main(['--config', 'nerf.ini', '--device', 'cpu',
                     '--config_override', cli_override(
                         scene, outroot, 'bf16_big_chains=False,epochs=1,'
                         'ckpt_period=1,vali_period=0')])
    ckpt = join(outroot, 'lr1e-4', 'checkpoints', 'ckpt-1')
    run = tnerf_test.main(['--ckpt', ckpt, '--device', 'cpu'])
    assert len(run['view_seconds']) == 3
    got = join(run['outroot'], 'batch000000002')
    assert tio.read_json(join(got, 'metadata.json')) == {'id': 'test_002'}
    img = tio.load_img(join(got, 'fine_rgb.png'))
    assert img.shape[:2] == (IMH, IMH)
    jnerf_test.main(['--ckpt', ckpt])  # writes over the same directory
    want = tio.load_img(join(got, 'fine_rgb.png'))
    np.testing.assert_allclose(img, want, atol=1 / 255 + 1e-6)
