"""The PyTorch port's geometry distillation vs the JAX package (CPU).

At small widths (trunk 32 x 4 with the skip after layer 2, 8 + 16 samples,
so 72 + 80 for distillation, light_h 2) and on the same inputs, made with
numpy from a seed:

  * NeRF's ``eval_sigma`` with ``fused_mlp`` on and off, with and without
    views, f32 and bf16 (the JAX fused path off the TPU is its plain
    chain), and the fused f32 sigma and its point gradient against the
    JAX Pallas kernel in interpret mode;
  * the depth/normal block and the visibility block, with and without
    ``--scene_bbox``, the visibility march in f32 and bf16;
  * both CLIs on one JAX-written NeRF checkpoint (every buffer of every
    view), ``--view_shard``, ``--spp`` rays and ``average_supersamples``;
  * the two deviations from the JAX package: no rays or no hit points give
    empty outputs, and ``AsyncWriter.close`` raises after its worker died
    of a BaseException;
  * the march probe's CPU check.

The weights are the JAX model's seeded init with the sigma head's bias at
SIGMA_BIAS: with the init's zero bias nearly every ray of the scene ends
opaque (occupancy 0.85-1.00006), at -1 a view's occupancies spread over
0.01-1, so ``--occu_thres`` 0.25 leaves both hit and empty pixels.
"""

import os
from os.path import join

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfactor_tpu import geometry_from_nerf as jgeo
from nerfactor_tpu.datasets.nerf import Dataset as JDataset
from nerfactor_tpu.models.nerf import Model as JModel
from nerfactor_tpu.ops import pallas_mlp as pm
from nerfactor_tpu.utils import ckpt as jckpt, config as configutil
from nerfactor_tpu_torch import geometry_from_nerf as tgeo
from nerfactor_tpu_torch.datasets.nerf import Dataset as TDataset
from nerfactor_tpu_torch.models.nerf import Model as TModel
from nerfactor_tpu_torch.tools import march_probe
from nerfactor_tpu_torch.utils import ckpt as tckpt, io as tio
from tests import synth
from tools.diff_surf_buffers import diff_view

IMH = 8
# As tests/test_torch_nerf.py: 4 xyz octaves, since posenc carries an ulp
# of an importance-sampled depth (the two packages sum the CDF in another
# order) up 2^(octaves - 1)-fold
MODEL_BASE = ('imh=%d,mlp_width=32,enc_depth=4,n_samples_coarse=8,'
              'n_samples_fine=16,n_rays_per_step=64,n_freqs_xyz=4,'
              'n_freqs_view=2,near=2,far=6' % IMH)
SIGMA_BIAS = -1.0
GEO_FLAGS = ['--light_h', '2', '--lvis_far', '2', '--mlp_chunk', '16384']
# A box that cuts the march's points in two (it holds about half of them)
BBOX = '-0.3,1,-1,1,-1,0.5'


def t(x):
    return torch.from_numpy(np.array(x, np.float32))


def rel_norm(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def nerf_config(extra=''):
    parser = configutil.read_config(configutil.resolve_config_path(
        'nerf.ini'))
    configutil.apply_override(parser, ','.join(
        [MODEL_BASE] + ([extra] if extra else [])))
    return configutil.Config(parser)


def seeded_params(jmodel, seed=0, sigma_bias=SIGMA_BIAS):
    """The JAX model's init with the sigma column's bias at
    ``sigma_bias``."""
    params = jmodel.init_params(jax.random.PRNGKey(seed))
    head = 'sigma_out' if jmodel.use_views else 'rgbs_out'
    for level in ('coarse', 'fine'):
        layer = params['%s_%s' % (level, head)][-1]
        layer['b'] = layer['b'].at[-1].set(sigma_bias)
    return params


def distiller_pair(extra_flags=(), config_extra=''):
    config = nerf_config(config_extra)
    jmodel = JModel(config)
    jparams = seeded_params(jmodel)
    tmodel = TModel(config, device='cpu')
    flags = ['--trained_nerf', 'unused', '--out_root', 'unused'] + GEO_FLAGS \
        + list(extra_flags)
    jd = jgeo.GeometryDistiller(jmodel, jparams, config,
                                jgeo.parse_args(flags))
    td = tgeo.GeometryDistiller(tmodel, tckpt.params_from_jax(jparams), config,
                                tgeo.parse_args(flags + ['--device', 'cpu']))
    return jd, td


def view_rays(view=0):
    """A view's rays from the ring of cameras at distance 4, unit
    directions, (IMH * IMH, 3) f32."""
    rayo, rayd = synth.gen_rays(synth.ring_cameras(3)[view], IMH, IMH)
    rayd = rayd / np.linalg.norm(rayd, axis=-1, keepdims=True)
    return (rayo.reshape(-1, 3).astype(np.float32),
            rayd.reshape(-1, 3).astype(np.float32))


def surface_points(n=12, seed=0):
    """Points on a sphere of radius 0.8 with outward normals, (n, 3) f32."""
    nrm = np.random.RandomState(seed).randn(n, 3)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    return (0.8 * nrm).astype(np.float32), nrm.astype(np.float32)


# ------ eval_sigma ------

# name -> (config override, fused, bf16)
SIGMA_CASES = {
    'fused_f32': ('', False), 'fused_bf16': ('', True),
    'unfused_f32': ('fused_mlp=False', False),
    'unfused_bf16': ('fused_mlp=False', True),
    'no_views_fused_f32': ('use_views=False', False),
    'no_views_fused_bf16': ('use_views=False', True),
    'no_views_unfused_f32': ('use_views=False,fused_mlp=False', False),
    'no_views_unfused_bf16': ('use_views=False,fused_mlp=False', True),
}
# |port - JAX| <= tol + tol * |JAX|. f32: summation order (readings <= 3.6e-7
# of 1 + |sigma|). bf16: both packages cast the embedding, weights and each
# pre-activation to bf16; the unfused JAX spec also rounds the product
# before the bias add, one bf16 ulp a layer (readings: fused 0, unfused
# <= 5.2e-3 of 1 + |sigma|)
SIGMA_TOL = {False: 1e-5, True: 2e-2}


@pytest.mark.parametrize('case', sorted(SIGMA_CASES))
def test_eval_sigma_matches_jax(case):
    override, bf16 = SIGMA_CASES[case]
    config = nerf_config(override)
    jmodel = JModel(config)
    jparams = seeded_params(jmodel, seed=1)
    tmodel = TModel(config, device='cpu')
    assert tuple(tmodel.sigma_plan) == tuple(jmodel.sigma_plan)
    pts = np.random.RandomState(2).uniform(-1.5, 1.5, (200, 3)).astype(
        np.float32)
    jd, td = (jnp.bfloat16, torch.bfloat16) if bf16 else (None, None)
    for use_fine in (False, True):
        want = jmodel.eval_sigma(jparams, jnp.asarray(pts), use_fine=use_fine,
                                 compute_dtype=jd)
        got = tmodel.eval_sigma(tckpt.params_from_jax(jparams), t(pts),
                                use_fine=use_fine, compute_dtype=td)
        assert got.shape == (200, 1) and got.dtype == torch.float32
        tol = SIGMA_TOL[bf16]
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                                   atol=tol)


def test_eval_sigma_and_its_gradient_match_pallas_kernel():
    """The fused f32 sigma and d sum(relu(sigma)) / d pts (the normal
    pass's gradient) against the JAX Pallas kernel in interpret mode,
    whose backward runs with needs_dw=False. The kernel's double-angle
    trig errs ~2^f ulp at octave f: bounds as tests/test_torch_nerf.py's
    for the kernel, 2e-4 and 1e-4 relative norm (readings 3.6e-7 max abs,
    2.7e-7)."""
    config = nerf_config()
    jmodel = JModel(config)
    # A sigma bias of +1: sigma > 0 at most points, so the ReLU passes
    # most gradients
    jparams = seeded_params(jmodel, seed=3, sigma_bias=1.0)
    tmodel = TModel(config, device='cpu')
    pts = np.random.RandomState(4).uniform(-1.5, 1.5, (130, 3)).astype(
        np.float32)

    def sigma_sum(p):
        s = jax.nn.relu(jmodel.eval_sigma(jparams, p, use_fine=True))
        return jnp.sum(s), s
    pm.INTERPRET = True
    try:
        want_grad, want = jax.grad(sigma_sum, has_aux=True)(jnp.asarray(pts))
    finally:
        pm.INTERPRET = False
    x = t(pts).requires_grad_()
    got = torch.relu(tmodel.eval_sigma(tckpt.params_from_jax(jparams), x,
                                       use_fine=True))
    got_grad, = torch.autograd.grad(got.sum(), x)
    assert (got > 0).float().mean() > 0.5
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=2e-4, atol=2e-4)
    assert rel_norm(got_grad, want_grad) <= 1e-4


# ------ the two blocks ------

@pytest.mark.parametrize('bbox', [None, BBOX], ids=['no_bbox', 'bbox'])
def test_depth_normal_block_matches_jax(bbox):
    """f32: occupancy and depth within 1e-5 (+ 1e-5 relative), normals
    within 1e-4 relative norm (readings without the bbox 3.5e-6 and 2.0e-5
    abs at depths 2-6, 1.8e-6; with it 1.6e-7, 5.4e-7, 1.2e-6)."""
    jd, td = distiller_pair(['--scene_bbox=' + bbox] if bbox else [])
    rayo, rayd = view_rays()
    want = jax.jit(jd._depth_normal_block_fn)(jnp.asarray(rayo),
                                              jnp.asarray(rayd))
    got = td.depth_normal_block(t(rayo), t(rayd))
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)
    assert rel_norm(got[2], want[2]) <= 1e-4
    occu = got[0].numpy()
    assert occu.min() < 0.25 < occu.max()


@pytest.mark.parametrize('bbox', [None, BBOX], ids=['no_bbox', 'bbox'])
@pytest.mark.parametrize('march', ['f32', 'bf16'])
def test_lvis_block_matches_jax(march, bbox):
    """f32 within 1e-5 (readings <= 2.5e-6); bf16 within the JAX suite's
    own bf16-vs-f32 drift bounds, mean < 0.02 and p99 < 0.2
    (tests/test_geometry_from_nerf.py; readings mean 1.9e-7, p99 2.2e-6:
    both packages run the plain bf16 chain here)."""
    flags = ['--bf16_march' if march == 'bf16' else '--no-bf16_march']
    if bbox:
        flags.append('--scene_bbox=' + bbox)
    jd, td = distiller_pair(flags)
    surf, nrm = surface_points()
    want = np.asarray(jax.jit(jd._lvis_block_fn)(jnp.asarray(surf),
                                                 jnp.asarray(nrm)))
    got, = td.lvis_block(t(surf), t(nrm))
    got = got.numpy()
    assert got.shape == (12, td.n_lights)
    if march == 'f32':
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    else:
        diff = np.abs(got - want)
        assert diff.mean() < 0.02 and np.quantile(diff, 0.99) < 0.2
    assert 0 < (got > 0).mean() < 1
    if bbox:
        td.bbox = None
        assert np.abs(td.lvis_block(t(surf), t(nrm))[0].numpy()
                      - got).max() > 0.1


# ------ both CLIs on one JAX-written checkpoint ------

@pytest.fixture(scope='module')
def distilled(tmp_path_factory):
    """A 4-view scene, a JAX-written NeRF ckpt-1 with seeded weights, and
    both CLIs' buffers from it (every view, default flags: bf16 march)."""
    root = str(tmp_path_factory.mktemp('geom_data'))
    out = str(tmp_path_factory.mktemp('geom_out'))
    synth.make_scene(root, n_train=2, n_vali=1, n_test=1, imh=IMH)
    config = nerf_config('data_root=' + root)
    trained = join(out, 'nerf', 'lr1e-4')
    configutil.write_config(config.parser, trained + '.ini')
    jckpt.save_pytree({'params': seeded_params(JModel(config))},
                      join(trained, 'checkpoints', 'ckpt-1'))
    flags = ['--trained_nerf', trained, '--occu_thres', '0.25'] + GEO_FLAGS
    jgeo.main(flags + ['--out_root', join(out, 'jax')])
    run = tgeo.main(flags + ['--out_root', join(out, 'port'),
                             '--device', 'cpu'])
    return {'out': out, 'flags': flags, 'run': run}


VIEWS = ['test_000', 'train_000', 'train_001', 'val_000']


def load_buffers(d):
    return {'alpha': tio.load_img(join(d, 'alpha.png')),
            **{k: np.load(join(d, k + '.npy'))
               for k in ('xyz', 'normal', 'lvis')}}


def test_cli_buffers_match_jax(distilled):
    """Every view: the same files; alpha.png within 1/255; xyz and normal
    within 1e-4 abs (readings <= 1.1e-5 and <= 4.8e-6); lvis (the bf16
    march) within 1e-3 abs (readings <= 2.2e-4: a bf16 rounding that flips
    between the packages moves one march's sigma by a bf16 step). Each
    view has hit and empty pixels (37-63 % hit)."""
    out = distilled['out']
    assert sorted(os.listdir(join(out, 'jax'))) == VIEWS
    assert sorted(os.listdir(join(out, 'port'))) == VIEWS
    assert [r['id'] for r in distilled['run']['views']] == [
        'train_000', 'train_001', 'val_000', 'test_000']
    for view in VIEWS:
        jdir, tdir = join(out, 'jax', view), join(out, 'port', view)
        assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir))
        want, got = load_buffers(jdir), load_buffers(tdir)
        assert got['lvis'].shape == (IMH, IMH, 8)
        hit = got['alpha'] > 0
        assert hit.any() and not hit.all(), view
        np.testing.assert_allclose(got['alpha'], want['alpha'], rtol=0,
                                   atol=1 / 255 + 1e-6)
        for k, tol in (('xyz', 1e-4), ('normal', 1e-4), ('lvis', 1e-3)):
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=tol,
                                       err_msg='%s/%s' % (view, k))
        stats = diff_view(want, got)
        assert stats['alpha_iou'] == 1.0 and stats['xyz_rms'] < 1e-4


def test_view_shards_partition_and_match_unsharded(distilled):
    """--view_shard 0/2 and 1/2, one after the other in this process into
    one directory: they split the views between them, and every buffer is
    the unsharded run's bit for bit."""
    out = distilled['out']
    shard_root = join(out, 'sharded')
    runs = [tgeo.main(distilled['flags'] + [
        '--out_root', shard_root, '--device', 'cpu', '--view_shard',
        '%d/2' % i]) for i in range(2)]
    ids = [[r['id'] for r in run['views']] for run in runs]
    assert not set(ids[0]) & set(ids[1])
    assert sorted(ids[0] + ids[1]) == VIEWS
    assert ids[0] == ['train_000', 'val_000']
    for view in VIEWS:
        for f in ('xyz.npy', 'normal.npy', 'lvis.npy', 'alpha.png'):
            with open(join(shard_root, view, f), 'rb') as a, \
                    open(join(out, 'port', view, f), 'rb') as b:
                assert a.read() == b.read(), (view, f)
    # A finished view is skipped on a rerun
    assert tgeo.main(distilled['flags'] + [
        '--out_root', shard_root, '--device', 'cpu'])['views'] == []


# ------ supersampling ------

@pytest.mark.parametrize('mode', ['train', 'test'])
def test_spp_rays_match_jax(tmp_path, mode):
    """spp=4: 2 x 2 rays a pixel in every mode, as the JAX dataset casts
    them (always_all_rays in train mode)."""
    root = str(tmp_path)
    synth.make_scene(root, n_train=1, n_vali=0, n_test=1, imh=IMH)
    config = nerf_config('data_root=' + root)
    batches = [next(iter(D(config, mode, always_all_rays=True, spp=4)
                         .build_pipeline(no_shuffle=True, prefetch=0)))
               for D in (JDataset, TDataset)]
    want, got = batches
    assert got['rayo'].shape == (4 * IMH * IMH, 3)
    assert tuple(got['hw']) == tuple(want['hw']) == (IMH, IMH)
    for k in ('rayo', 'rayd', 'rgb'):
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
    with pytest.raises(ValueError, match='square'):
        TDataset(config, mode, spp=3)


def test_average_supersamples_matches_jax():
    rng = np.random.RandomState(5)
    for sps, shape in ((1, (6, 6)), (2, (8, 12, 3)), (3, (9, 6))):
        x = rng.rand(*shape).astype(np.float32)
        np.testing.assert_array_equal(tgeo.average_supersamples(x, sps),
                                      jgeo.average_supersamples(x, sps))


# ------ the deviations ------

def test_no_rays_or_hits_give_empty_outputs():
    """n == 0 (a view with no ray, or no hit pixel) gives empty outputs of
    the right shapes; the JAX package's _super_mapped builds its block
    from a[-1:], which is empty then (ADVICE, geometry_from_nerf.py:191)."""
    _, td = distiller_pair()
    none = np.zeros((0, 3), np.float32)
    occu, depth, normal = td.compute_depth_and_normal(none, none)
    assert (occu.shape, depth.shape, normal.shape) == ((0,), (0,), (0, 3))
    lvis = td.compute_light_visibility(none, none)
    assert lvis.shape == (0, td.n_lights) and lvis.dtype == np.float32


@pytest.mark.filterwarnings(
    'ignore::pytest.PytestUnhandledThreadExceptionWarning')
def test_async_writer_close_raises_after_worker_died():
    """A BaseException in a write kills the worker without an error on
    record: the port's close() raises, the JAX package's returns silently
    (ADVICE, geometry_from_nerf.py:384). An Exception is re-raised by both."""
    def die():
        raise SystemExit(3)

    def fail():
        raise OSError("disk full")
    for Writer, raises in ((tgeo.AsyncWriter, True),
                           (jgeo.AsyncWriter, False)):
        writer = Writer()
        writer.submit(die)
        if raises:
            with pytest.raises(RuntimeError, match='died'):
                writer.close()
        else:
            assert writer.close() is None
        writer = Writer()
        writer.submit(fail)
        with pytest.raises(OSError, match='disk full'):
            writer.close()
    writer = tgeo.AsyncWriter()
    done = []
    writer.submit(lambda: done.append(1))
    writer.close()
    assert done == [1]


# ------ the probe ------

def test_march_probe_runs_on_cpu():
    """The probe's two stages at nerf.ini's width on a few points, rays and
    lights, through the plain versions: a check of the tool."""
    records = march_probe.main(['--device', 'cpu', '--n_surf', '3',
                                '--light_h', '1', '--n_rays', '6'])
    assert [r['stage'] for r in records] == ['lvis_march_torch',
                                            'depth_normal_torch']
    assert records[0]['unit'] == 's/4096pts_x_2dirs'
    for r in records:
        assert np.isfinite(r['value']) and r['value'] > 0
        assert r['profile'] is None and r['blocks'] == 1
        assert r['config'].startswith('256 wide x 8, 128 + 192 samples')
