"""The PyTorch port's inference slice vs the JAX package (CPU).

On a synthetic sphere scene (tests/synth.py, imh 8, light_h 4, width-16
MLPs) with BRDF, shape and joint checkpoints written by the JAX package:

  * the weight bridge: a JAX checkpoint restores into identical tensors,
    and a port checkpoint restores in the JAX package;
  * the test-mode forward (OLAT and probe relights on) against the JAX
    model's, for every ``pred_*`` output, in f32 and with the shipped
    bf16 big chains;
  * the port's CLI in a subprocess where ``jax``, ``imageio``, ``PIL``
    and ``nerfactor_tpu`` cannot be imported, against the JAX model's
    ``vis_batch`` on the JAX outputs: same files, pixels within 1/255.
"""

import os
import shutil
import subprocess
import sys
from os.path import dirname, join

import imageio.v2 as imageio
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfactor_tpu import test as jtest
from nerfactor_tpu.datasets.nerf_shape import Dataset as JDataset
from nerfactor_tpu.models.brdf import Model as JBRDFModel
from nerfactor_tpu.models.nerfactor import Model as JModel
from nerfactor_tpu.models.shape import Model as JShapeModel
from nerfactor_tpu.utils import ckpt as jckpt, config as configutil
from nerfactor_tpu_torch import test as ttest
from nerfactor_tpu_torch.models.nerfactor import Model as TModel
from nerfactor_tpu_torch.utils import ckpt as tckpt
from tests import synth

REPO = dirname(dirname(os.path.abspath(__file__)))
IMH, LIGHT_H = 8, 4


def _experiment(outdir, base_ini, overrides):
    parser = configutil.read_config(configutil.resolve_config_path(base_ini))
    configutil.apply_override(parser, overrides)
    configutil.write_config(parser, outdir + '.ini')
    return configutil.Config(parser)


def build_scene(tmp_path_factory, n_train=1):
    """Sphere scene, .npy probes, and BRDF + shape experiments written
    by the JAX package."""
    root = str(tmp_path_factory.mktemp('tnf_data'))
    out = str(tmp_path_factory.mktemp('tnf_out'))
    synth.make_scene(root, n_train=n_train, n_vali=1, n_test=3, imh=IMH,
                     with_buffers=True, light_h=LIGHT_H)
    probe_dir = join(root, 'envmaps')
    os.makedirs(probe_dir)
    rng = np.random.RandomState(0)
    for name in ('courtyard', 'sunset'):
        np.save(join(probe_dir, name + '.npy'),
                rng.rand(LIGHT_H, 2 * LIGHT_H, 3).astype(np.float32))
    brdf_data = join(root, 'brdf_npz')
    os.makedirs(brdf_data)
    for mat in ('alum-bronze', 'pearl-paint', 'red-plastic'):
        np.savez(join(brdf_data, 'train_%s.npz' % mat),
                 rusink=np.zeros((4, 3), np.float32),
                 refl=np.ones((4, 1), np.float32))
    brdf_out = join(out, 'merl', 'lr1e-2')
    cb = _experiment(brdf_out, 'brdf.ini', 'data_root=%s,mlp_width=16,'
                     'mlp_depth=2,mlp_skip_at=1' % brdf_data)
    brdf_params = JBRDFModel(cb).init_params(jax.random.PRNGKey(1))
    brdf_params['latent_code'] = brdf_params['latent_code'] * 50  # spread
    jckpt.save_pytree({'params': brdf_params},
                      join(brdf_out, 'checkpoints', 'ckpt-50'))
    shape_out = join(out, 'shape', 'lr1e-2')
    cs = _experiment(shape_out, 'shape.ini', 'imh=%d,light_h=%d,'
                     'mlp_width=16,mlp_depth=2,mlp_skip_at=1' % (IMH, LIGHT_H))
    jckpt.save_pytree(
        {'params': JShapeModel(cs).init_params(jax.random.PRNGKey(2))},
        join(shape_out, 'checkpoints', 'ckpt-2'))
    return {'root': root, 'out': out, 'probe_dir': probe_dir,
            'brdf_ckpt': join(brdf_out, 'checkpoints', 'ckpt-50'),
            'shape_ckpt': join(shape_out, 'checkpoints', 'ckpt-2')}


@pytest.fixture(scope='module')
def scene(tmp_path_factory):
    return build_scene(tmp_path_factory)


def joint_override(scene, name, extra=''):
    """--config_override of a joint experiment on the shipped
    nerfactor.ini at test width; mlp_chunk is large enough that the JAX
    side evaluates one chunk."""
    return ','.join([
        'data_root=%s' % scene['root'],
        'data_nerf_root=%s' % join(scene['root'], 'surf'),
        'outroot=%s' % join(scene['out'], name),
        'brdf_model_ckpt=%s' % scene['brdf_ckpt'],
        'shape_model_ckpt=%s' % scene['shape_ckpt'],
        'test_envmap_dir=%s' % scene['probe_dir'],
        'imh=%d' % IMH, 'light_h=%d' % LIGHT_H, 'mlp_width=16',
        'mlp_depth=2', 'mlp_skip_at=1', 'mlp_chunk=8192'] + (
            [extra] if extra else []))


def make_joint(scene, name, extra=''):
    """A joint experiment (see :func:`joint_override`) with a JAX-written
    ckpt-4. Returns (ckpt path, config, JAX model, JAX params)."""
    outdir = join(scene['out'], name, 'run')
    config = _experiment(outdir, 'nerfactor.ini',
                         joint_override(scene, name, extra))
    model = JModel(config)
    params = model.init_params(jax.random.PRNGKey(3))
    ckpt = join(outdir, 'checkpoints', 'ckpt-4')
    jckpt.save_pytree({'params': params}, ckpt)
    return ckpt, config, model, params


def test_weight_bridge_round_trips(scene):
    ckpt, config, _, jparams = make_joint(scene, 'bridge')
    model = TModel(config, device='cpu')
    got = tckpt.restore_trained_params(
        ckpt, model.init_params(torch.Generator().manual_seed(0)))
    want = tckpt.params_from_jax(jparams)
    assert sorted(got) == sorted(want) == sorted(jparams)
    got_l, want_l = tckpt.tree_leaves(got), tckpt.tree_leaves(want)
    assert len(got_l) == len(jax.tree_util.tree_leaves(jparams))
    for g, w in zip(got_l, want_l):
        assert g.shape == w.shape and torch.equal(g, w)
    # And back: a port checkpoint restores in the JAX package
    path = join(scene['out'], 'bridge', 'port', 'checkpoints', 'ckpt-1')
    tckpt.save_pytree({'params': got}, path)
    back = jckpt.restore_trained_params(path, jparams, config)
    for g, w in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(tckpt.params_to_jax(want))):
        np.testing.assert_array_equal(np.asarray(g), w)


def _last_view(config):
    return list(JDataset(config, 'test').build_pipeline(
        no_shuffle=True, prefetch=0))[-1]


# f32 chains, the shipped bf16 big chains, and f32 with albedo edits
# (color-correction scales and a solid override)
CASES = {
    'f32': ('bf16_big_chains=False', {}),
    'bf16': ('', {}),
    'f32_edits': ('bf16_big_chains=False', {
        'albedo_scales': np.asarray([0.9, 1.1, 1.0], np.float32),
        'albedo_override': np.asarray([[1.0, 0.843, 0.0]], np.float32)}),
}


@pytest.mark.parametrize('case', sorted(CASES))
def test_forward_matches_jax(scene, case):
    extra, kwargs = CASES[case]
    ckpt, config, jmodel, jparams = make_joint(scene, 'fwd_' + case, extra)
    batch = _last_view(config)
    arrays = {k: np.asarray(batch[k], np.float32)
              for k in JDataset.array_keys}
    _, _, _, want = jmodel.apply(
        jparams, {k: jnp.asarray(v) for k, v in arrays.items()},
        mode='test', relight_olat=True, relight_probes=True, **kwargs)
    tmodel = TModel(config, device='cpu')
    tparams = tckpt.params_from_jax(jparams)
    with torch.no_grad():
        _, _, _, got = tmodel.apply(
            tparams, {k: torch.from_numpy(v) for k, v in arrays.items()},
            mode='test', relight_olat=True, relight_probes=True, **kwargs)
    assert sorted(got) == sorted(want)
    bf16 = case == 'bf16'
    for k in want:
        assert tuple(got[k].shape) == tuple(want[k].shape), k
        # Outputs downstream of a bf16 chain carry its tolerance
        tol = 1e-2 if bf16 and k.startswith(('pred_rgb', 'pred_lvis')) \
            else 1e-5
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=tol, atol=tol, err_msg=k)


def test_forward_is_chunk_invariant(scene):
    """The port walks ray chunks in a loop (the last one short); the
    result must not depend on the chunk size."""
    _, config, _, jparams = make_joint(scene, 'chunks',
                                       'bf16_big_chains=False')
    batch = _last_view(config)
    arrays = {k: torch.as_tensor(np.asarray(batch[k], np.float32))
              for k in JDataset.array_keys}
    model = TModel(config, device='cpu')
    params = tckpt.params_from_jax(jparams)
    outs = []
    for chunk in (model.eval_ray_chunk, 7):
        model.eval_ray_chunk = chunk
        with torch.no_grad():
            outs.append(model.apply(params, arrays, mode='test',
                                    relight_olat=True,
                                    relight_probes=True)[3])
    for k in outs[0]:
        np.testing.assert_allclose(outs[1][k].numpy(), outs[0][k].numpy(),
                                   rtol=1e-6, atol=1e-6, err_msg=k)


def test_per_ray_albedo_edit_spans_chunks(scene):
    """A spatially varying albedo edit (one row per ray) is chunked with
    the rays. (The JAX package closes over the whole (N, 3) edit and
    cannot broadcast it to a chunk once a view spans several chunks.)"""
    _, config, _, jparams = make_joint(scene, 'edit_chunks',
                                       'bf16_big_chains=False')
    batch = _last_view(config)
    arrays = {k: torch.as_tensor(np.asarray(batch[k], np.float32))
              for k in JDataset.array_keys}
    model = TModel(config, device='cpu')
    model.eval_ray_chunk = 16
    edit = np.random.RandomState(6).rand(IMH * IMH, 3).astype(np.float32)
    with torch.no_grad():
        pred = model.apply(tckpt.params_from_jax(jparams), arrays,
                           mode='test', albedo_override=edit)[0]
    np.testing.assert_array_equal(pred['albedo'].numpy(), edit)


def _jax_vis(config, jmodel, jparams, outroot):
    """What nerfactor_tpu/test.py writes per view (minus the video)."""
    ds = JDataset(config, 'test')
    n = ds.get_n_views()
    for i, batch in enumerate(ds.build_pipeline(no_shuffle=True,
                                                prefetch=0)):
        arrays = {k: jnp.asarray(np.asarray(batch[k], np.float32))
                  for k in ds.array_keys}
        _, _, _, to_vis = jmodel.apply(jparams, arrays, mode='test',
                                       relight_olat=i == n - 1,
                                       relight_probes=True)
        to_vis = {k: np.asarray(v) for k, v in to_vis.items()}
        to_vis.update({k: v for k, v in batch.items()
                       if k not in ds.array_keys})
        jmodel.vis_batch(to_vis, join(outroot, 'batch%09d' % i),
                         mode='test', olat_vis=i == n - 1)


def _files(root):
    return sorted(os.path.relpath(join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def test_cli_without_jax_matches_jax_vis(scene):
    ckpt, config, jmodel, jparams = make_joint(scene, 'cli',
                                               'bf16_big_chains=False')
    code = ("import sys\n"
            "for m in ('jax', 'jaxlib', 'imageio', 'PIL', 'nerfactor_tpu'):\n"
            "    sys.modules[m] = None\n"
            "from nerfactor_tpu_torch import test\n"
            "test.main(sys.argv[1:])\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, '-c', code, '--ckpt', ckpt, '--device', 'cpu'],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    port_root = join(dirname(dirname(ckpt)), 'vis_test', 'ckpt-4')
    jax_root = join(scene['out'], 'cli', 'jax_vis')
    _jax_vis(config, jmodel, jparams, jax_root)
    files = _files(jax_root)
    assert _files(port_root) == files
    assert sum(f.startswith('batch000000002/pred_rgb_olat_')
               for f in files) == LIGHT_H * LIGHT_H  # top half of 4 x 8
    for f in files:
        if f.endswith('.png'):
            got = imageio.imread(join(port_root, f)).astype(int)
            want = imageio.imread(join(jax_root, f)).astype(int)
            assert got.shape == want.shape, f
            assert np.abs(got - want).max() <= 1, f
        else:
            with open(join(port_root, f)) as a, open(join(jax_root, f)) as b:
                assert a.read() == b.read(), f


def test_cli_edits(scene):
    ckpt, _, _, _ = make_joint(scene, 'edits', 'bf16_big_chains=False')
    ttest.main(['--ckpt', ckpt, '--device', 'cpu', '--tgt_albedo', 'gold',
                '--debug'])
    outroot = join(dirname(dirname(ckpt)), 'vis_test', 'ckpt-4_gold')
    assert os.path.exists(join(outroot, 'batch000000000', 'pred_rgb.png'))
    with pytest.raises(SystemExit):
        ttest.main(['--ckpt', ckpt, '--tgt_albedo', 'chrome'])


def test_tgt_brdf_matches_jax(scene):
    """--tgt_brdf: both CLIs (--debug: the last view, OLAT relights on)
    with the latent code of a material the BRDF tables name, each in its
    own copy of one experiment. The port's per-view files are the JAX
    CLI's, the images within 1/255, and its code is the checkpoint's row
    for that material."""
    ckpt, _, _, jparams = make_joint(scene, 'tgt_brdf',
                                     'bf16_big_chains=False')
    run = dirname(dirname(ckpt))
    shutil.copytree(run, run + '_port')
    shutil.copy(run + '.ini', run + '_port.ini')
    jtest.main(['--ckpt', ckpt, '--tgt_brdf', 'pearl-paint', '--debug'])
    got = ttest.main(['--ckpt', join(run + '_port', 'checkpoints', 'ckpt-4'),
                      '--device', 'cpu', '--tgt_brdf', 'pearl-paint',
                      '--debug'])
    assert got['outroot'] == join(run + '_port', 'vis_test',
                                  'ckpt-4_pearl-paint')
    np.testing.assert_array_equal(got['brdf_z_override'],
                                  np.asarray(jparams['latent_code'][1]))
    jax_root = join(run, 'vis_test', 'ckpt-4_pearl-paint', 'batch000000000')
    port_root = join(got['outroot'], 'batch000000000')
    files = _files(jax_root)
    assert _files(port_root) == files and 'pred_brdf.png' in files
    for f in files:
        if f.endswith('.png'):
            a = imageio.imread(join(port_root, f)).astype(int)
            b = imageio.imread(join(jax_root, f)).astype(int)
            assert a.shape == b.shape and np.abs(a - b).max() <= 1, f
    # The edit shows: every point takes the one code
    brdf = imageio.imread(join(port_root, 'pred_brdf.png'))
    alpha = imageio.imread(join(port_root, 'gt_alpha.png')) > 204
    assert len(np.unique(brdf[alpha].reshape(-1, 3), axis=0)) == 1


def test_color_correction_scales_match_jax(scene):
    ckpt, config, _, _ = make_joint(scene, 'cc', 'bf16_big_chains=False')
    batch_dir = join(dirname(dirname(ckpt)), 'vis_vali', 'epoch000000004',
                     'batch000000000')
    rng = np.random.RandomState(4)
    imageio.imwrite(join(os.makedirs(batch_dir) or batch_dir,
                         'pred_albedo.png'),
                    (rng.rand(IMH, IMH, 3) * 255).astype(np.uint8))
    with open(join(batch_dir, 'metadata.json'), 'w') as f:
        f.write('{"id": "val_000"}')
    np.testing.assert_allclose(ttest.compute_rgb_scales(ckpt),
                               jtest.compute_rgb_scales(ckpt),
                               rtol=1e-5, atol=1e-6)
    xyz = np.random.RandomState(5).uniform(-2, 2, (30, 3)).astype(np.float32)
    for edit in ('aluminium', 'rainbow'):
        args = ttest.parse_args(['--ckpt', ckpt, '--tgt_albedo', edit])
        np.testing.assert_array_equal(ttest.get_albedo_override(args, xyz),
                                      jtest.get_albedo_override(args, xyz))
