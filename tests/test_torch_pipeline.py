"""The PyTorch port's end-to-end pipeline vs the JAX package (CPU).

  * the shipped INIs of the port are the JAX package's, byte for byte;
  * the port's scene generator (nerfactor_tpu_torch/tools/synth_scene.py)
    writes the files of tests/synth.py: every .npy equal, every PNG the
    same pixels, the same metadata;
  * the two harnesses, tools/quality_e2e.py and the port's
    nerfactor_tpu_torch/tools/quality_e2e.py, at one tiny size (imh 8,
    light_h 2, width 16, 64 rays a step) with every stage (BRDF prior,
    shape, joint) resumed from the same JAX-written ckpt-1: each stage's
    final checkpoint and the joint model's per-view vali PSNR agree, and
    the report lines carry the same keys;
  * the port's harness with ``--from_nerf`` runs NeRF, distillation and
    the three stages to its report line.

The harness runs take the f32 chains and no smoothness jitter: the two
packages draw the jitter noise from different generators, and the bf16
chains round in different places (the step tests hold both: the jitter
with the JAX noise fed to the port, tests/test_torch_train.py,
tests/test_torch_shape.py; bf16 against the Pallas kernels,
tests/test_torch_chain.py).
"""

import contextlib
import filecmp
import io
import json
import os
import shutil
from os.path import join

import jax
import numpy as np
import pytest

from nerfactor_tpu_torch.tools import quality_e2e as tquality
from nerfactor_tpu_torch.tools import synth_scene
from nerfactor_tpu_torch.utils import ckpt as tckpt, io as tio
from nerfactor_tpu_torch.utils import config as tconfig
from tests import synth
from tools import perf_ledger
from tools import quality_e2e as jquality

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ['--imh', '8', '--light_h', '2', '--n_train', '3', '--mlp_width',
        '16', '--n_rays', '64']
# Stage run dirs (up to the lr folder) under <workdir>/out
STAGES = ('merl/lr1e-2', 'shape/lr1e-2', 'nerfactor/lr5e-3')
EPOCHS = 3
# The f32 chains, no jitter (module docstring), and the joint and shape
# init seeds of the JAX run that writes every stage's ckpt-1
EXTRA = 'xyz_jitter_std=0,bf16_big_chains=False,seed=%d'
SEED = 1
# A stage's final params (and optimizer state) against the JAX
# package's: each leaf within PARAM_TOL, elementwise (rtol and atol). Read
# over the init seeds 0-3 of EXTRA, |port - jax| / (1 + |jax|) at most
# 1.2e-7 (brdf), 8.7e-8 (shape), 6.2e-7 (joint): f32 summation order.
PARAM_TOL = 1e-5
# The joint model's per-view vali PSNR against the JAX package's, in dB
# (from the 8-bit renders): equal over seeds 0-3.
PSNR_TOL = 0.01


def _files(root):
    return sorted(os.path.relpath(join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def test_shipped_configs_are_the_jax_packages():
    jdir = join(REPO, 'nerfactor_tpu', 'config')
    names = sorted(os.listdir(jdir))
    assert sorted(os.listdir(tconfig.CONFIG_DIR)) == names
    assert tconfig.CONFIG_DIR == join(REPO, 'nerfactor_tpu_torch', 'config')
    for name in names:
        assert filecmp.cmp(join(jdir, name), join(tconfig.CONFIG_DIR, name),
                           shallow=False), name


@pytest.mark.parametrize('with_buffers', [True, False])
def test_synth_scene_writes_the_jax_scene(tmp_path, with_buffers):
    kwargs = dict(n_train=3, n_vali=2, n_test=2, imh=12,
                  with_buffers=with_buffers, light_h=2)
    jroot, troot = str(tmp_path / 'jax'), str(tmp_path / 'port')
    synth.make_scene(jroot, **kwargs)
    synth_scene.make_scene(troot, **kwargs)
    files = _files(jroot)
    assert _files(troot) == files
    assert ('surf/train_000/lvis.npy' in files) == with_buffers
    assert {'test_001/metadata.json', 'val_001/rgba.png',
            'train_002/albedo.png'} <= set(files)
    for f in files:
        got, want = join(troot, f), join(jroot, f)
        if f.endswith('.npy'):
            a, b = np.load(got), np.load(want)
            assert a.dtype == b.dtype and np.array_equal(a, b), f
        elif f.endswith('.png'):
            a, b = tio.read_png(got), tio.read_png(want)
            assert a.dtype == b.dtype and np.array_equal(a, b), f
        else:
            assert tio.read_json(got) == tio.read_json(want), f


def run_jax_harness(argv, monkeypatch):
    """The JAX harness's report; it appends nothing to PERF.jsonl and
    leaves the process's JAX config (its compilation cache) as it is."""
    out = io.StringIO()
    with monkeypatch.context() as m, contextlib.redirect_stdout(out):
        m.setattr(perf_ledger, 'append', lambda *a, **k: None)
        m.setattr(jax.config, 'update', lambda *a, **k: None)
        jquality.main(argv)
    return json.loads(out.getvalue().strip().splitlines()[-1])


def run_both_from_one_start(tmp_path, monkeypatch, seed):
    """Writes every stage's ckpt-1 with the JAX harness, puts a copy in
    each harness's run dirs, and runs both to epoch EPOCHS from there (the
    JAX one resumed too, so both datapipes count from 0). Returns the
    two workdirs and reports."""
    start, jwk, twk = (str(tmp_path / d) for d in ('start', 'jax', 'port'))
    extra = ['--extra_override', EXTRA % seed]
    run_jax_harness(['--workdir', start, '--epochs_brdf', '1',
                     '--epochs_shape', '1', '--epochs_joint', '1']
                    + TINY + extra, monkeypatch)
    for wk in (jwk, twk):
        for stage in STAGES:
            ckptdir = join(wk, 'out', stage, 'checkpoints')
            os.makedirs(ckptdir)
            shutil.copy(join(start, 'out', stage, 'checkpoints',
                             'ckpt-1.npz'), ckptdir)
    epochs = ['--epochs_brdf', str(EPOCHS), '--epochs_shape', str(EPOCHS),
              '--epochs_joint', str(EPOCHS)]
    jrec = run_jax_harness(['--workdir', jwk] + epochs + TINY + extra,
                           monkeypatch)
    trec = tquality.main(['--workdir', twk, '--device', 'cpu'] + epochs
                         + TINY + extra)
    return jwk, twk, jrec, trec


def test_harness_matches_jax_from_one_start(tmp_path, monkeypatch):
    """Both harnesses, each stage resumed from one JAX-written ckpt-1:
    the final checkpoints within PARAM_TOL, the per-view PSNR within
    PSNR_TOL, the same report keys, and the port's record written under
    its workdir."""
    jwk, twk, jrec, trec = run_both_from_one_start(
        tmp_path, monkeypatch, SEED)
    for stage in STAGES:
        ckpt = join('out', stage, 'checkpoints', 'ckpt-%d' % EPOCHS)
        want = tckpt.read_leaves(join(jwk, ckpt))
        got = tckpt.read_leaves(join(twk, ckpt))
        assert [a.shape for a in got] == [a.shape for a in want], stage
        for i, (g, w) in enumerate(zip(got, want)):
            np.testing.assert_allclose(g, w, rtol=PARAM_TOL, atol=PARAM_TOL,
                                       err_msg='%s leaf %d' % (stage, i))
    # The hand-offs: every stage's config the same but for the workdir
    # (the checkpoints each stage restores, the buffers it reads)
    for stage in STAGES:
        want = tconfig.config2dict(tconfig.read_config(
            join(jwk, 'out', stage + '.ini')))
        got = tconfig.config2dict(tconfig.read_config(
            join(twk, 'out', stage + '.ini')))
        assert got == {k: v.replace(jwk, twk) for k, v in want.items()}
    assert 'shape/lr1e-2/checkpoints/ckpt-%d' % EPOCHS in got[
        'shape_model_ckpt']
    assert sorted(trec) == sorted(jrec) == [
        'mean_psnr', 'per_view_psnr', 'stage_walls_min', 'total_min']
    assert sorted(trec['stage_walls_min']) == \
        sorted(jrec['stage_walls_min']) == ['brdf', 'joint', 'shape']
    assert [v for v, _ in trec['per_view_psnr']] == \
        [v for v, _ in jrec['per_view_psnr']] == ['val_000', 'val_001']
    for (_, got), (_, want) in zip(trec['per_view_psnr'],
                                   jrec['per_view_psnr']):
        assert abs(got - want) <= PSNR_TOL, (got, want)
    assert abs(trec['mean_psnr'] - jrec['mean_psnr']) <= PSNR_TOL
    with open(join(twk, 'quality_e2e.json')) as h:
        assert json.load(h) == json.loads(json.dumps(trec))


def test_harness_from_nerf_runs_to_its_report(tmp_path, capsys):
    """--from_nerf on the CPU: the NeRF and distillation stages run, the
    later stages read the distilled buffers, and the report line names
    all five stages."""
    wk = str(tmp_path / 'wk')
    rec = tquality.main(['--workdir', wk, '--device', 'cpu', '--from_nerf',
                         '--epochs_nerf', '2', '--epochs_brdf', '1',
                         '--epochs_shape', '1', '--epochs_joint', '1']
                        + TINY)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == json.loads(json.dumps(rec))
    assert sorted(rec['stage_walls_min']) == [
        'brdf', 'distill', 'joint', 'nerf', 'shape']
    assert len(rec['per_view_psnr']) == 2
    assert np.isfinite(rec['mean_psnr'])
    surf = join(wk, 'out', 'surf_from_nerf')
    assert os.path.isfile(join(surf, 'train_000', 'lvis.npy'))
    ini = tconfig.read_config(join(wk, 'out', 'nerfactor', 'lr5e-3.ini'))
    assert ini.get('DEFAULT', 'data_nerf_root') == surf
    assert os.path.isfile(join(wk, 'out', 'nerf', 'lr5e-4', 'checkpoints',
                               'ckpt-2.npz'))
