"""scan_steps through the port's trainvali CLI on the CPU (the port's
counterpart of tests/test_scan_dispatch.py): the shape stage on the
synthetic scene's 4 train views (4 batches an epoch), 20 epochs. On the
CPU a group of scan_steps batches goes through make_train_step_scan's
plain loop, the batches an epoch leaves over one step each, and the draws
come from the one generator in the order the steps take them, so every
grouping reaches the same checkpoint bit for bit (on the card the graph
replays the same steps; chip_smoke.py's scan_dispatch phase holds it to
the eager loop there):

  * scan_steps = 2 (2 groups an epoch) trains, logs its losses, and its
    ckpt-20 (parameters and optimizer state) is that of scan_steps = 1;
  * scan_steps = 3 over 4 batches: one group and one remainder step an
    epoch, the same ckpt-20;
  * --debug forces one step a call.
"""

import json
from os.path import exists, join

import numpy as np
import pytest

from nerfactor_tpu_torch.utils import ckpt as tckpt
from tests import synth

EPOCHS = 20


@pytest.fixture(scope='module')
def scene(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('tscan_data'))
    synth.make_scene(root, n_train=4, n_vali=1, n_test=1, imh=16,
                     with_buffers=True, light_h=4)
    return root


def _run(root, outroot, scan_steps, *flags, epochs=EPOCHS):
    from nerfactor_tpu_torch import trainvali
    override = ','.join([
        'data_root=%s' % root,
        'data_nerf_root=%s' % join(root, 'surf'),
        'outroot=%s' % outroot,
        'imh=16', 'light_h=4',
        'epochs=%d' % epochs, 'ckpt_period=10', 'vali_period=21',
        'vali_batches=1', 'n_rays_per_step=128',
        'mlp_width=32', 'mlp_depth=2', 'mlp_skip_at=1',
        'mlp_chunk=8192', 'lr=1e-2',
        'scan_steps=%d' % scan_steps,
    ])
    run = trainvali.main(['--config', 'shape.ini', '--config_override',
                          override, '--device', 'cpu', *flags])
    outdir = join(outroot, 'lr1e-2')
    with open(join(outdir, 'summary_train', 'scalars.jsonl')) as h:
        recs = [json.loads(line) for line in h]
    return run, outdir, [r['loss_train'] for r in recs if 'loss_train' in r]


@pytest.fixture(scope='module')
def one_step(scene, tmp_path_factory):
    """The run with scan_steps = 1."""
    return _run(scene, str(tmp_path_factory.mktemp('tscan_out1')), 1)


def assert_same_checkpoint(dir_a, dir_b, step=EPOCHS):
    a, b = (tckpt.read_leaves(join(d, 'checkpoints', 'ckpt-%d' % step))
            for d in (dir_a, dir_b))
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


def test_scan_dispatch_trains(scene, one_step, tmp_path_factory):
    run1, dir1, losses1 = one_step
    runk, dirk, lossesk = _run(scene, str(tmp_path_factory.mktemp(
        'tscan_outk')), 2)
    assert exists(join(dirk, 'checkpoints', 'ckpt-20.npz'))
    assert (run1['scan_steps'], run1['scan_groups']) == (1, 0)
    assert (runk['scan_steps'], runk['scan_groups']) == (2, 2 * EPOCHS)
    assert runk['scan_captured'] is None  # no graph on the CPU
    assert lossesk[-1] < lossesk[0]
    assert lossesk == losses1
    assert_same_checkpoint(dirk, dir1)


def test_scan_dispatch_remainder(scene, one_step, tmp_path_factory):
    """scan_steps = 3 over 4 batches an epoch: one group and one single
    step an epoch."""
    _, dir1, _ = one_step
    run, dirk, losses = _run(scene, str(tmp_path_factory.mktemp(
        'tscan_outr')), 3)
    assert run['scan_groups'] == EPOCHS
    assert losses[-1] < losses[0]
    assert_same_checkpoint(dirk, dir1)


def test_debug_forces_one_step(scene, tmp_path_factory):
    run, _, _ = _run(scene, str(tmp_path_factory.mktemp('tscan_debug')), 2,
                     '--debug', epochs=10)
    assert (run['scan_steps'], run['scan_groups']) == (1, 0)


def test_step_tools_scan_runs_the_plain_loop(capsys):
    """tools.step_time and tools.profile_joint with --scan 2 on the CPU:
    make_train_step_scan's plain loop, two steps a call, ``scan`` in the
    JSON line; nothing captured, no kernel counted."""
    from nerfactor_tpu_torch.tools import bench_model, profile_joint, step_time
    small = ['--device', 'cpu', '--rays', '32', '--light_h', '2',
             '--override', bench_model.TINY, '--scan', '2']
    got = step_time.main(['--steps', '2', '--warmup', '1'] + small)
    assert (got['scan'], got['steps']) == (2, 4)
    assert got['capture'] is None and got['launches_per_step'] == {}
    assert got['ms_per_step'] > 0 and np.isfinite(got['loss'])
    got = profile_joint.main(['--steps', '1', '--warmup', '1', '--top', '3']
                             + small)
    assert (got['scan'], got['steps']) == (2, 2)
    assert got['capture'] is None and len(got['top_host_ms']) == 3
    capsys.readouterr()
