"""The port's ``trainvali --multihost`` through its real command line on
the CPU (gloo), as tests/test_multihost.py drives the JAX package's: the
shape stage (shape.ini) on a tiny synthetic scene, each rank a process
with one thread, meeting at a file:// rendezvous.

  * two ranks: rank 0 alone writes the INI, the checkpoints and one train
    summary a checkpoint; the loss falls; the final loss reaches the one-
    rank run's level (each rank samples its own rays, so the two runs see
    different batches: equality is step-level, tests/
    test_torch_multidevice.py);
  * one rank under --multihost writes the same ckpt-N, bit for bit, as
    the run without --multihost;
  * a coordinator that takes the connection and never answers ends the
    rank with a non-zero exit within the timeout and its grace period
    (TIMEOUT_S + mesh.JOIN_GRACE_S) and the start-up, not a hang.
"""

import json
import os
import socket
import subprocess
import sys
import time
from os.path import dirname, exists, join

import numpy as np

from nerfactor_tpu_torch.parallel import mesh
from nerfactor_tpu_torch.utils import ckpt as tckpt
from tests import synth

REPO = dirname(dirname(os.path.abspath(__file__)))
EPOCHS, CKPT_PERIOD = 8, 4
TIMEOUT_S = 3
START_S = 30  # a process's imports and parsing, with room for a busy host


def trainvali(root, outroot, *args):
    """A trainvali process on shape.ini at test width on the scene at
    ``root``, one thread."""
    override = ','.join([
        'data_root=%s' % root, 'data_nerf_root=%s' % join(root, 'surf'),
        'outroot=%s' % outroot, 'imh=16', 'light_h=4',
        'epochs=%d' % EPOCHS, 'ckpt_period=%d' % CKPT_PERIOD,
        'vali_period=%d' % EPOCHS, 'vali_batches=1', 'n_rays_per_step=64',
        'mlp_width=16', 'mlp_depth=2', 'mlp_skip_at=1', 'mlp_chunk=4096',
        'lr=1e-2', 'tensorboard=False'])
    env = dict(os.environ, OMP_NUM_THREADS='1')
    return subprocess.Popen(
        [sys.executable, '-m', 'nerfactor_tpu_torch.trainvali',
         '--config', 'shape.ini', '--config_override', override,
         '--device', 'cpu', *args], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)


def output(p, timeout):
    """``p``'s output once it ends; killed if it outlives ``timeout``."""
    try:
        return p.communicate(timeout=timeout)[0]
    except subprocess.TimeoutExpired:
        p.kill()
        p.communicate()
        raise


def finish(procs, timeout=300):
    outs = [output(p, timeout).decode(errors='replace') for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, 'trainvali exited %d:\n%s' % (
            p.returncode, out[-3000:])


def summaries(run):
    with open(join(run, 'summary_train', 'scalars.jsonl')) as f:
        return [json.loads(line) for line in f]


def test_trainvali_multihost_cli(tmp_path):
    root = str(tmp_path / 'data')
    synth.make_scene(root, n_train=4, n_vali=1, n_test=1, imh=16,
                     with_buffers=True, light_h=4)
    store = 'file://' + str(tmp_path / 'rendezvous')
    out = {k: str(tmp_path / k) for k in ('two', 'one', 'plain')}
    procs = [trainvali(root, out['two'], '--multihost', '--coordinator',
                       store, '--num_processes', '2', '--process_id', str(r))
             for r in range(2)]
    procs.append(trainvali(root, out['one'], '--multihost', '--coordinator',
                           store + '_one', '--num_processes', '1',
                           '--process_id', '0'))
    procs.append(trainvali(root, out['plain']))
    finish(procs)
    run = {k: join(v, 'lr1e-2') for k, v in out.items()}
    # Rank 0 alone writes: one summary line a checkpoint, and the files
    recs = summaries(run['two'])
    assert [r['step'] for r in recs] == list(range(
        CKPT_PERIOD, EPOCHS + 1, CKPT_PERIOD)), recs
    for n in range(CKPT_PERIOD, EPOCHS + 1, CKPT_PERIOD):
        assert exists(join(run['two'], 'checkpoints', 'ckpt-%d.npz' % n))
    assert exists(run['two'] + '.ini')
    assert exists(join(run['two'], 'vis_vali', 'epoch%09d' % EPOCHS,
                       'all.html'))
    l2 = [r['loss_train'] for r in recs]
    l1 = [r['loss_train'] for r in summaries(run['one'])]
    assert np.isfinite(l1 + l2).all()
    assert l1[-1] < 0.75 * l1[0], l1
    assert l2[-1] < 0.75 * l2[0], l2
    assert l2[-1] < 2.0 * l1[-1], (l1, l2)
    # One rank under --multihost is the run without it, bit for bit
    for n in range(CKPT_PERIOD, EPOCHS + 1, CKPT_PERIOD):
        one, plain = (tckpt.read_leaves(join(run[k], 'checkpoints',
                                             'ckpt-%d' % n))
                      for k in ('one', 'plain'))
        assert len(one) == len(plain)
        for a, b in zip(one, plain):
            np.testing.assert_array_equal(a, b)


def test_coordinator_that_never_answers_fails(tmp_path):
    with socket.socket() as s:  # accepts connections, never answers
        s.bind(('localhost', 0))
        s.listen(1)
        t0 = time.perf_counter()
        p = trainvali(str(tmp_path), str(tmp_path), '--multihost',
                      '--coordinator',
                      'localhost:%d' % s.getsockname()[1],
                      '--num_processes', '2', '--process_id', '1',
                      '--timeout', str(TIMEOUT_S))
        out = output(p, TIMEOUT_S + mesh.JOIN_GRACE_S + START_S)
        waited = time.perf_counter() - t0
    assert p.returncode != 0, out.decode(errors='replace')[-2000:]
    assert waited < TIMEOUT_S + mesh.JOIN_GRACE_S + START_S
    assert b'init_process_group' in out
