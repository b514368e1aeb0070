"""Runs of the cells: without a card the command fails and prints no
result; on the CPU at small sizes (the harness's look for a card
skipped) a sound run is correct, and each fault that a cell can have,
planted under the timed path, makes it not correct."""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from perfbench import harness
from perfbench.tests.small import SMALL

RUN = os.path.join(harness.HERE, 'run.py')


def run_small(workload, seed=12345678901):
    return harness.run_cell(workload, seed, 0.2, 0, torch.device('cpu'),
                            time.perf_counter(), patch=SMALL[workload])


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run(
        [sys.executable, RUN, '--workload', 'joint-train-graph', '--seed',
         '3', '--seconds', '1', '--trace', '0'], capture_output=True,
        text=True, timeout=300, cwd=harness.ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ''
    assert 'CUDA' in out.stderr


@pytest.mark.parametrize('workload', sorted(SMALL))
def test_sound_run(workload):
    result = run_small(workload)
    assert result['correct'], result['checks']
    assert result['failed'] == 0 and result['attempted'] > 0
    assert list(result)[-1] == 'checks'
    names = {m['name'] for m in harness.load_spec()['end_to_end']}
    assert set(result['metrics']) <= names and 'setup_s' in result['metrics']
    json.dumps(result)


def unchanged_state(monkeypatch):
    """The step returns its state unchanged."""
    from nerfactor_tpu_torch.parallel import train

    def update(self, grads, state):
        return [torch.zeros_like(g) for g in grads], state
    monkeypatch.setattr(train.Optimizer, 'update', update)


def half_batch(monkeypatch):
    """Half of the batch left out, the mean taken over the rest."""
    from nerfactor_tpu_torch.models import nerf, nerfactor
    for cls in (nerf.Model, nerfactor.Model):
        orig = cls.compute_loss

        def compute_loss(self, *a, orig=orig, **k):
            loss = orig(self, *a, **k)
            return loss[:loss.shape[0] // 2]
        monkeypatch.setattr(cls, 'compute_loss', compute_loss)


def march_fault(kind):
    def plant(monkeypatch):
        from nerfactor_tpu_torch import geometry_from_nerf as geo
        orig = geo.GeometryDistiller.lvis_block

        def lvis_block(self, surf, normal):
            (lvis,) = orig(self, surf, normal)
            if kind == 'altered':
                return (torch.roll(lvis, 1, dims=1),)
            return (torch.cat([lvis[:lvis.shape[0] // 2], torch.zeros_like(
                lvis[lvis.shape[0] // 2:])]),)
        monkeypatch.setattr(geo.GeometryDistiller, 'lvis_block', lvis_block)
    return plant


def graph_fault(kind):
    """A fault of the graph path alone, planted in the calls after the
    first: on the card the first call runs eagerly and the later ones
    capture and replay the graph. ``stale_batch``: the static buffers
    not refilled, so each later call trains on the first call's batch
    and draws. ``state_not_advanced``: the captured optimizer update
    leaves Adam's count and moments as they were."""
    def plant(monkeypatch):
        from nerfactor_tpu_torch.parallel import train
        from perfbench import weights
        orig = train.make_train_step_scan

        def make_train_step_scan(*a, **k):
            steps = orig(*a, **k)
            first = []

            def train_steps(params, opt_state, stacked, generator=None,
                            draws=None):
                if not first:
                    first.append(({n: t.clone() for n, t in stacked.items()},
                                  {n: t.clone() for n, t in draws.items()}))
                elif kind == 'stale_batch':
                    stacked, draws = first[0]
                else:
                    adam = opt_state[0]
                    state = weights.leaves([adam.count, adam.m, adam.v,
                                            adam.vhat])
                    kept = [t.clone() for t in state]
                    out = steps(params, opt_state, stacked, generator, draws)
                    for t, was in zip(state, kept):
                        t.copy_(was)
                    return out
                return steps(params, opt_state, stacked, generator, draws)
            return train_steps
        monkeypatch.setattr(train, 'make_train_step_scan',
                            make_train_step_scan)
    plant.__name__ = kind
    return plant


FAULTS = [('joint-train-graph', unchanged_state),
          ('joint-train-graph', half_batch),
          ('joint-train-graph', graph_fault('stale_batch')),
          ('joint-train-graph', graph_fault('state_not_advanced')),
          ('nerf-train-graph', unchanged_state),
          ('nerf-train-graph', half_batch),
          ('nerf-train-graph', graph_fault('stale_batch')),
          ('nerf-train-graph', graph_fault('state_not_advanced')),
          ('nerf-distill-march', march_fault('altered')),
          ('nerf-distill-march', march_fault('half_batch'))]


@pytest.mark.parametrize('workload,plant', FAULTS,
                         ids=['%s-%s' % (w, p.__name__ if p.__name__ !=
                                         'plant' else 'march')
                              for w, p in FAULTS])
def test_a_fault_is_not_correct(workload, plant, monkeypatch):
    plant(monkeypatch)
    result = run_small(workload)
    assert not result['correct'], result['checks']


@pytest.mark.cuda
@pytest.mark.parametrize('workload', ['joint-train-graph',
                                      'nerf-train-graph'])
def test_a_stale_graph_batch_is_not_correct_on_the_card(workload, card,
                                                        monkeypatch):
    """The graph's static buffers filled once, when built, and never
    again: the capture and every replay train on the eager group's
    batch. At the cell's own size."""
    from nerfactor_tpu_torch.parallel import train
    orig = train._GraphSteps.fill

    def fill(self, stacked, draws):
        if not getattr(self, 'filled', False):
            self.filled = True
            orig(self, stacked, draws)
    monkeypatch.setattr(train._GraphSteps, 'fill', fill)
    result = harness.run_cell(workload, 4243, 1.0, 0, card,
                              time.perf_counter())
    assert not result['correct'], result['checks']


SIZES = [pytest.param(w, size, marks=[pytest.mark.cuda] if size == 'cell'
                      else []) for w in sorted(SMALL)
         for size in ('small', 'cell')]


@pytest.mark.parametrize('workload,size', SIZES)
def test_the_control_fails(workload, size, request):
    """The reference in the precision below the configuration's, put in
    the program's place, fails the cell's limits: at the small size on
    the CPU, and at the cell's own size on the card (the readings that
    set the limits are the limits tool's, PERF.md)."""
    import tempfile
    device = request.getfixturevalue('card') if size == 'cell' \
        else torch.device('cpu')
    cell, config, traffic, driver, limits = harness.prepare(
        workload, SMALL[workload] if size == 'small' else None)
    with tempfile.TemporaryDirectory() as tmp:
        run = harness.new_run(cell, config, traffic, 77, device, tmp)
        state = driver.setup(run)
        driver.window(state, 0)
        driver.release(state)
        got = driver.readings(state, 'low')
    assert any(not got[k] <= limits[k] for k in limits), got
    assert all(np.isfinite(got[k]) for k in limits)


@pytest.mark.cuda
@pytest.mark.parametrize('workload', sorted(SMALL))
def test_a_short_run_on_the_card(workload, card):
    out = subprocess.run(
        [sys.executable, RUN, '--workload', workload, '--seed', '4242',
         '--seconds', '2', '--trace', '0'], capture_output=True, text=True,
        timeout=1800, cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result['correct'], result['checks']
    assert result['device']['kind'] == torch.cuda.get_device_name(card)
