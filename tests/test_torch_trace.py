"""The port's in-program tracing (``nerfactor_tpu_torch/utils/trace.py``):
spans, recorded only while a torch profiler runs, and the one counter
registry, which always counts.

On the CPU: with the profiler off a span calls no ``record_function``,
reads no clock and stores nothing, while counters advance; under the
profiler nested spans carry their parent, self time is the duration less
the children's, and every stored span has its ``record_function`` twin
in the profiler's events; a name outside ``program.`` is refused; the
kernel wrappers' launch counters stay where ``ops/kernel_lib.py`` had
them; the multi-step dispatch's plain loop and distillation's blocks
record their spans and counters.

The tests marked ``cuda`` skip without a card; on one:

  python -m pytest tests/test_torch_trace.py -m cuda -q

They hold a graph group's ``h2d_bytes`` to the bytes of its stacked
batch, keep the ``program.dispatch.*`` spans out of the device's
operations, and run ``trainvali --profile_steps 16`` at ``scan_steps`` 8
(the profiler over the graph's warm-up, capture and first replay) to the
checkpoint of the run without it.
"""

import json
import math
import os
import time
from os.path import join
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from nerfactor_tpu_torch import geometry_from_nerf as tgeo
from nerfactor_tpu_torch.models.nerf import Model as TNerf
from nerfactor_tpu_torch.ops import (dot_probe, fused_mlp, fused_nerf,
                                     fused_rusink, kernel_lib)
from nerfactor_tpu_torch.parallel import train as ttrain
from nerfactor_tpu_torch.utils import ckpt as tckpt, config as configutil
from nerfactor_tpu_torch.utils import trace

OUTER = trace.span('program.test.outer')
INNER = trace.span('program.test.inner')
CPU_ACTS = [torch.profiler.ProfilerActivity.CPU]


@pytest.fixture(autouse=True)
def empty_store():
    trace.reset()
    yield
    trace.reset()


def profiled(acts=CPU_ACTS):
    return torch.profiler.profile(activities=acts)


def sleep_ms(ms):
    time.sleep(ms / 1e3)


# ------ spans and counters ------

def nerf_distiller(mlp_chunk=512):
    """The port's NeRF at a small width on the CPU and a distiller over 8
    lights; at ``mlp_chunk`` 512 a visibility block holds 32 points."""
    parser = configutil.read_config(configutil.resolve_config_path(
        'nerf.ini'))
    configutil.apply_override(parser, (
        'imh=8,mlp_width=32,enc_depth=4,n_samples_coarse=8,'
        'n_samples_fine=16,n_rays_per_step=64,n_freqs_xyz=4,'
        'n_freqs_view=2,near=2,far=6'))
    config = configutil.Config(parser)
    model = TNerf(config, device='cpu')
    params = model.init_params(torch.Generator().manual_seed(0))
    args = tgeo.parse_args([
        '--trained_nerf', 'unused', '--out_root', 'unused', '--light_h', '2',
        '--lvis_far', '2', '--mlp_chunk', str(mlp_chunk), '--device',
        'cpu'])
    return tgeo.GeometryDistiller(model, params, config, args)


def surface_points(n, seed=0):
    nrm = np.random.RandomState(seed).randn(n, 3)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    return (0.8 * nrm).astype(np.float32), nrm.astype(np.float32)


def distill_counts():
    return {attr: getattr(tgeo.GeometryDistiller, attr)
            for attr in ('points', 'h2d_bytes', 'd2h_bytes')}


def test_span_off_does_nothing_but_counters_count(monkeypatch):
    """With no profiler running a span calls no record_function, reads no
    clock and appends nothing to the store; the program's counters still
    advance (here distillation's, over one call)."""
    assert not torch.autograd.profiler._is_profiler_enabled

    def boom(*args, **kwargs):
        raise AssertionError("called with the profiler off")
    monkeypatch.setattr(torch.autograd.profiler, 'record_function', boom)
    monkeypatch.setattr(torch.profiler, 'record_function', boom)
    monkeypatch.setattr(trace, '_clock', boom)
    dist = nerf_distiller()
    before = distill_counts()
    stored = trace._store.next
    with OUTER:
        with INNER:
            pass
    dist.compute_light_visibility(*surface_points(40))
    assert trace._store.next == stored
    assert trace.summary()['spans'] == {}
    after = distill_counts()
    assert after['points'] == before['points'] + 40
    assert after['h2d_bytes'] == before['h2d_bytes'] + 40 * 2 * 3 * 4


def test_nested_spans_carry_their_parent_and_self_time():
    """Under the profiler each span's parent is the innermost span open
    when it opened, and its self time is its duration less its
    children's."""
    with profiled():
        with OUTER:
            sleep_ms(2)
            with INNER:
                sleep_ms(3)
            with INNER:
                sleep_ms(1)
        with INNER:
            pass
    rows = trace.spans()
    assert [(name, parent) for name, _, _, parent in rows] == [
        ('program.test.outer', -1), ('program.test.inner', 0),
        ('program.test.inner', 0), ('program.test.inner', -1)]
    dur = [(t1 - t0) / 1e6 for _, t0, t1, _ in rows]
    got = trace.summary()['spans']
    assert got['program.test.outer']['count'] == 1
    assert got['program.test.inner']['count'] == 3
    assert math.isclose(got['program.test.outer']['total_ms'], dur[0])
    assert math.isclose(got['program.test.outer']['self_ms'],
                        dur[0] - dur[1] - dur[2])
    assert math.isclose(got['program.test.inner']['self_ms'], sum(dur[1:]))
    assert dur[1] >= 3 and got['program.test.outer']['self_ms'] >= 2


def test_every_stored_span_has_its_profiler_twin():
    """Each stored span has a record_function event of its name in the
    profiler's events, as many of each name, their durations within 5 %
    or 50 us (a first record_function in the process imports a module
    first: a span before the window takes that)."""
    with profiled():
        with OUTER:
            pass
    trace.reset()
    with profiled() as prof:
        for ms in (8, 16, 32):
            with OUTER:
                sleep_ms(ms)
                with INNER:
                    sleep_ms(ms / 2)
    stored = {}
    for name, t0, t1, _ in trace.spans():
        stored.setdefault(name, []).append((t1 - t0) / 1e3)
    seen = {}
    for e in prof.events():
        if e.name.startswith('program.test.'):
            seen.setdefault(e.name, []).append(
                (e.time_range.start, e.time_range.end - e.time_range.start))
    assert sorted(seen) == sorted(stored) == ['program.test.inner',
                                              'program.test.outer']
    for name, us in stored.items():
        twins = [d for _, d in sorted(seen[name])]
        assert len(twins) == len(us) == 3
        for a, b in zip(us, twins):
            assert abs(a - b) <= max(0.05 * b, 50.0), (name, a, b)


def test_span_closes_when_its_body_raises():
    """An exception inside a span passes through it; the span is stored
    as ended, and the next span opens at the outer level again, not as
    its child."""
    with profiled():
        with OUTER:
            with pytest.raises(RuntimeError, match='inside'):
                with INNER:
                    raise RuntimeError('inside')
            with INNER:
                pass
    rows = trace.spans()
    assert [(name, parent) for name, _, _, parent in rows] == [
        ('program.test.outer', -1), ('program.test.inner', 0),
        ('program.test.inner', 0)]
    assert all(t1 >= t0 for _, t0, t1, _ in rows)


@pytest.mark.parametrize('name', [
    'bench.dispatch', 'program', 'program.', 'program.Dispatch',
    'program.dispatch-fill', 'Program.dispatch', 'program.dispatch 2',
    'xprogram.dispatch'])
def test_span_name_outside_program_is_refused(name):
    with pytest.raises(ValueError, match='span name'):
        trace.span(name)


def test_launch_counters_stay_as_they_were():
    """``kernel_lib`` re-exports the one registry's launch counters: the
    same objects, every entry a kernel wrapper's ``*launches`` attribute,
    ``launch_counts()`` those alone. The program's other counters register
    beside them, none named ``launches`` (the benchmark sums those)."""
    assert kernel_lib.COUNTERS is trace.COUNTERS
    for name in ('launch_counters', 'launch_counts', 'add_launches'):
        assert getattr(kernel_lib, name) is getattr(trace, name)
    wrappers = {fn for mod in (dot_probe, fused_mlp, fused_nerf,
                               fused_rusink) for fn in vars(mod).values()
                if callable(fn)}
    assert all(fn in wrappers and attr.endswith('launches')
               for fn, attr in kernel_lib.COUNTERS)
    assert set(kernel_lib.launch_counts()) == set(kernel_lib.COUNTERS)
    program = set(trace.PROGRAM_COUNTERS)
    assert {(ttrain._GraphSteps, 'groups'), (ttrain._GraphSteps, 'h2d_bytes'),
            (tgeo.GeometryDistiller, 'points'),
            (tgeo.GeometryDistiller, 'h2d_bytes'),
            (tgeo.GeometryDistiller, 'd2h_bytes')} <= program
    assert not program & set(kernel_lib.COUNTERS)
    assert all(attr != 'launches' for _, attr in program)
    assert set(trace.counts()) == program | set(kernel_lib.COUNTERS)
    names = trace.summary()['counters']
    assert 'train._GraphSteps.h2d_bytes' in names
    assert 'fused_mlp.chain_kernel.launches' in names


@pytest.mark.parametrize('n', [1, 32, 70])
def test_distillation_records_its_spans_and_counters(n):
    """compute_light_visibility on the CPU: the span program.distill with
    its inputs, blocks and copies out as children (no wait off the card),
    ceil(n / lvis_block_pts) block spans, and counters of n points, n x 2 x
    3 x 4 bytes in and n x L x 4 bytes out."""
    dist = nerf_distiller()
    assert dist.lvis_block_pts == 32 and dist.n_lights == 8
    before = distill_counts()
    with profiled():
        lvis = dist.compute_light_visibility(*surface_points(n))
    assert lvis.shape == (n, 8)
    after = distill_counts()
    blocks = -(-n // dist.lvis_block_pts)
    assert after['points'] - before['points'] == n
    assert after['h2d_bytes'] - before['h2d_bytes'] == n * 2 * 3 * 4
    assert after['d2h_bytes'] - before['d2h_bytes'] == n * dist.n_lights * 4
    rows = trace.spans()
    top = [i for i, r in enumerate(rows) if r[0] == 'program.distill']
    assert len(top) == 1
    kids = [r[0] for r in rows if r[3] == top[0]]
    # Block i + 1 is issued before block i's copy out
    assert kids == ['program.distill.inputs', 'program.distill.block'] + [
        'program.distill.block', 'program.distill.copy_out'] * (
            blocks - 1) + ['program.distill.copy_out']
    spans = trace.summary()['spans']
    assert spans['program.distill.block']['count'] == blocks
    assert 'program.distill.wait' not in spans


def test_distill_reader_leaves_out_the_blocks_past_the_queue(monkeypatch):
    """``distill_host_ms.distill`` (perfbench): the value is the median of
    a call's first four blocks and of their copies out, plus the call's
    and its inputs' self time over its blocks; the later blocks, which wait
    on a full launch queue, count in ``blocked_ms`` alone. Timed by a
    stand-in clock, in ms."""
    from perfbench import harness
    now = [0]
    monkeypatch.setattr(trace, '_clock', lambda: now[0] * 1000000)

    def run(span, ms):
        with span:
            now[0] += ms
    blocks, copies = [3, 5, 4, 6, 40, 50], [1, 1, 2, 1, 9, 9]
    with profiled():
        with tgeo.DISTILL:
            now[0] += 1
            run(tgeo.DISTILL_INPUTS, 2)
            for b, c in zip(blocks, copies):
                run(tgeo.DISTILL_BLOCK, b)
                run(tgeo.DISTILL_COPY_OUT, c)
    reader = harness.load_module('metrics', 'distill_host_ms.distill')
    got = reader.read(SimpleNamespace(trace={}))
    assert got['value'] == pytest.approx(4.5 + 1 + (1 + 2) / 6)
    assert got['blocked_ms'] == pytest.approx((108 + 23 + 3) / 6)
    assert (got['block_ms_first'], got['block_ms_later']) == (4.5, 45)
    assert (got['calls'], got['blocks']) == (1, 6)
    assert reader.read(SimpleNamespace(trace=None)) is None
    trace.reset()
    assert reader.read(SimpleNamespace(trace={})) is None


class Toy:
    """y = x @ w + 0.01 N(0, 1), its noise the ``jitter_noise`` draw."""

    def __init__(self):
        self.config = None

    def apply(self, params, batch, mode='train', generator=None,
              jitter_noise=None):
        if jitter_noise is None:
            jitter_noise = 0.01 * torch.randn(
                batch['x'].shape[0], 1, generator=generator,
                device=batch['x'].device)
        return {'y': batch['x'] @ params['w'] + jitter_noise}, \
            {'y': batch['y']}, {}, {}

    def compute_loss(self, params, pred, gt):
        return torch.mean(torch.square(pred['y'] - gt['y']), dim=-1)


def toy_run(device, n_steps=4, rows=64):
    params = {'w': torch.zeros(3, 1, device=device)}
    optimizer = ttrain.Optimizer(None, lambda count: 0.01)
    opt_state = optimizer.init(params)
    steps = ttrain.make_train_step_scan(Toy(), optimizer, n_steps=n_steps)
    gen = torch.Generator(device=device).manual_seed(0)
    rng = np.random.RandomState(0)
    pin = device.type == 'cuda'

    def batch():
        x = rng.randn(n_steps, rows, 3).astype(np.float32)
        y = x @ np.array([[1.0], [-2.0], [0.5]], np.float32)
        out = {'x': torch.from_numpy(x), 'y': torch.from_numpy(y)}
        return {k: v.pin_memory() for k, v in out.items()} if pin else out

    def call():
        nonlocal params, opt_state
        stacked = batch()
        params, opt_state, losses = steps(params, opt_state, stacked,
                                          generator=gen)
        return stacked, losses
    return call


def test_dispatch_plain_loop_records_the_step_phases():
    """On the CPU a call of make_train_step_scan (the plain loop) is the
    span program.dispatch with each step's forward, backward and
    optimizer under it."""
    call = toy_run(torch.device('cpu'))
    with profiled():
        call()
    rows = trace.spans()
    top = [i for i, r in enumerate(rows) if r[0] == 'program.dispatch']
    assert len(top) == 1
    assert [r[0] for r in rows if r[3] == top[0]] == [
        'program.step.forward', 'program.step.backward',
        'program.step.optimizer'] * 4


def test_step_phases_split_the_device_time_of_eager_steps():
    """``utils/card.step_phases`` on a window of two eager steps: the
    forward and the optimizer from their spans' device-side copies, the
    backward between them (its kernels come from autograd's device thread,
    outside the step's spans), each with the part of it that kernels
    filled; the filler, the host side and other spans left out."""
    from types import SimpleNamespace
    from nerfactor_tpu_torch.utils import card
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU

    def ev(name, start, end, device=cuda):
        return SimpleNamespace(name=name, device_type=device,
                               time_range=SimpleNamespace(start=start,
                                                          end=end))
    events = [ev(card.FILLER_KERNEL, 0, 5000)]
    for t in (10000, 30000):  # us: two steps
        events += [
            ev('program.step.forward', t, t + 3000),
            ev('program.step.forward', t - 500, t + 9000, cpu),
            ev('program.dispatch', t, t + 20000),
            ev('k_fwd', t, t + 1000), ev('k_fwd', t + 2000, t + 3000),
            ev('k_bwd', t + 3500, t + 8500),
            ev('program.step.optimizer', t + 9000, t + 10000),
            ev('k_opt', t + 9000, t + 9500)]
    got = card.step_phases(SimpleNamespace(events=lambda: events))
    assert got == {'forward': {'span_ms': 6.0, 'busy_ms': 4.0},
                   'backward': {'span_ms': 12.0, 'busy_ms': 10.0},
                   'optimizer': {'span_ms': 2.0, 'busy_ms': 1.0}}


# ------ on the card ------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the graph dispatch captures only "
                    "there")
    return torch.device('cuda')


@pytest.mark.cuda
def test_graph_group_counts_its_bytes_and_spans(cuda):
    """A group through the graph adds the nbytes of its stacked arrays to
    ``_GraphSteps.h2d_bytes`` and one to ``groups``; under a profiler
    window its call is program.dispatch with check, fill and replay
    children, none of which the benchmark's reduction takes for a device
    operation, while the fill's copy is one."""
    from perfbench import card as bench_card
    call = toy_run(cuda)
    call()  # eager warm-up
    call()  # capture and first replay
    torch.cuda.synchronize()
    g = ttrain._GraphSteps
    before = (g.groups, g.h2d_bytes)
    with profiled(CPU_ACTS + [torch.profiler.ProfilerActivity.CUDA]) as prof:
        stacked, losses = call()
        torch.cuda.synchronize()
    assert (g.groups - before[0], g.h2d_bytes - before[1]) == (
        1, sum(v.nbytes for v in stacked.values()))
    assert torch.isfinite(losses).all()
    rows = trace.spans()
    top = [i for i, r in enumerate(rows) if r[0] == 'program.dispatch']
    assert len(top) == 1
    assert [r[0] for r in rows if r[3] == top[0]] == [
        'program.dispatch.check', 'program.dispatch.fill',
        'program.dispatch.replay']
    assert not any(r[0].startswith('program.step.') for r in rows)
    reduced = bench_card.reduce_trace(prof)
    assert not [k for k in reduced['by_name'] if k.startswith('program.')]
    assert [k for k in reduced['by_name'] if k.startswith('Memcpy HtoD')]


@pytest.mark.cuda
def test_trainvali_profile_steps_over_the_graph(cuda, tmp_path):
    """trainvali --profile_steps 16 at scan_steps = 8 (16 views, a batch
    a view): the profiler spans the graph's eager group and its capture
    and first replay; the run captures, replays, writes trace.json and
    spans.json, and reaches the checkpoint of the run without the flag
    bit for bit."""
    from nerfactor_tpu_torch import trainvali
    from nerfactor_tpu_torch.tools import synth_scene
    root = str(tmp_path / 'data')
    synth_scene.make_scene(root, n_train=16, n_vali=1, n_test=1, imh=16,
                     with_buffers=True, light_h=4)

    def run(outroot, *flags):
        override = ','.join([
            'data_root=%s' % root, 'data_nerf_root=%s' % join(root, 'surf'),
            'outroot=%s' % outroot, 'imh=16', 'light_h=4', 'epochs=2',
            'ckpt_period=2', 'vali_period=3', 'vali_batches=1',
            'n_rays_per_step=128', 'mlp_width=32', 'mlp_depth=2',
            'mlp_skip_at=1', 'mlp_chunk=8192', 'lr=1e-2', 'scan_steps=8'])
        got = trainvali.main(['--config', 'shape.ini', '--config_override',
                              override, '--device', 'cuda', *flags])
        return got, join(outroot, 'lr1e-2')
    got, traced = run(str(tmp_path / 'traced'), '--profile_steps', '16')
    _, plain = run(str(tmp_path / 'plain'))
    assert got['scan_groups'] == 4 and got['scan_captured'] is not None
    assert os.path.exists(join(traced, 'profile', 'trace.json'))
    with open(join(traced, 'profile', 'spans.json')) as f:
        spans = json.load(f)['spans']
    for name in ('program.train.next_batch', 'program.dispatch',
                 'program.dispatch.warm_up', 'program.dispatch.capture',
                 'program.dispatch.replay', 'program.step.forward',
                 'program.step.optimizer'):
        assert name in spans, name
    assert spans['program.dispatch']['count'] == 2
    a, b = (tckpt.read_leaves(join(d, 'checkpoints', 'ckpt-2'))
            for d in (traced, plain))
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
