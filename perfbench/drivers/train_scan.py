"""Training under the multi-step dispatch: ``parallel/train.py``'s
``make_train_step_scan`` (on the card one CUDA graph launch a group of
``scan_steps`` steps), driven as ``trainvali`` drives it.

Each group is ``scan_steps`` x ``n_rays_per_step`` rays drawn from the
seed out of a pool of ``pool_rays`` rays (the cached training set),
gathered on the host into one of two pinned buffers, and handed to the
step with the group's random draws (made on the card from the seed), so
that the reference gets the same. The host waits for a buffer's last
copy to finish before it gathers into it again, so it runs at most two
groups ahead of the card.

Set-up runs the first two groups, on rows that all differ: the first
eagerly (on the card the graph's warm-up) and the second through the
capture and the first replay, the window's own call, and keeps the state
each left. The window then replays groups until ``--seconds`` have
passed, with a CUDA event after each. The reference follows each of the
two groups through all its steps: the first from the seed, the second
from the program's state after the first; what each group left is
compared with what the reference's steps leave.
"""

import time
from types import SimpleNamespace

import numpy as np
import torch

from perfbench import harness, weights
from perfbench.reference import plain


class Feed:
    """The host side of the data pipeline: the pool, two pinned staging
    buffers, and the groups' draws."""

    def __init__(self, run, ref_mod, n_steps, n_rays):
        self.run, self.ref_mod = run, ref_mod
        self.n_steps, self.n_rays = n_steps, n_rays
        self.rng = np.random.default_rng(run.seed)
        self.pool = ref_mod.make_rays(run.config, self.rng,
                                      run.traffic['pool_rays'])
        pin = run.device.type == 'cuda'
        self.buffers = [{k: torch.empty((n_steps, n_rays) + v.shape[1:],
                                        dtype=torch.float32, pin_memory=pin)
                         for k, v in self.pool.items()} for _ in range(2)]
        self.done = [None, None]
        self.gen = torch.Generator(device=run.device).manual_seed(
            run.seed + 1)
        self.turn = 0

    def rows(self):
        size = len(next(iter(self.pool.values())))
        return self.rng.integers(0, size, self.n_steps * self.n_rays)

    def next(self, idx=None):
        """(stacked batch in a pinned buffer, draws, the buffer's slot):
        the rows ``idx`` (drawn from the seed if None)."""
        slot = self.turn % 2
        self.turn += 1
        if self.done[slot] is not None:
            with harness.span('bench.wait_for_buffer'):
                self.done[slot].synchronize()
        idx = self.rows() if idx is None else idx
        buf = self.buffers[slot]
        with harness.span('bench.gather_batch'):
            for k, v in self.pool.items():
                np.take(v, idx, axis=0, out=buf[k].numpy().reshape(
                    (-1,) + v.shape[1:]))
        draws = self.ref_mod.make_draws(self.run.config, self.gen,
                                        self.n_steps, self.n_rays,
                                        self.run.device)
        return buf, draws, slot

    def mark(self, slot):
        """Records that the call just issued reads the buffer ``slot``."""
        if self.run.device.type == 'cuda':
            ev = torch.cuda.Event()
            ev.record()
            self.done[slot] = ev


def _snapshot(params, opt_state):
    adam = opt_state[0]
    return {'params': [t.detach().clone() for t in weights.leaves(params)],
            'count': int(adam.count),
            'm': [t.clone() for t in weights.leaves(adam.m)],
            'v': [t.clone() for t in weights.leaves(adam.v)],
            'vhat': [t.clone() for t in weights.leaves(adam.vhat)]}


def setup(run):
    from nerfactor_tpu_torch.parallel.train import (
        build_optimizer, make_train_step_scan)
    cfg = run.config
    s = SimpleNamespace()
    s.run = run
    s.ref_mod = harness.load_module('reference', run.config_name)
    s.model = harness.build_model(run)
    v = cfg['values']
    s.n_steps, s.n_rays = v['scan_steps'], v['n_rays_per_step']
    s.params = weights.make(s.ref_mod.param_tree(cfg), run.seed, run.device)
    optimizer = build_optimizer(s.model.config)
    s.opt_state = optimizer.init(s.params)
    mask = s.model.trainable_mask(s.params) \
        if hasattr(s.model, 'trainable_mask') else None
    s.steps = make_train_step_scan(s.model, optimizer, trainable_mask=mask,
                                   n_steps=s.n_steps)
    s.gen = torch.Generator(device=run.device).manual_seed(run.seed + 2)
    s.feed = Feed(run, s.ref_mod, s.n_steps, s.n_rays)
    s.groups = []
    size = len(next(iter(s.feed.pool.values())))
    perm = s.feed.rng.permutation(size)
    per = s.n_steps * s.n_rays
    start = _snapshot(s.params, s.opt_state)
    for g in range(run.traffic['check_groups']):
        idx = perm[g * per:(g + 1) * per]
        buf, draws, slot = s.feed.next(idx)
        _, _, losses = s.steps(s.params, s.opt_state, buf, generator=s.gen,
                               draws=draws)
        s.feed.mark(slot)
        end = _snapshot(s.params, s.opt_state)
        s.groups.append({'idx': idx, 'draws': draws, 'losses': losses,
                         'start': start, 'end': end})
        start = end
    harness.sync(run.device)
    return s


def _call(s, spans=None):
    buf, draws, slot = s.feed.next()
    with harness.span('program.train_steps'):
        t0 = time.perf_counter()
        _, _, losses = s.steps(s.params, s.opt_state, buf, generator=s.gen,
                               draws=draws)
        if spans is not None:
            spans.append(time.perf_counter() - t0)
    s.feed.mark(slot)
    return losses


def window(s, seconds):
    from nerfactor_tpu_torch.ops import kernel_lib
    on_card = s.run.device.type == 'cuda'
    before = harness.launches(kernel_lib)
    events, losses, issue = [], [], []
    if on_card:
        start = torch.cuda.Event(enable_timing=True)
        start.record()
    t0 = time.perf_counter()
    while True:
        losses.append(_call(s, issue))
        if on_card:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append(ev)
        if time.perf_counter() - t0 >= seconds:
            break
    harness.sync(s.run.device)
    elapsed = time.perf_counter() - t0
    groups = len(losses)
    steps = groups * s.n_steps
    if on_card:
        ms = [a.elapsed_time(b) for a, b in zip([start] + events[:-1],
                                                events)]
    else:
        ms = [1e3 * elapsed / groups] * groups
    allloss = torch.cat(losses)
    failed = int((~torch.isfinite(allloss)).sum())
    return {
        'attempted': steps, 'failed': failed,
        'metrics': {
            'train_rays_per_s': steps * s.n_rays / elapsed,
            'train_step_ms_p95': float(np.percentile(ms, 95)) / s.n_steps},
        'layer': {'steps': steps, 'window_s': elapsed,
                  'issue_s': sum(issue), 'step_ms': [m / s.n_steps for m in ms],
                  'launches': harness.launches(kernel_lib) - before}}


def trace_warm(s):
    """Before the traced work, inside the profiler: ``trace_warm_groups``
    groups (the first replays under the profiler leave the card idle for
    3-22 ms each)."""
    for _ in range(s.run.traffic['trace_warm_groups']):
        _call(s)


def trace_work(s):
    """One traced unit of work: ``trace_groups`` groups; returns the steps
    it ran."""
    n = s.run.traffic['trace_groups']
    for _ in range(n):
        _call(s)
    return {'steps': n * s.n_steps}


def release(s):
    del s.steps, s.params, s.opt_state, s.model, s.feed.buffers
    harness.free(s.run.device)


# ------ correctness ------

def follow(s, ref, start, group, variant):
    """The reference's steps of a whole group from the state ``start``:
    its losses, its first step's gradients, and the parameters, Adam's
    first moment and the count that it leaves. ``variant``: None (f32),
    'low' (the big chains' operands in fp8, the heads' in TF32: the
    control), 'half_batch' (the loss's mean over the first half of the
    rays: a fault)."""
    tree = s.ref_mod.param_tree(s.run.config)
    keys = [k for k in sorted(tree) for _ in weights.leaves(tree[k])]
    train = [s.ref_mod.trainable(k) for k in keys]
    params = [t.clone() for t in start['params']]
    m, v, vh = ([t.clone() for t in start[k]] for k in ('m', 'v', 'vhat'))
    batch = {k: torch.as_tensor(a[group['idx']]).reshape(
        (s.n_steps, s.n_rays) + a.shape[1:]).to(s.run.device)
        for k, a in s.feed.pool.items()}
    big = 'fp8' if variant == 'low' else None
    heads = 'tf32' if variant == 'low' else None
    losses, first = [], None
    for i in range(s.n_steps):
        live = [p.detach().requires_grad_(t) for p, t in zip(params, train)]
        per_ray = ref.per_ray_loss(
            _unflatten(tree, live), {k: b[i] for k, b in batch.items()},
            {k: d[i] for k, d in group['draws'].items()}, big=big,
            heads=heads)
        if variant == 'half_batch':
            per_ray = per_ray[:per_ray.shape[0] // 2]
        loss = torch.mean(per_ray)
        wrt = [p for p, t in zip(live, train) if t]
        got = iter(torch.autograd.grad(loss, wrt, allow_unused=True))
        grads = []
        for p, t in zip(live, train):
            g = next(got) if t else None
            grads.append(torch.zeros_like(p) if g is None else g.detach())
        first = grads if first is None else first
        params, (m, v, vh) = _adam(params, grads, (m, v, vh),
                                   ref.lr(start['count'] + i))
        losses.append(float(loss.detach()))
    return {'losses': losses, 'first': first, 'params': params, 'm': m,
            'count': start['count'] + s.n_steps}


def _adam(params, grads, state, lr_t):
    with torch.no_grad():
        return plain.adam_amsgrad([p.detach() for p in params], grads, state,
                                  lr_t)


def _paths(tree, pre=''):
    """The leaves' names, in the leaves' order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _paths(tree[k], pre + k)]
    if isinstance(tree, list):
        return [p for i, t in enumerate(tree)
                for p in _paths(t, '%s.%d.' % (pre, i))]
    return [pre]


def _unflatten(tree, flat):
    it = iter(flat)

    def build(t):
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}
            return {k: built[k] for k in t}
        if isinstance(t, list):
            return [build(x) for x in t]
        return next(it)
    return build(tree)


def _state_gaps(start, want, got):
    """By leaf, against the reference's norm of that leaf or of the median
    leaf, whichever is larger: the gap between the norms of the
    parameters' change over the group (``step``), and the norm of the
    difference of Adam's first moments at the group's end, over the
    norm of what the reference's steps added to it (``moment``: (1 -
    b1) x the group's gradients, each weighted by b1 to the number of
    later steps). Leaves whose reference gradient at the group's first
    step is under a thousandth of the median leaf's are left out (they
    move by round-off alone): ``keep``."""
    def norms(ts):
        return [float(torch.linalg.norm(t)) for t in ts]
    decay = plain.B1 ** (want['count'] - start['count'])
    gr = norms(want['first'])
    med_g = float(np.median([x for x in gr if x > 0]))
    keep = [i for i, x in enumerate(gr) if x >= 1e-3 * med_g]
    sr = norms(b - a for a, b in zip(start['params'], want['params']))
    sp = norms(b - a for a, b in zip(start['params'], got['params']))
    mr = norms(b - decay * a for a, b in zip(start['m'], want['m']))
    md = norms(a - b for a, b in zip(got['m'], want['m']))
    med_s = float(np.median([sr[i] for i in keep]))
    med_m = float(np.median([mr[i] for i in keep]))
    return {'keep': keep,
            'step': [abs(sp[i] - sr[i]) / max(sr[i], med_s) for i in keep],
            'moment': [md[i] / max(mr[i], med_m) for i in keep]}


def readings(s, variant=None):
    """The check's numbers, the program's (``variant`` None) or those of
    the reference's ``variant`` put in the program's place, against the
    reference, which follows each of set-up's groups through all its
    steps: the first from the seed (the eager warm-up), the second, the
    capture and first replay, from the program's state after the first.
    ``loss_gap``: the worst relative loss gap of the first
    ``check_steps`` steps of each group. Of the state each group left
    (:func:`_state_gaps`), over both groups: ``moment_diff_median``, the
    larger of the groups' median leaves of the first moment's difference;
    ``step_gap``, the worst leaf of the gap between the norms of the
    parameters' change; ``count_gap``, how far Adam's count is from
    having advanced a step a step. Which are compared is the cell's
    ``checks/<workload>.json``; the rest is for the look, the second
    group's alone under ``replay``."""
    k = min(s.run.traffic['check_steps'], s.n_steps)
    ref = s.ref_mod.Reference(s.run.config, s.run.device)
    loss_gaps, by_group = [], []
    for g in s.groups:
        want = follow(s, ref, g['start'], g, None)
        if variant is None:
            got = {'losses': g['losses'].tolist(),
                   'params': g['end']['params'], 'm': g['end']['m'],
                   'count': g['end']['count']}
        else:
            got = follow(s, ref, g['start'], g, variant)
        gaps = [abs(a - b) / abs(b) for a, b in zip(got['losses'][:k],
                                                   want['losses'][:k])]
        loss_gaps += gaps
        st = _state_gaps(g['start'], want, got)
        by_group.append({
            'loss_gap': harness.worst(gaps),
            'step_gap': harness.worst(st['step']),
            'step_gap_median': float(np.median(st['step'])),
            'moment_diff': harness.worst(st['moment']),
            'moment_diff_median': float(np.median(st['moment'])),
            'count_gap': float(abs(got['count'] - want['count'])),
            'moment_by_leaf': st['moment'], 'step_by_leaf': st['step'],
            'kept': st['keep']})
    return {'loss_gap': harness.worst(loss_gaps),
            'moment_diff_median': harness.worst(
                b['moment_diff_median'] for b in by_group),
            'step_gap': harness.worst(b['step_gap'] for b in by_group),
            'count_gap': max(b['count_gap'] for b in by_group),
            'replay': {key: val for key, val in by_group[-1].items()
                       if not isinstance(val, list)},
            'by_group': by_group, 'loss_gaps': loss_gaps,
            'leaves': _paths(s.ref_mod.param_tree(s.run.config))}
