"""The port's multi-step dispatch (``parallel/train.make_train_step_scan``,
on the CPU its plain loop) against the JAX package's
``make_train_step_scan`` (lax.scan over a stacked batch, step i drawing
from ``fold_in(key, i)``) on the same stacked batch, from the same
weights (``utils/ckpt.params_from_jax``), the JAX draws of each step
replayed through ``draws``:

  (a) the toy model of tests/test_train_scan.py (y = x @ w + 0.01 N(0, 1)),
      5 steps, at that test's limits: losses rtol 1e-5, leaves rtol 1e-5
      and atol 1e-7;
  (b) NeRF at tests/test_torch_nerf.py's MODEL_BASE in f32 (perturbation
      and sigma noise on), 3 steps, at tests/test_torch_nerf_trajectory.py's
      f32 limits: losses rtol 1e-5, each leaf within 1e-5 by relative norm;
  (c) the joint model at width 16 (tests/test_torch_train.py's scene and
      rays) in f32, its smoothness jitter replayed, 3 steps: losses rtol
      1e-5, each leaf within JOINT_LEAF_TOL by relative norm;
  (d) the optimizer's device-side step count and learning rate against the
      JAX optimizer's jitted arithmetic over counts 0-50 with decay on, and
      ``Optimizer.update`` on tensors of the ``meta`` device, which hold no
      values: a read of the count back to the host would raise there.

Each port run is also held against the port's own ``make_train_step``
taken step by step: the same bits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nerfactor_tpu.models.nerf import Model as JNerf
from nerfactor_tpu.parallel import train as jtrain
from nerfactor_tpu.utils import ckpt as jckpt, config as configutil
from nerfactor_tpu_torch.models.nerf import Model as TNerf
from nerfactor_tpu_torch.models.nerfactor import Model as TModel
from nerfactor_tpu_torch.parallel import train as ttrain
from nerfactor_tpu_torch.utils import ckpt as tckpt
from tests.test_torch_nerf import jax_draws, nerf_config, ray_batch, rel_norm
from tests.test_torch_nerfactor import build_scene, make_joint
from tests.test_torch_train import N_RAYS
from tests.test_train_scan import ToyModel as JToy

# (c): tests/test_torch_nerf_trajectory.py's f32 limit. Readings: leaves
# 7.2e-7 by relative norm, losses 1.2e-7 relative (the f32 sums in another
# order, carried by Adam's normalised step); (b) reads 6.1e-6 and 1.2e-7.
JOINT_LEAF_TOL = 1e-5


class TToy:
    """The port's counterpart of tests/test_train_scan.py's ToyModel: its
    noise is the ``jitter_noise`` draw, (1,)."""

    def __init__(self):
        self.config = JToy().config

    def apply(self, params, batch, mode='train', generator=None,
              jitter_noise=None):
        pred = {'y': batch['x'] @ params['w'] + jitter_noise}
        return pred, {'y': batch['y']}, {}, {}

    def compute_loss(self, params, pred, gt):
        return torch.mean(torch.square(pred['y'] - gt['y']), dim=-1)


def stacked_t(batches):
    return {k: torch.from_numpy(np.stack([b[k] for b in batches]))
            for k in batches[0]}


def stacked_draws(draws):
    return {k: torch.stack([d[k] for d in draws]) for k in draws[0]}


def step_by_step(tstep, params, opt_state, batches, draws):
    """The port's make_train_step over ``batches`` with ``draws``."""
    losses = []
    for b, d in zip(batches, draws):
        params, opt_state, loss = tstep(
            params, opt_state, {k: torch.from_numpy(v) for k, v in b.items()},
            **({} if d is None else {'jitter_noise': d['jitter_noise']}))
        losses.append(loss)
    return torch.stack(losses)


def assert_same_bits(a, b):
    for x, y in zip(tckpt.tree_leaves(a), tckpt.tree_leaves(b)):
        assert torch.equal(x, y)


def test_toy_scan_matches_jax():
    jmodel, tmodel, n = JToy(), TToy(), 5
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    jopt = jtrain.build_optimizer(jmodel.config)
    rng = np.random.RandomState(0)
    w_true = rng.randn(4, 2).astype(np.float32)
    x = rng.randn(n, 16, 4).astype(np.float32)
    batches = [{'x': x[i], 'y': x[i] @ w_true} for i in range(n)]
    key = jax.random.PRNGKey(3)
    jstep = jtrain.make_train_step_scan(jmodel, jopt, n_steps=n)
    jp, _, jlosses = jstep(jax.tree_util.tree_map(jnp.array, jparams),
                           jopt.init(jparams),
                           {k: jnp.stack([b[k] for b in batches])
                            for k in batches[0]}, key)
    # The toy's draw, as its apply makes it from step i's key
    draws = [{'jitter_noise': torch.from_numpy(np.array(
        0.01 * jax.random.normal(jax.random.fold_in(key, i), (1,))))}
        for i in range(n)]
    topt = ttrain.build_optimizer(tmodel.config)
    tp = tckpt.params_from_jax(jparams)
    to = topt.init(tp)
    tscan = ttrain.make_train_step_scan(tmodel, topt, n_steps=n)
    tp, to, tlosses = tscan(tp, to, stacked_t(batches),
                            draws=stacked_draws(draws))
    np.testing.assert_allclose(tlosses.numpy(), np.asarray(jlosses),
                               rtol=1e-5)
    np.testing.assert_allclose(tp['w'].numpy(), np.asarray(jp['w']),
                               rtol=1e-5, atol=1e-7)
    assert int(to[0].count) == n
    assert tlosses[-1] < tlosses[0]
    # The loop is make_train_step's, step by step
    sp = tckpt.params_from_jax(jparams)
    so = topt.init(sp)
    slosses = step_by_step(ttrain.make_train_step(tmodel, topt), sp, so,
                           batches, draws)
    assert torch.equal(slosses, tlosses)
    assert_same_bits((sp, so), (tp, to))


class Replay:
    """The port's NeRF model with step i's draws given as keyword
    arguments (``make_train_step_scan``'s ``draws``)."""

    def __init__(self, model):
        self.model = model

    def apply(self, params, arrays, mode='train', generator=None,
              jitter_noise=None, **draws):
        return self.model.apply(params, arrays, mode=mode, **draws)

    def compute_loss(self, *args, **kwargs):
        return self.model.compute_loss(*args, **kwargs)


def test_nerf_scan_matches_jax(tmp_path):
    """From one JAX-written ckpt-1 (the state after one JAX step, as
    tests/test_torch_nerf_trajectory.py starts: Adam's first step from a
    zero state is lr g / (|g| + eps), where the sign of a gradient near
    zero decides the leaf)."""
    n = 3
    config = nerf_config('bf16_big_chains=False', lr='5e-3', noise_std='0.5')
    jmodel = JNerf(config)
    jparams = jmodel.init_params(jax.random.PRNGKey(15))
    jopt = jtrain.build_optimizer(config)
    batches = [ray_batch(64, seed=60 + i) for i in range(n + 1)]
    jparams, jopt_state, _ = jtrain.make_train_step(jmodel, jopt)(
        jparams, jopt.init(jparams),
        {k: jnp.asarray(v) for k, v in batches[0].items()},
        jax.random.PRNGKey(69))
    ckptdir = str(tmp_path / 'checkpoints')
    jckpt.save_pytree({'params': jparams, 'opt_state': jopt_state},
                      ckptdir + '/ckpt-1')
    tmodel = TNerf(config, device='cpu')
    topt = ttrain.build_optimizer(config)
    template = tmodel.init_params(torch.Generator().manual_seed(0))
    state = tckpt.CheckpointManager(ckptdir).restore(
        {'params': template, 'opt_state': topt.init(template)})
    tp, to = state['params'], state['opt_state']
    batches = batches[1:]
    key = jax.random.PRNGKey(70)
    jstep = jtrain.make_train_step_scan(jmodel, jopt, n_steps=n)
    jp, jo, jlosses = jstep(jparams, jopt_state,
                            {k: jnp.stack([b[k] for b in batches])
                             for k in batches[0]}, key)
    draws = stacked_draws([jax_draws(tmodel, jax.random.fold_in(key, i), 64)
                           for i in range(n)])
    tscan = ttrain.make_train_step_scan(Replay(tmodel), topt, n_steps=n)
    tp, to, tlosses = tscan(tp, to, stacked_t(batches), draws=draws)
    np.testing.assert_allclose(tlosses.numpy(), np.asarray(jlosses),
                               rtol=1e-5)
    got, want = tckpt.tree_leaves(tp), jax.tree_util.tree_leaves(jp)
    assert len(got) == len(want)
    errs = [rel_norm(g.numpy(), np.asarray(w)) for g, w in zip(got, want)]
    assert max(errs) <= 1e-5, errs
    assert int(to[0].count) == int(jo[-1].count) == n + 1


@pytest.fixture(scope='module')
def scene(tmp_path_factory):
    return build_scene(tmp_path_factory, n_train=3)


def test_joint_scan_matches_jax(scene):
    n = 3
    _, config, jmodel, jparams = make_joint(
        scene, 'scan', 'n_rays_per_step=%d,bf16_big_chains=False' % N_RAYS)
    from nerfactor_tpu.datasets.nerf_shape import Dataset as JDataset
    batches = [{k: np.asarray(b[k], np.float32) for k in JDataset.array_keys}
               for b in JDataset(config, 'train').build_pipeline(prefetch=0)]
    assert len(batches) == n
    jopt = jtrain.build_optimizer(config)
    mask = jmodel.trainable_mask(jparams)
    key = jax.random.PRNGKey(9)
    jstep = jtrain.make_train_step_scan(jmodel, jopt, trainable_mask=mask,
                                        n_steps=n)
    jp, jo, jlosses = jstep(jax.tree_util.tree_map(jnp.array, jparams),
                            jopt.init(jparams),
                            {k: jnp.stack([b[k] for b in batches])
                             for k in batches[0]}, key)
    std = config.getfloat('xyz_jitter_std')
    draws = [{'jitter_noise': torch.from_numpy(np.array(
        std * jax.random.normal(jax.random.fold_in(key, i),
                                batches[i]['xyz'].shape)))}
             for i in range(n)]
    tmodel = TModel(config, device='cpu')
    topt = ttrain.build_optimizer(config)
    tp = tckpt.params_from_jax(jparams)
    to = topt.init(tp)
    tmask = tmodel.trainable_mask(tp)
    tscan = ttrain.make_train_step_scan(tmodel, topt, trainable_mask=tmask,
                                        n_steps=n)
    tp, to, tlosses = tscan(tp, to, stacked_t(batches),
                            draws=stacked_draws(draws))
    np.testing.assert_allclose(tlosses.numpy(), np.asarray(jlosses),
                               rtol=1e-5)
    got, want = tckpt.tree_leaves(tp), jax.tree_util.tree_leaves(jp)
    assert len(got) == len(want)
    errs = [rel_norm(g.numpy(), np.asarray(w)) for g, w in zip(got, want)]
    assert max(errs) <= JOINT_LEAF_TOL, max(errs)
    assert int(to[0].count) == int(jo[-1].count) == n
    sp = tckpt.params_from_jax(jparams)
    so = topt.init(sp)
    slosses = step_by_step(ttrain.make_train_step(tmodel, topt, tmask), sp,
                           so, batches, draws)
    assert torch.equal(slosses, tlosses)
    assert_same_bits((sp, so), (tp, to))


def _opt_config():
    parser = configutil.read_config(
        configutil.resolve_config_path('nerfactor.ini'))
    configutil.apply_override(parser, 'lr=5e-3,lr_decay_steps=10,'
                              'lr_decay_rate=0.1')
    return configutil.Config(parser)


def ulps(a, b):
    """Distance in units in the last place of two f32 arrays."""
    ia = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    ib = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(ia - ib)


# (d): f32 ulps between the port's schedule / lr_t and the JAX
# optimizer's on the CPU. Each package's f32 pow rounds its own way (XLA's
# CPU pow and torch's differ by up to 15 ulps at these counts; numpy's f32
# pow, which the port's host arithmetic used before the count moved to the
# device, read 15 against the same JAX values). Readings over counts 0-50:
# schedule 9 of 51 apart, at most 15 ulps; lr_t 11 apart, at most 13.
LR_ULPS = 16


def test_optimizer_count_and_lr_on_the_device_match_jax():
    """The learning rate of each count 0-50, lr * sqrt(1 - b2^t) / (1 -
    b1^t) at t = count + 1 with lr = exponential_decay(count), computed by
    the port from an int32 count tensor against the JAX optimizer's own
    arithmetic (``_tf_adam_amsgrad`` over ``optax.exponential_decay``,
    jitted): not bit for bit, within LR_ULPS, and in f32. Then 50 updates:
    the count is the JAX optimizer's."""
    config = _opt_config()
    topt = ttrain.build_optimizer(config)
    lr, steps, rate = (config.getfloat('lr'), config.getint('lr_decay_steps'),
                       config.getfloat('lr_decay_rate'))
    schedule = optax.exponential_decay(init_value=lr, transition_steps=steps,
                                       decay_rate=rate, staircase=False)

    @jax.jit
    def jax_lr(count):
        t = (count + 1).astype(jnp.float32)
        return schedule(count), schedule(count) * jnp.sqrt(
            1.0 - 0.999 ** t) / (1.0 - 0.9 ** t)

    counts = np.arange(51, dtype=np.int32)
    want_lr, want_lr_t = (np.asarray(a) for a in jax_lr(jnp.asarray(counts)))
    got_lr = topt.schedule(torch.from_numpy(counts)).numpy()
    got_lr_t = topt.lr_t(torch.from_numpy(counts)).numpy()
    assert got_lr.dtype == got_lr_t.dtype == np.float32
    assert got_lr[0] == want_lr[0] == np.float32(lr)
    assert ulps(got_lr, want_lr).max() <= LR_ULPS
    assert ulps(got_lr_t, want_lr_t).max() <= LR_ULPS
    # the count across updates, on the params' device
    rng = np.random.RandomState(2)
    params = {'w': rng.randn(3, 2).astype(np.float32)}
    jopt = jtrain.build_optimizer(config)
    jstate = jopt.init(params)
    tp = tckpt.params_from_jax(params)
    tstate = topt.init(tp)
    assert tstate[0].count.dtype == torch.int32
    for _ in range(50):
        g = {'w': rng.randn(3, 2).astype(np.float32)}
        _, jstate = jopt.update(g, jstate, params)
        _, tstate = topt.update(tckpt.tree_leaves(
            tckpt.params_from_jax(g)), tstate)
    assert int(tstate[0].count) == int(jax.tree_util.tree_leaves(
        jstate)[0]) == 50


@pytest.mark.parametrize('clip', ['none', 'clipnorm', 'clipvalue'])
def test_optimizer_update_reads_nothing_back(clip):
    """Optimizer.update on tensors of the meta device (shapes, no values):
    any read of a value back to the host (``int(count)``, ``.item()``)
    raises there, so this shows the update, the learning rate and the
    count's increment stay on the device, as a CUDA graph needs."""
    parser = configutil.read_config(
        configutil.resolve_config_path('nerfactor.ini'))
    configutil.apply_override(parser, 'lr=5e-3,lr_decay_steps=10,'
                              'lr_decay_rate=0.1,' + {
                                  'none': 'clipnorm=-1,clipvalue=-1',
                                  'clipnorm': 'clipnorm=0.5,clipvalue=-1',
                                  'clipvalue': 'clipnorm=-1,clipvalue=0.01',
                              }[clip])
    topt = ttrain.build_optimizer(configutil.Config(parser))
    params = {'a': torch.empty(4, 3, device='meta'),
              'b': [torch.empty(3, device='meta')]}
    state = topt.init(params)
    assert state[0].count.device.type == 'meta'
    grads = [torch.empty_like(t) for t in tckpt.tree_leaves(params)]
    steps, state = topt.update(grads, state)
    assert all(s.device.type == 'meta' and s.shape == t.shape
               for s, t in zip(steps, tckpt.tree_leaves(params)))
    with pytest.raises(Exception):
        int(state[0].count)  # the read the update does not make


def test_every_launch_counter_is_registered():
    """Every kernel wrapper's launch counter (an attribute ending in
    ``launches``) is registered in ``kernel_lib.COUNTERS``, which a CUDA
    graph of make_train_step_scan adds its launches to at each replay: a
    counter left out would count a graph's kernels at capture and never
    in a replay. ``add_launches`` moves the counters it is given."""
    from nerfactor_tpu_torch.ops import (dot_probe, fused_mlp, fused_nerf,
                                         fused_rusink, kernel_lib)
    found = {(fn, attr)
             for mod in (dot_probe, fused_mlp, fused_nerf, fused_rusink)
             for fn in vars(mod).values() if callable(fn)
             for attr in getattr(fn, '__dict__', {})
             if attr.endswith('launches')}
    assert found and found == set(kernel_lib.COUNTERS)
    assert len(kernel_lib.COUNTERS) == len(found)
    key = (fused_nerf.nerf_kernel_bwd, 'launches')
    before = kernel_lib.launch_counts()
    kernel_lib.add_launches({key: 3})
    after = kernel_lib.launch_counts()
    kernel_lib.add_launches({key: -3})
    assert after[key] == before[key] + 3
    assert {k: v for k, v in after.items() if k != key} == \
        {k: v for k, v in before.items() if k != key}


def test_graph_refuses_leaves_off_its_device():
    """The graph of make_train_step_scan raises before it captures when a
    leaf of the parameters or the optimizer state lies off its device (an
    optimizer count on the host would be baked into the graph as a
    constant, and its increment not captured)."""
    topt = ttrain.build_optimizer(_opt_config())
    params = {'w': torch.zeros(3, 2)}
    with pytest.raises(ValueError, match='leaves lie on'):
        ttrain._GraphSteps(None, 2, params, topt.init(params),
                           {'x': torch.zeros(2, 4)}, None, None,
                           torch.device('cuda'))
