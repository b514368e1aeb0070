"""Data-parallel training of the PyTorch port (parallel/mesh.py and
``make_train_step(group=...)``) on the CPU: two gloo ranks spawned with
torch.multiprocessing over a file:// rendezvous in tmp_path.

For the shape model (tests/test_multidevice.py's tiny config), the joint
model and NeRF, each at the small widths of the other test_torch_* files
with f32 chains, three steps on one 64-row global batch, a fresh random
draw each step:

  * two ranks, each on its half, with the JAX package's draws (the global
    batch's, replayed into the port's draw arguments through
    ``train_draws``; each rank keeps its rows) against the JAX package's
    ``make_train_step`` on one device with the full batch: the loss
    within LOSS_RTOL, every leaf within LEAF_RTOL / LEAF_ATOL
    (tests/test_multidevice.py:63-66);
  * two ranks drawing from generators seeded alike against the port at
    one process on the full batch with a generator of that seed, within
    the same limits;
  * the controls, which must break those limits: ranks that skip the
    reduction (each steps on its own half), and ranks whose generators
    are seeded by rank (each draws its own noise instead of keeping its
    rows of the global draw);
  * with ``clipnorm`` on (the joint model): the step, which reduces and
    then clips each leaf of the global gradient, within the limits of the
    JAX step; clipping each rank's gradient before the reduction, outside.

Each check prints its reading: the worst |got - want| / (atol + rtol
|want|) over the loss and the leaves (within: <= 1).
"""

from os.path import join

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as tmp

from nerfactor_tpu.models.nerf import Model as JNerfModel
from nerfactor_tpu.models.shape import Model as JShapeModel
from nerfactor_tpu.parallel import train as jtrain
from nerfactor_tpu.utils import config as jconfigutil
from nerfactor_tpu_torch.models import get_model_class
from nerfactor_tpu_torch.parallel import mesh
from nerfactor_tpu_torch.parallel import train as ttrain
from nerfactor_tpu_torch.utils import ckpt as tckpt, config as tconfigutil
from tests import synth
from tests.test_torch_nerf import jax_draws, nerf_config, ray_batch
from tests.test_torch_nerfactor import build_scene, make_joint

LOSS_RTOL, LEAF_RTOL, LEAF_ATOL = 1e-5, 1e-4, 1e-6
N_RAYS, N_STEPS, WORLD = 64, 3, 2
GEN_SEED = 7
JOIN_TIMEOUT_S = 120


# ------ the ranks ------

class Replay:
    """The port's model with given draws of the whole batch: a data-
    parallel step takes them through ``train_draws`` and keeps its rank's
    rows; with ``rows`` set, ``apply`` puts in those rows itself (for a
    step without a group)."""

    def __init__(self, model):
        self.model = model
        self.draws, self.rows = None, None

    def train_draws(self, generator, batch, world=1):
        return self.draws

    def apply(self, params, batch, mode='train', generator=None, **kwargs):
        if self.rows is not None:
            kwargs.update({k: v[self.rows] for k, v in self.draws.items()})
        return self.model.apply(params, batch, mode=mode, **kwargs)

    def __getattr__(self, name):
        return getattr(self.model, name)


def clip_first_step(model, optimizer, mask):
    """The control of the clipping order: each rank clips its own
    gradient (Keras clipnorm, per leaf) and then the ranks average."""
    clip = optimizer.clip
    plain = ttrain.Optimizer(None, optimizer.schedule, eps=optimizer.eps)
    rank, world = mesh.rank(), mesh.world()

    def step(params, opt_state, arrays):
        leaves = tckpt.tree_leaves(params)
        live = tckpt.tree_map(lambda t: t.detach(), params)
        wrt = [t.requires_grad_() for t, m in zip(tckpt.tree_leaves(live),
                                                  mask) if m]
        draws = mesh.shard_batch(model.train_draws(None, arrays, world),
                                 rank, world)
        pred, gt, kwargs, _ = model.apply(live, arrays, mode='train',
                                          **draws)
        loss = torch.mean(model.compute_loss(live, pred, gt, **kwargs))
        got = [clip(torch.zeros_like(t) if g is None else g) for t, g in zip(
            wrt, torch.autograd.grad(loss, wrt, allow_unused=True))]
        *got, loss = mesh.all_mean(got + [loss.detach()])
        got = iter(got)
        grads = [next(got) if m else torch.zeros_like(t)
                 for t, m in zip(leaves, mask)]
        with torch.no_grad():
            steps, opt_state = plain.update(grads, opt_state)
            for p, s in zip(leaves, steps):
                p.add_(s)
        return params, opt_state, loss

    return step


def port_run(job, variant, rank=0, world=1):
    """The port's three steps from the job's parameters: the losses and
    the final leaves (numpy)."""
    config = tconfigutil.Config(tconfigutil.read_config(job['ini']))
    model = get_model_class(config.get('model'))(config, device='cpu')
    params = tckpt.params_from_jax(job['params'])
    optimizer = ttrain.build_optimizer(config)
    opt_state = optimizer.init(params)
    mask = model.trainable_mask(params) \
        if hasattr(model, 'trainable_mask') else None
    group = mesh.group() if world > 1 else None
    replay = Replay(model)
    gen = torch.Generator().manual_seed(
        GEN_SEED + (rank if variant == 'own_noise' else 0))
    if variant in ('jax_draws', 'clip_first', 'no_reduce'):
        model_ = replay
    else:
        model_ = model
    if variant == 'clip_first':
        step = clip_first_step(
            replay, optimizer, tckpt.tree_leaves(mask) if mask is not None
            else [True] * len(tckpt.tree_leaves(params)))
    else:
        step = ttrain.make_train_step(
            model_, optimizer, trainable_mask=mask,
            group=None if variant == 'no_reduce' else group)
    arrays = mesh.shard_batch(
        {k: torch.from_numpy(v) for k, v in job['batch'].items()}, rank,
        world)
    if variant == 'no_reduce':
        replay.rows = slice(rank * N_RAYS // world,
                            (rank + 1) * N_RAYS // world)
    losses = []
    for i in range(N_STEPS):
        replay.draws = {k: torch.tensor(v)
                        for k, v in job['draws'][i].items()}
        if variant == 'clip_first':
            params, opt_state, loss = step(params, opt_state, arrays)
        else:
            params, opt_state, loss = step(params, opt_state, arrays,
                                           generator=gen)
        losses.append(float(loss))
    return losses, [t.detach().numpy().copy()
                    for t in tckpt.tree_leaves(params)]


def rank_main(rank, world, init_file, jobs, out):
    torch.set_num_threads(1)
    mesh.initialize('file://' + init_file, world, rank, device='cpu',
                    timeout_s=JOIN_TIMEOUT_S)
    try:
        got = {name: {v: port_run(job, v, rank, world)
                      for v in job['variants']}
               for name, job in jobs.items()}
        if rank == 0:
            torch.save(got, out)
    finally:
        mesh.shutdown()


def run_ranks(tmp_path, jobs, world=WORLD):
    """Every variant of each of ``jobs`` on ``world`` spawned ranks; rank
    0's {job: {variant: (losses, leaves)}}."""
    out = str(tmp_path / 'rank0.pt')
    tmp.spawn(rank_main, args=(world, str(tmp_path / 'rendezvous'), jobs,
                               out), nprocs=world, join=True)
    return torch.load(out, weights_only=False)


# ------ the JAX side and the comparison ------

def jax_run(jmodel, config, jparams, batch, keys):
    optimizer = jtrain.build_optimizer(config)
    mask = jmodel.trainable_mask(jparams) \
        if hasattr(jmodel, 'trainable_mask') else None
    step = jtrain.make_train_step(jmodel, optimizer, trainable_mask=mask)
    params = jax.tree_util.tree_map(jnp.array, jparams)
    opt_state = optimizer.init(params)
    arrays = {k: jnp.asarray(v) for k, v in batch.items()}
    losses = []
    for key in keys:
        params, opt_state, loss = step(params, opt_state, arrays, key)
        losses.append(float(loss))
    return losses, [np.asarray(x) for x in jax.tree_util.tree_leaves(params)]


def worst(got, want):
    """The worst |got - want| / (atol + rtol |want|) over the losses (rtol
    LOSS_RTOL) and the leaves (LEAF_RTOL, LEAF_ATOL); within at <= 1."""
    (gl, gleaves), (wl, wleaves) = got, want
    assert len(gleaves) == len(wleaves)
    ratios = [np.max(np.abs(np.subtract(gl, wl)) / (LOSS_RTOL * np.abs(wl)))]
    for g, w in zip(gleaves, wleaves):
        assert g.shape == w.shape
        ratios.append(np.max(np.abs(g - w) / (
            LEAF_ATOL + LEAF_RTOL * np.abs(w)), initial=0.0))
    return float(max(ratios))


# ------ the three models ------

def shape_case(tmp_path_factory):
    tmp_path = tmp_path_factory.mktemp('shape')
    root = str(tmp_path / 'scene')
    synth.make_scene(root, n_train=2, n_vali=1, n_test=1, imh=8,
                     with_buffers=True, light_h=2)
    parser = jconfigutil.read_config(
        jconfigutil.resolve_config_path('shape.ini'))
    jconfigutil.apply_override(parser, ','.join([
        'data_root=%s' % root, 'data_nerf_root=%s/surf' % root, 'imh=8',
        'light_h=2', 'n_rays_per_step=%d' % N_RAYS, 'mlp_width=16',
        'mlp_depth=2', 'mlp_skip_at=1', 'bf16_big_chains=False',
        'mlp_chunk=1024']))
    ini = str(tmp_path / 'shape.ini')
    jconfigutil.write_config(parser, ini)
    config = jconfigutil.Config(parser)
    jmodel = JShapeModel(config)
    rng = np.random.RandomState(0)
    xyz = rng.randn(N_RAYS, 3).astype(np.float32)
    xyz /= np.linalg.norm(xyz, axis=1, keepdims=True)
    batch = {'rayo': 4 * np.abs(rng.randn(N_RAYS, 3)).astype(np.float32),
             'rayd': np.zeros((N_RAYS, 3), np.float32),
             'rgb': rng.rand(N_RAYS, 3).astype(np.float32),
             'alpha': np.ones((N_RAYS, 1), np.float32),
             'xyz': xyz, 'normal': xyz,
             'lvis': rng.rand(N_RAYS, jmodel.n_lights).astype(np.float32)}
    return ini, config, jmodel, jmodel.init_params(jax.random.PRNGKey(0)), \
        batch, jitter_draws(jmodel)


def jitter_draws(jmodel):
    def draws(key):
        return {'jitter_noise': np.asarray(jmodel.xyz_jitter_std
                                           * jax.random.normal(
                                               key, (N_RAYS, 3)))}
    return draws


def joint_case(scene, name, extra=''):
    _, config, jmodel, jparams = make_joint(
        scene, name, 'n_rays_per_step=%d,bf16_big_chains=False%s'
        % (N_RAYS, extra))
    ini = join(scene['out'], name, 'run.ini')
    rng = np.random.RandomState(1)
    xyz = rng.randn(N_RAYS, 3).astype(np.float32)
    xyz /= np.linalg.norm(xyz, axis=1, keepdims=True)
    batch = {'rayo': xyz + 4 * np.abs(rng.randn(N_RAYS, 3)).astype(
                 np.float32),
             'rayd': np.zeros((N_RAYS, 3), np.float32),
             'rgb': rng.rand(N_RAYS, 3).astype(np.float32),
             'alpha': np.ones((N_RAYS, 1), np.float32),
             'xyz': xyz, 'normal': xyz,
             'lvis': rng.rand(N_RAYS, jmodel.n_lights).astype(np.float32)}
    return ini, config, jmodel, jparams, batch, jitter_draws(jmodel)


def nerf_case(tmp_path_factory):
    config = nerf_config('bf16_big_chains=False', lr='5e-3',
                         noise_std='0.5')
    ini = str(tmp_path_factory.mktemp('nerf') / 'nerf.ini')
    jconfigutil.write_config(config.parser, ini)
    jmodel = JNerfModel(config)
    tmodel = get_model_class('nerf')(config, device='cpu')

    def draws(key):
        return {k: v.numpy() for k, v in jax_draws(tmodel, key,
                                                   N_RAYS).items()}
    return ini, config, jmodel, jmodel.init_params(jax.random.PRNGKey(15)), \
        ray_batch(N_RAYS, seed=3), draws


VARIANTS = ('jax_draws', 'generator', 'no_reduce', 'own_noise')
# Below the norm of every trainable gradient leaf of the joint model's
# first step here (the least, albedo_mlp's first bias, 8.2e-4)
CLIPNORM = 5e-4


@pytest.fixture(scope='module')
def cases(tmp_path_factory):
    """name -> (the case's JAX model, config, params, batch and keys, its
    job, and rank 0's results of the job's variants). One spawn of the
    two ranks runs every job."""
    scene = build_scene(tmp_path_factory, n_train=1)
    made = {'shape': shape_case(tmp_path_factory),
            'joint': joint_case(scene, 'dp'),
            'nerf': nerf_case(tmp_path_factory),
            'joint_clipnorm': joint_case(scene, 'dp_clip',
                                         ',clipnorm=%g' % CLIPNORM)}
    out = {}
    for i, (name, (ini, config, jmodel, jparams, batch, draws)) in \
            enumerate(sorted(made.items())):
        keys = [jax.random.PRNGKey(20 + 10 * i + k) for k in range(N_STEPS)]
        out[name] = {
            'jax': (jmodel, config, jparams, batch, keys),
            'job': {'ini': ini, 'params': jax.device_get(jparams),
                    'batch': batch, 'draws': [draws(k) for k in keys],
                    'variants': ('jax_draws', 'clip_first')
                    if name == 'joint_clipnorm' else VARIANTS}}
    got = run_ranks(tmp_path_factory.mktemp('ranks'),
                    {k: v['job'] for k, v in out.items()})
    for name in out:
        out[name]['ranks'] = got[name]
    return out


@pytest.mark.parametrize('name', ['joint', 'nerf', 'shape'])
def test_two_ranks_match_jax_full_batch(name, cases):
    case = cases[name]
    want = jax_run(*case['jax'])
    one_rank = port_run(case['job'], 'generator')
    got = case['ranks']
    readings = {'vs_jax': worst(got['jax_draws'], want),
                'vs_one_rank': worst(got['generator'], one_rank),
                'no_reduce_vs_jax': worst(got['no_reduce'], want),
                'own_noise_vs_one_rank': worst(got['own_noise'], one_rank)}
    print(name, readings)
    assert readings['vs_jax'] <= 1, readings
    assert readings['vs_one_rank'] <= 1, readings
    assert readings['no_reduce_vs_jax'] > 1, readings
    assert readings['own_noise_vs_one_rank'] > 1, readings


def test_clipping_after_the_reduction(cases):
    """The joint model with clipnorm CLIPNORM, which clips every leaf."""
    case = cases['joint_clipnorm']
    jmodel, config, jparams, batch, keys = case['jax']
    assert config.getfloat('clipnorm') == CLIPNORM
    got = case['ranks']
    want = jax_run(*case['jax'])
    readings = {'reduce_then_clip': worst(got['jax_draws'], want),
                'clip_then_reduce': worst(got['clip_first'], want)}
    print(readings)
    assert readings['reduce_then_clip'] <= 1, readings
    assert readings['clip_then_reduce'] > 1, readings


def test_shard_batch_layout():
    arrays = {'a': np.arange(64, dtype=np.float32).reshape(64, 1),
              'odd': np.arange(7, dtype=np.float32),
              'scalar': np.float32(3)}
    parts = [mesh.shard_batch(arrays, r, 2) for r in range(2)]
    np.testing.assert_array_equal(parts[0]['a'], arrays['a'][:32])
    np.testing.assert_array_equal(parts[1]['a'], arrays['a'][32:])
    for p in parts:
        np.testing.assert_array_equal(p['odd'], arrays['odd'])
        assert p['scalar'] == 3
    t = mesh.shard_batch({'x': torch.arange(6.)}, 2, 3)['x']
    assert torch.equal(t, torch.tensor([4., 5.]))
