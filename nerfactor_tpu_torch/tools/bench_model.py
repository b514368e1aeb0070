"""The models and random batches the step and relight tools run on
(counterpart of ``__graft_entry__._make_model_and_batch`` and
tools/step_time.py's ``_make_nerf_model_and_batch``), at bench.py's
settings:

  * ``nerfactor``: nerfactor.ini with shape_mode=scratch, 1024 rays a
    step x 512 lights (light_h 16), 128 x 4 MLPs, mlp_chunk 65536, no
    light probes; the BRDF prior restored from a brdf.ini checkpoint of
    seeded weights written under a temporary directory (the JAX harness
    initialises a missing prior afresh, the port restores it);
  * ``nerf``: nerf.ini (8 x 256 trunk, 64 + 128 samples), near 2, far 6.

An override of TINY narrows the joint model's or NeRF's MLPs to 16 x 2
(the tests' size; the BRDF prior keeps brdf.ini's). The batch is the
JAX harness's: points on the unit sphere with their normals, cameras 4
units out, random colours and visibilities (NeRF: rays from (0, 0, 4) in
random directions).
"""

import tempfile
from os.path import join

import numpy as np
import torch

from nerfactor_tpu_torch.models import get_model_class, networks
from nerfactor_tpu_torch.ops import encoding
from nerfactor_tpu_torch.ops import fused_mlp as fm
from nerfactor_tpu_torch.ops import fused_nerf as fn
from nerfactor_tpu_torch.ops import fused_rusink as fr
from nerfactor_tpu_torch.parallel.train import (
    build_optimizer, make_train_step, make_train_step_scan)
from nerfactor_tpu_torch.utils import ckpt as ckptutil, config as configutil

TINY = 'mlp_width=16,mlp_depth=2,mlp_skip_at=1'


def _config(ini, override):
    parser = configutil.read_config(configutil.resolve_config_path(ini))
    configutil.apply_override(parser, override)
    return parser


def write_brdf_prior(root, generator, n_identities=8):
    """A brdf.ini experiment under ``root`` with a checkpoint of seeded
    weights (the prior's MLP, head and latent codes); returns the path
    the joint model's ``brdf_model_ckpt`` names."""
    parser = _config('brdf.ini', '')
    cb = configutil.Config(parser)
    exp = join(root, 'merl', 'lr1e-2')
    configutil.write_config(parser, exp + '.ini')
    in_dim = cb.getint('z_dim') + encoding.embed_dims(3, cb.getint('n_freqs'))
    mlp = networks.MLPSpec(in_dim, [cb.getint('mlp_width')]
                           * cb.getint('mlp_depth'), 'relu',
                           [cb.getint('mlp_skip_at')])
    head = networks.MLPSpec(mlp.out_dim, [1], 'softplus')
    ckpt = join(exp, 'checkpoints', 'ckpt-50')
    ckptutil.save_pytree({'params': {
        'brdf_mlp': mlp.init(generator), 'brdf_out': head.init(generator),
        'latent_code': networks.init_latent_code(
            generator, n_identities, cb.getint('z_dim'), std=0.5)}}, ckpt)
    return ckpt


def make(model_name, device, n_rays=1024, light_h=16, override='', seed=0):
    """(model, params, batch of NumPy arrays) on ``device``; the weights
    from ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    rng = np.random.RandomState(0)
    extra = [override] if override else []
    if model_name == 'nerf':
        parser = _config('nerf.ini', ','.join(
            ['n_rays_per_step=%d' % n_rays, 'near=2', 'far=6'] + extra))
        model = get_model_class('nerf')(configutil.Config(parser),
                                        device=device)
        rayd = rng.randn(n_rays, 3).astype(np.float32)
        rayd /= np.linalg.norm(rayd, axis=1, keepdims=True)
        batch = {'rayo': np.tile(np.float32([[0, 0, 4]]), (n_rays, 1)),
                 'rayd': rayd, 'rgb': rng.rand(n_rays, 3).astype(np.float32)}
        return model, model.init_params(gen), batch
    if model_name != 'nerfactor':
        raise ValueError("model: nerfactor or nerf, not %r" % model_name)
    with tempfile.TemporaryDirectory(prefix='bench_model_') as root:
        parser = _config('nerfactor.ini', ','.join([
            'shape_mode=scratch',
            'brdf_model_ckpt=' + write_brdf_prior(root, gen),
            'test_envmap_dir=', 'light_h=%d' % light_h,
            'n_rays_per_step=%d' % n_rays, 'mlp_chunk=65536'] + extra))
        model = get_model_class('nerfactor')(configutil.Config(parser),
                                             device=device)
        params = model.init_params(gen)
    xyz = rng.randn(n_rays, 3).astype(np.float32)
    xyz /= np.linalg.norm(xyz, axis=1, keepdims=True)
    batch = {'rayo': xyz + np.float32(4) * np.abs(
                 rng.randn(n_rays, 3)).astype(np.float32),
             'rayd': np.zeros((n_rays, 3), np.float32),
             'rgb': rng.rand(n_rays, 3).astype(np.float32),
             'alpha': np.ones((n_rays, 1), np.float32),
             'xyz': xyz, 'normal': xyz,
             'lvis': rng.rand(n_rays, model.n_lights).astype(np.float32)}
    return model, params, batch


# The training steps' kernels: each wrapper, its counter, and a regular
# expression its kernels' names in a profiler window match (the main
# kernel of each launch: the CUDA-core or the tensor-core one)
KERNELS = {'K1-fwd': (fm.chain_kernel, r'nfk::chain_fwd'),
           'K1-bwd': (fm.chain_kernel_bwd, r'nfk::chain_bwd'),
           'K2-fwd': (fr.rusink_kernel, r'nfk::rusink_chain_fwd'),
           'K2-bwd': (fr.rusink_kernel_bwd, r'nfk::rusink_chain_bwd'),
           'K3-fwd': (fn.nerf_kernel, r'nfk::nerf_fwd'),
           'K3-bwd': (fn.nerf_kernel_bwd, r'nfk::nerf_bwd')}


def launches():
    """Each kernel's launches so far, and its tensor-core launches
    ('<name> tc') where it counts them."""
    out = {}
    for name, (f, _) in KERNELS.items():
        out[name] = f.launches
        if hasattr(f, 'tc_launches'):
            out[name + ' tc'] = f.tc_launches
    return out


def stepper(model, params, batch, device, group=None, seed=1, scan=0):
    """``run() -> loss``: one ``make_train_step`` step (the config's
    optimizer, the model's trainable mask, the process ``group`` if any)
    on ``batch``, updating ``params`` in place; the train draws from a
    generator on ``device`` seeded ``seed``. With ``scan`` > 0, one call of
    ``make_train_step_scan`` instead: ``scan`` steps on the batch repeated
    (the JAX tool's stacked copies; pinned host memory for the card, copied
    into the graph's buffers at every call), returning the last step's
    loss. On the card its first call runs eagerly and its second captures
    the CUDA graph (see make_train_step_scan); ``run.captured`` then holds
    the capture's seconds and pool bytes."""
    optimizer = build_optimizer(model.config)
    state = [optimizer.init(params)]
    mask = model.trainable_mask(params) \
        if hasattr(model, 'trainable_mask') else None
    gen = torch.Generator(device=device).manual_seed(seed)
    if not scan:
        step = make_train_step(model, optimizer, trainable_mask=mask,
                               group=group)
        arrays = {k: torch.as_tensor(v).to(device) for k, v in batch.items()}

        def run():
            _, state[0], loss = step(params, state[0], arrays, generator=gen)
            return loss
        return run
    steps = make_train_step_scan(model, optimizer, trainable_mask=mask,
                                 n_steps=scan, group=group)
    stacked = {k: torch.from_numpy(np.stack([np.asarray(v)] * scan))
               for k, v in batch.items()}
    if torch.device(device).type == 'cuda':
        stacked = {k: v.pin_memory() for k, v in stacked.items()}

    def run():
        _, state[0], losses = steps(params, state[0], stacked, generator=gen)
        run.captured = steps.captured
        return losses[-1]
    run.captured = None
    return run
