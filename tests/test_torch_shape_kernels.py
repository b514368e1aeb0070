"""The shape stage's train step on the card against the port's plain
version on the CPU.

The test carries the ``cuda`` marker and skips without a card; on one:

  python -m pytest tests/test_torch_shape_kernels.py -m cuda -q

shape.ini's widths (128 x 4, skip at 2, bf16 lvis chain, fused kernels)
with 32 lights and 256 rays: the lvis chain's 16,384 rows (with the
jitter twins) run K1 on the tensor cores, the normal chain's 512 rows K1's
f32 CUDA-core mode. The loss, and every gradient leaf from one batch and
one jitter draw, held at K1's limits (PERF.md section 6): the lvis
chain's bf16 cotangents at 0.025 by relative norm, the f32 normal
chain's at 1e-4, the loss within the bf16 forward's 0.02 relative.
chip_smoke.py runs the same check at the step's full 1,048,576 lvis rows.
"""

import numpy as np
import pytest
import torch

from nerfactor_tpu_torch.models.shape import Model
from nerfactor_tpu_torch.utils import ckpt as ckptutil, config as configutil

NORM_TOL_BF16, DW_TOL_F32, LOSS_RTOL = 0.025, 1e-4, 2e-2
N_RAYS = 256


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device('cuda')


def rel_norm(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def batch(n_lights, seed=0):
    """Surface points on a sphere with their normals, visibility in
    [0, 1] and a mostly foreground alpha."""
    rng = np.random.RandomState(seed)
    xyz = rng.randn(N_RAYS, 3)
    xyz = 0.8 * xyz / np.linalg.norm(xyz, axis=1, keepdims=True)
    return {k: torch.from_numpy(v.astype(np.float32)) for k, v in (
        ('xyz', xyz), ('normal', xyz / 0.8),
        ('lvis', rng.rand(N_RAYS, n_lights)),
        ('alpha', (rng.rand(N_RAYS, 1) > 0.1).astype(float)))}


def loss_and_grads(config, device, params, arrays, noise):
    model = Model(config, device=device)
    live = ckptutil.tree_map(
        lambda t: t.detach().to(device).requires_grad_(), params)
    pred, gt, kwargs, _ = model.apply(
        live, {k: v.to(device) for k, v in arrays.items()}, mode='train',
        jitter_noise=noise.to(device))
    loss = torch.mean(model.compute_loss(live, pred, gt, **kwargs))
    keys = [k for k in sorted(live) for _ in ckptutil.tree_leaves(live[k])]
    grads = torch.autograd.grad(loss, ckptutil.tree_leaves(live))
    return loss.item(), [(k, g.cpu().numpy()) for k, g in zip(keys, grads)]


@pytest.mark.cuda
@pytest.mark.parametrize('seed', [0, 1])
def test_shape_step_on_card_matches_plain_port(seed, cuda):
    parser = configutil.read_config(configutil.resolve_config_path(
        'shape.ini'))
    configutil.apply_override(parser, 'light_h=4')
    config = configutil.Config(parser)
    assert config.getboolean('fused_mlp') and config.getboolean(
        'bf16_big_chains')
    params = Model(config, device='cpu').init_params(
        torch.Generator().manual_seed(seed))
    model = Model(config, device='cpu')
    arrays = batch(model.n_lights, seed)
    noise = model.xyz_jitter_std * torch.randn(
        (N_RAYS, 3), generator=torch.Generator().manual_seed(seed))
    loss_k, grads_k = loss_and_grads(config, cuda, params, arrays, noise)
    loss_p, grads_p = loss_and_grads(config, 'cpu', params, arrays, noise)
    np.testing.assert_allclose(loss_k, loss_p, rtol=LOSS_RTOL)
    assert len(grads_k) == 20
    for (k, got), (_, want) in zip(grads_k, grads_p):
        tol = NORM_TOL_BF16 if k.startswith('lvis') else DW_TOL_F32
        assert rel_norm(got, want) <= tol, (k, rel_norm(got, want))
