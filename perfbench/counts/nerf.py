"""NeRF's training step (``models/nerf.py`` under ``parallel/train.py``)
and distillation's visibility march over it
(``geometry_from_nerf.py``): the products a step or a light ray, the
recomputed forwards of the kernels' backwards not counted."""

from perfbench.counts import chain
from perfbench.harness import load_module


def field_layers(v):
    return load_module('counts', 'K3-bwd').field_layers(v)


def train_rows(v):
    """(coarse, fine) samples a step: the fine field takes the union of
    the coarse and the importance samples."""
    n, c = v['n_rays_per_step'], v['n_samples_coarse']
    return n * c, n * (c + v['n_samples_fine'])


def train_step_flops(cfg):
    v = cfg['values']
    ls = field_layers(v)
    return sum(chain.fwd(ls, r) + chain.dw(ls, r) + chain.dx(ls, r)
               for r in train_rows(v))


def sigma_layers(v):
    """The sigma chain: the trunk and the sigma head."""
    xyz = 3 * (1 + 2 * v['n_freqs_xyz'])
    return chain.layers(xyz, [v['mlp_width']] * v['enc_depth'] + [1],
                        {v['enc_skip_at']})


def march_rows(v):
    """(coarse, fine) samples a light ray: 64 more than training's
    coarse, then the union with 64 more than its fine."""
    coarse = 64 + v['n_samples_coarse']
    return coarse, coarse + 64 + v['n_samples_fine']


def march_flops_per_ray(cfg):
    v = cfg['values']
    return chain.fwd(sigma_layers(v), sum(march_rows(v)))
