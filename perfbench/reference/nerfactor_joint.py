"""Plain reference of the joint NeRFactor model's training step (stage 3,
``nerfactor.ini`` with ``shape_mode = scratch``): the loss of a batch of
surface rays, written from the model's equations in f32 with nothing of
the program.

Per ray: normal, light visibility (one MLP over position x each of the
16 x 32 light directions), albedo and a BRDF latent code from 128 x 4
skip-MLPs over posenc(xyz, 10) (visibility also posenc(ldir, 4)); the
frozen learned BRDF prior (a 128 x 4 skip-MLP over the latent code and
posenc of the Rusinkiewicz coordinates, 2 frequencies) in the local
shading frame; the rendering equation against the learned environment
light; the image, geometry, smoothness (at xyz + jitter) and light TV
terms. Its big chains (the visibility MLP and the BRDF prior, rays x
lights rows) take ``big`` operands: None (f32) or 'fp8'; the heads take
``heads`` operands.
"""

import math

import numpy as np
import torch

from perfbench.reference import plain

FROZEN = ('brdf_mlp', 'brdf_out', 'latent_code')


def _dims(cfg):
    v, b = cfg['values'], cfg['brdf_prior']
    xyz = plain.posenc_dims(3, v['n_freqs_xyz'])
    return {'xyz': xyz, 'lvis': xyz + plain.posenc_dims(3, v['n_freqs_ldir']),
            'brdf': b['z_dim'] + plain.posenc_dims(3, b['n_freqs']),
            'w': [v['mlp_width']] * v['mlp_depth'], 'skip': {v['mlp_skip_at']},
            'bw': [b['mlp_width']] * b['mlp_depth'],
            'bskip': {b['mlp_skip_at']}, 'z': b['z_dim']}


def param_tree(cfg):
    """The model's parameter layout (the program's keys and shapes)."""
    d = _dims(cfg)
    v = cfg['values']

    def mlp(in_dim, widths, skip=()):
        return plain.mlp_tree(in_dim, widths, skip)

    hid = plain.mlp_out_dim(d['xyz'], d['w'], d['skip'])
    tree = {}
    for name, in_dim, out in (('albedo', d['xyz'], 3),
                              ('brdf_z', d['xyz'], d['z']),
                              ('normal', d['xyz'], 3), ('lvis', d['lvis'], 1)):
        tree[name + '_mlp'] = mlp(in_dim, d['w'], d['skip'])
        tree[name + '_out'] = mlp(plain.mlp_out_dim(in_dim, d['w'], d['skip'])
                                  if name == 'lvis' else hid, [out])
    tree['brdf_mlp'] = mlp(d['brdf'], d['bw'], d['bskip'])
    tree['brdf_out'] = mlp(plain.mlp_out_dim(d['brdf'], d['bw'], d['bskip']),
                           [1])
    tree['light'] = ((v['light_h'], 2 * v['light_h'], 3),
                     ('uniform', v['light_init_max']))
    tree['latent_code'] = ((cfg['brdf_prior']['identities'], d['z']),
                           ('normal', 0.5))
    return tree


def trainable(key):
    return key not in FROZEN


def n_lights(cfg):
    return 2 * cfg['values']['light_h'] ** 2


def make_rays(cfg, rng, n):
    """``n`` training rays as the joint stage reads them from the
    distilled buffers: surface points on the unit sphere with their
    normals, cameras 4 units out, colours, alpha and per-light
    visibility (float32 arrays)."""
    xyz = rng.standard_normal((n, 3), dtype=np.float32)
    xyz /= np.linalg.norm(xyz, axis=1, keepdims=True)
    rayo = xyz + np.float32(4) * np.abs(rng.standard_normal(
        (n, 3), dtype=np.float32))
    return {'rayo': rayo, 'rayd': np.zeros((n, 3), np.float32),
            'rgb': rng.random((n, 3), dtype=np.float32),
            'alpha': np.ones((n, 1), np.float32), 'xyz': xyz,
            'normal': xyz.copy(),
            'lvis': rng.random((n, n_lights(cfg)), dtype=np.float32)}


def make_draws(cfg, gen, n_steps, n, device):
    """Each step's smoothness jitter, xyz_jitter_std * N(0, 1)."""
    return {'jitter_noise': cfg['values']['xyz_jitter_std'] * torch.randn(
        (n_steps, n, 3), generator=gen, device=device)}


class Reference:
    def __init__(self, cfg, device):
        self.cfg, self.v, self.d = cfg, cfg['values'], _dims(cfg)
        h = self.v['light_h']
        lxyz, lareas = plain.light_sphere(h, 2 * h)
        self.lxyz = torch.tensor(lxyz, dtype=torch.float32, device=device)
        self.lareas = torch.tensor(lareas, dtype=torch.float32,
                                   device=device)

    def lr(self, count):
        v = self.v
        return plain.adam_lr(v['lr'], v['lr_decay_steps'],
                             v['lr_decay_rate'], count)

    def _head(self, p, name, x, act, ops):
        h = plain.apply_mlp(p[name + '_mlp'], x, 'relu', self.d['skip'], ops)
        return plain.apply_mlp(p[name + '_out'], h, act, (), ops)

    def per_ray_loss(self, p, batch, draws, big=None, heads=None):
        v, d = self.v, self.d
        xyz, rayo, alpha = batch['xyz'], batch['rayo'], batch['alpha']
        n, n_l = xyz.shape[0], self.lxyz.shape[0]
        pts = torch.cat([xyz, xyz + draws['jitter_noise']], dim=0)
        emb = plain.posenc(pts, v['n_freqs_xyz'])
        normal_all = self._head(p, 'normal', emb, None, heads) + 1e-6
        normal = plain.normalize(normal_all[:n], 1)
        normal_jit = plain.normalize(normal_all[n:], 1)
        surf2l = plain.normalize(self.lxyz[None] - pts[:, None], 2)
        x = torch.cat([emb[:, None].expand(-1, n_l, -1),
                       plain.posenc(surf2l, v['n_freqs_ldir'])], dim=-1)
        lvis_all = self._head(p, 'lvis', x.reshape(-1, d['lvis']), 'sigmoid',
                              big).reshape(2 * n, n_l)
        lvis, lvis_jit = lvis_all[:n], lvis_all[n:]
        albedo_all = v['albedo_slope'] * self._head(
            p, 'albedo', emb, 'sigmoid', heads) + v['albedo_bias']
        z_all = self._head(p, 'brdf_z', emb, None, heads)
        albedo, z = albedo_all[:n], z_all[:n]
        # The learned BRDF prior in each point's local frame
        l = surf2l[:n]
        rot = plain.world2local(normal)
        vdir = torch.einsum('jkl,jl->jk', rot, plain.normalize(rayo - xyz, 1))
        ldir = torch.einsum('jkl,jnl->jnk', rot, l).reshape(-1, 3)
        rusink = plain.dir2rusink(
            ldir, vdir[:, None].expand(n, n_l, 3).reshape(-1, 3))
        zx = torch.cat([z[:, None].expand(n, n_l, d['z']).reshape(-1, d['z']),
                        plain.posenc(rusink, self.cfg['brdf_prior']['n_freqs'])
                        ], dim=1)
        h = plain.apply_mlp(p['brdf_mlp'], zx, 'relu', d['bskip'], big)
        spec = plain.apply_mlp(p['brdf_out'], h, 'softplus', (), big)
        spec = torch.where(ldir[:, 2:] > 0, spec, 0.0).reshape(n, n_l) \
            * v['learned_brdf_scale']
        # The rendering equation
        cos = torch.einsum('ijk,ik->ij', l, normal)
        w = (cos > 0).float() * lvis * cos * self.lareas[None]
        light = torch.clamp(p['light'], min=0.0)
        lf = light.reshape(-1, 3)
        rgb = (albedo / math.pi) * (w @ lf) + (spec * w) @ lf
        rgb = torch.clamp(rgb, 0.0, 1.0)
        if v['linear2srgb']:
            rgb = plain.linear2srgb(rgb)
        # The losses
        bg = 1.0 if v['white_bg'] else 0.0

        def blend(t):
            return t * alpha + bg * (1.0 - alpha)

        def mse(a, b):
            return torch.mean(torch.square(a - b), dim=-1)

        def smooth(a, b):
            return torch.mean(torch.abs(a - b), dim=-1) \
                if v['smooth_use_l1'] else mse(a, b)

        loss = mse(blend(batch['rgb']), blend(rgb))
        loss = loss + v['normal_loss_weight'] * mse(blend(batch['normal']),
                                                    blend(normal))
        loss = loss + v['lvis_loss_weight'] * mse(blend(batch['lvis']),
                                                  blend(lvis))
        loss = loss + v['normal_smooth_weight'] * smooth(blend(normal),
                                                         blend(normal_jit))
        loss = loss + v['lvis_smooth_weight'] * smooth(blend(lvis),
                                                       blend(lvis_jit))
        loss = loss + v['albedo_smooth_weight'] * smooth(albedo,
                                                         albedo_all[n:])
        loss = loss + v['brdf_smooth_weight'] * smooth(z, z_all[n:])
        dx = light - torch.roll(light, 1, 1)
        dy = light - torch.roll(light, 1, 0)
        loss = loss + v['light_tv_weight'] * torch.sum(dx ** 2 + dy ** 2)
        dc = light - torch.roll(light, 1, 2)
        return loss + v['light_achro_weight'] * torch.sum(dc ** 2)
