"""Plain reference of NeRF (stage 1, ``nerf.ini``) and of distillation's
visibility march over it (stage 2), written from the model's equations
in f32 with nothing of the program.

The field: an 8 x 256 ReLU trunk over posenc(xyz, 10) with the input
skip after layer 4, a linear sigma head, a linear 256-wide bottleneck,
and a [128, 3] head over bottleneck (+) posenc(view, 4). Training
renders 64 stratified + 128 importance samples a ray (coarse and fine
fields) and takes the L2 loss of both renders. The march (geometry
distillation, ``lvis_block``): from each surface point towards every
light, 64 + 64 evenly spaced samples in [0.1, lvis_far] through the
coarse field's sigma, 64 + 128 more by inverse transform of their
weights, all 320 through the fine field's sigma; visibility is one minus
the opacity, zero where the light is behind the surface. Its fields take
``big`` operands: None (f32) or 'fp8'.
"""

import numpy as np
import torch

from perfbench.reference import plain


def _dims(cfg):
    v = cfg['values']
    return {'xyz': plain.posenc_dims(3, v['n_freqs_xyz']),
            'view': plain.posenc_dims(3, v['n_freqs_view']),
            'w': [v['mlp_width']] * v['enc_depth'],
            'skip': {v['enc_skip_at']}}


def param_tree(cfg):
    d, w = _dims(cfg), cfg['values']['mlp_width']
    feat = plain.mlp_out_dim(d['xyz'], d['w'], d['skip'])
    tree = {}
    for level in ('coarse', 'fine'):
        tree[level + '_enc'] = plain.mlp_tree(d['xyz'], d['w'], d['skip'])
        tree[level + '_sigma_out'] = plain.mlp_tree(feat, [1])
        tree[level + '_bottleneck'] = plain.mlp_tree(feat, [w])
        tree[level + '_rgb_out'] = plain.mlp_tree(w + d['view'], [w // 2, 3])
    return tree


def trainable(key):
    return True


def make_rays(cfg, rng, n):
    """``n`` training rays of views around the object: cameras 4 units
    from the origin looking at it, each ray through a pixel within 30
    degrees of the axis, with colours (float32 arrays)."""
    rayo = rng.standard_normal((n, 3), dtype=np.float32)
    rayo *= np.float32(4) / np.linalg.norm(rayo, axis=1, keepdims=True)
    rayd = -rayo / np.float32(4) + np.float32(0.3) * rng.standard_normal(
        (n, 3), dtype=np.float32)
    return {'rayo': rayo, 'rayd': rayd,
            'rgb': rng.random((n, 3), dtype=np.float32)}


def make_draws(cfg, gen, n_steps, n, device):
    """Each step's stratified jitter and importance-sampling draws."""
    v = cfg['values']
    u = torch.rand((n_steps, n, v['n_samples_coarse'] + v['n_samples_fine']),
                   generator=gen, device=device)
    return {'t_rand_coarse': u[..., :v['n_samples_coarse']],
            'u_fine': u[..., v['n_samples_coarse']:]}


def sphere_points(rng, n):
    """``n`` surface points on the unit sphere and their outward
    normals."""
    pts = rng.standard_normal((n, 3), dtype=np.float32)
    pts /= np.linalg.norm(pts, axis=1, keepdims=True)
    return pts, pts.copy()


class Reference:
    def __init__(self, cfg, device):
        self.cfg, self.v, self.d = cfg, cfg['values'], _dims(cfg)
        self.device = device

    def lr(self, count):
        v = self.v
        return plain.adam_lr(v['lr'], v['lr_decay_steps'],
                             v['lr_decay_rate'], count)

    def _feat(self, p, pref, pts, ops):
        e = plain.posenc(pts, self.v['n_freqs_xyz'])
        return plain.apply_mlp(p[pref + 'enc'], e, 'relu', self.d['skip'],
                               ops)

    def sigma(self, p, pref, pts, ops=None):
        """Pre-ReLU sigma (N,) at points (N, 3)."""
        feat = self._feat(p, pref, pts, ops)
        return plain.apply_mlp(p[pref + 'sigma_out'], feat, None, (), ops)[:, 0]

    def field(self, p, pref, pts, views, ops):
        feat = self._feat(p, pref, pts, ops)
        sigma = plain.apply_mlp(p[pref + 'sigma_out'], feat, None, (), ops)
        bott = plain.apply_mlp(p[pref + 'bottleneck'], feat, None, (), ops)
        rgb = plain.apply_mlp(
            p[pref + 'rgb_out'], torch.cat(
                [bott, plain.posenc(views, self.v['n_freqs_view'])], -1),
            ['relu', None], (), ops)
        return rgb, sigma[:, 0]

    def _render(self, p, pref, rayo, rayd, z, ops):
        n, s = z.shape
        pts = (rayo[:, None] + rayd[:, None] * z[:, :, None]).reshape(-1, 3)
        views = rayd[:, None].expand(n, s, 3).reshape(-1, 3)
        rgb, sigma = self.field(p, pref, pts, views, ops)
        weights = plain.composite_weights(sigma.reshape(n, s), z, rayd)
        occu = torch.sum(weights, dim=-1, keepdim=True)
        rgb = torch.sum(weights[:, :, None]
                        * torch.sigmoid(rgb.reshape(n, s, 3)), dim=1)
        bg = 1.0 if self.v['white_bg'] else 0.0
        return rgb * occu + bg * (1.0 - occu), weights

    def per_ray_loss(self, p, batch, draws, big=None, heads=None):
        v = self.v
        rayo, rayd = batch['rayo'], batch['rayd']
        rayd = rayd / torch.clamp(torch.linalg.norm(rayd, dim=1, keepdim=True),
                                  min=1e-12)
        z = plain.stratified_z(v['near'], v['far'], v['n_samples_coarse'],
                               rayo.shape[0], rayo.device,
                               t_rand=draws['t_rand_coarse'])
        coarse, weights = self._render(p, 'coarse_', rayo, rayd, z, big)
        z = plain.importance_z(z, weights, v['n_samples_fine'],
                               u=draws['u_fine'])
        fine, _ = self._render(p, 'fine_', rayo, rayd, z, big)
        gt = batch['rgb']
        return torch.mean(torch.square(gt - coarse), dim=-1) \
            + torch.mean(torch.square(gt - fine), dim=-1)

    def light_visibility(self, p, surf, normal, lxyz, lvis_far, ops=None,
                         points_a_pass=4):
        """(S, 3) x2 surface points and normals -> (S, L) visibility,
        ``points_a_pass`` points (all their lights) at a time."""
        n_coarse = 64 + self.v['n_samples_coarse']
        n_fine = 64 + self.v['n_samples_fine']
        out = []
        with torch.no_grad():
            for i in range(0, surf.shape[0], points_a_pass):
                s, nrm = surf[i:i + points_a_pass], normal[i:i + points_a_pass]
                surf2l = lxyz[None] - s[:, None]
                surf2l = surf2l / torch.clamp(torch.linalg.norm(
                    surf2l, dim=-1, keepdim=True), min=1e-12)
                front = torch.einsum('slc,sc->sl', surf2l, nrm) > 0
                o = s[:, None].expand(surf2l.shape).reshape(-1, 3)
                d = surf2l.reshape(-1, 3)
                z = plain.stratified_z(0.1, lvis_far, n_coarse, d.shape[0],
                                       d.device)
                pts = (o[:, None] + d[:, None] * z[:, :, None]).reshape(-1, 3)
                sigma = torch.relu(self.sigma(p, 'coarse_', pts, ops))
                weights = plain.composite_weights(
                    sigma.reshape(z.shape), z, d)
                z = plain.importance_z(z, weights, n_fine)
                pts = (o[:, None] + d[:, None] * z[:, :, None]).reshape(-1, 3)
                sigma = torch.relu(self.sigma(p, 'fine_', pts, ops))
                weights = plain.composite_weights(
                    sigma.reshape(z.shape), z, d)
                lvis = 1.0 - torch.sum(weights, dim=-1).reshape(front.shape)
                out.append(torch.where(front, lvis, torch.zeros_like(lvis)))
        return torch.clamp(torch.cat(out), 0.0, 1.0)
