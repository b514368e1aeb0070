"""Shape model: surface MLPs distilling NeRF geometry -- normal(xyz) and
light visibility(xyz, ldir) -- trained against the distilled buffers with
jitter-based smoothness priors (counterpart of
nerfactor_tpu/models/shape.py; the stage ``shape.ini`` trains).

The joint NeRFactor model builds on this class for its shape heads and
restores their weights from a shape checkpoint. Both heads run as fused
chains (ops/fused_mlp.py): on the GPU the lvis chain, at rays x lights
scale, is the largest kernel launch of inference and training. Training
evaluates the (rays x lights) lvis rows in one dense chain call; vali and
test walk ray chunks of ``eval_ray_chunk``.
"""

from os.path import join

import numpy as np
import torch

from nerfactor_tpu_torch.models.base import BaseModel
from nerfactor_tpu_torch.models import networks
from nerfactor_tpu_torch.models.losses import mse_lastdim, mae_lastdim
from nerfactor_tpu_torch.ops import encoding
from nerfactor_tpu_torch.ops import fused_mlp
from nerfactor_tpu_torch.ops import img as imgops
from nerfactor_tpu_torch.ops.light import gen_light_xyz
from nerfactor_tpu_torch.ops.math import safe_l2_normalize
from nerfactor_tpu_torch.utils import (
    ckpt as ckptutil, io as ioutil, vis as visutil)


class Model(BaseModel):
    def __init__(self, config, debug=False, device='cuda'):
        super().__init__(config, debug=debug, device=device)
        self.white_bg = config.getboolean('white_bg')
        self.normal_smooth_weight = config.getfloat(
            'normal_smooth_weight', fallback=0.0)
        self.lvis_smooth_weight = config.getfloat(
            'lvis_smooth_weight', fallback=0.0)
        self.normal_loss_weight = config.getfloat(
            'normal_loss_weight', fallback=1.0)
        self.lvis_loss_weight = config.getfloat(
            'lvis_loss_weight', fallback=1.0)
        self.smooth_use_l1 = config.getboolean('smooth_use_l1',
                                               fallback=False)
        self.xyz_jitter_std = config.getfloat('xyz_jitter_std', fallback=0.0)
        # The joint model sets this False under shape_mode='frozen': the
        # normal/lvis chains' backward then skips all dW/db work
        self.shape_heads_need_dw = True
        self.xyz_scale = config.getfloat('xyz_scale', fallback=1.0)
        self.pos_enc = config.getboolean('pos_enc')
        self.n_freqs_xyz = config.getint('n_freqs_xyz')
        self.n_freqs_ldir = config.getint('n_freqs_ldir')
        self.mlp_width = config.getint('mlp_width')
        self.mlp_depth = config.getint('mlp_depth')
        self.mlp_skip_at = config.getint('mlp_skip_at')
        # Light sphere (or MVS-provided light locations)
        lxyz, lareas = self._gen_lights()
        self.lxyz = torch.as_tensor(lxyz, dtype=torch.float32, device=device)
        self.lareas = torch.as_tensor(lareas, dtype=torch.float32,
                                      device=device)
        self.n_lights = int(np.prod(lxyz.shape[:-1]))
        # Eval ray chunk for the N x L blow-up
        mlp_chunk = config.getint('mlp_chunk', fallback=1048576)
        self.eval_ray_chunk = max(64, mlp_chunk // max(self.n_lights, 1))
        # fused_mlp=False runs the plain chains on every device, as in the
        # JAX package; True takes the CUDA kernel for CUDA tensors
        self.fused_mlp = config.getboolean('fused_mlp', fallback=False)
        # bf16 operands (f32 accumulation) for the (rays x lights) chains;
        # the N-scale heads and the render stay true f32
        self.big_chain_dtype = torch.bfloat16 if config.getboolean(
            'bf16_big_chains', fallback=False) else None
        # '+'-separated chain names ('lvis', 'brdf') pinned to f32
        self.f32_chains = frozenset(
            s for s in config.get('f32_chains', fallback='').replace(
                '+', ' ').split() if s)
        self._init_specs()
        self._init_plans()

    def _gen_lights(self):
        """The light sphere of ``light_h``, or with ``mvs_root`` the
        scene-shifted one that data_gen/dtu_surf_from_mvs.py saved to
        ``<mvs_root>/lights.npz`` (it cannot be made again here)."""
        mvs_root = self.config.get('mvs_root', fallback=None)
        if mvs_root is None:
            light_h = self.config.getint('light_h')
            return gen_light_xyz(light_h, 2 * light_h)
        data = ioutil.load_np(join(mvs_root, 'lights.npz'))
        return data['lxyzs'], data['lareas']

    def _xyz_dims(self):
        return encoding.embed_dims(3, self.n_freqs_xyz) if self.pos_enc \
            else 3

    def _ldir_dims(self):
        return encoding.embed_dims(3, self.n_freqs_ldir) if self.pos_enc \
            else 3

    def _init_specs(self):
        w, d, s = self.mlp_width, self.mlp_depth, self.mlp_skip_at
        self.specs = {
            'normal_mlp': networks.MLPSpec(
                self._xyz_dims(), [w] * d, acts='relu', skip_at=[s]),
            'lvis_mlp': networks.MLPSpec(
                self._xyz_dims() + self._ldir_dims(), [w] * d, acts='relu',
                skip_at=[s]),
        }
        self.specs['normal_out'] = networks.MLPSpec(
            self.specs['normal_mlp'].out_dim, [3], acts=None)
        self.specs['lvis_out'] = networks.MLPSpec(
            self.specs['lvis_mlp'].out_dim, [1], acts='sigmoid')

    def _nf(self, n_freqs):
        return n_freqs if self.pos_enc else 0

    def _init_plans(self):
        self.plans = {}
        if 'normal_mlp' in self.specs:
            self.plans['normal'] = fused_mlp.plan_from_specs(
                [(3, self._nf(self.n_freqs_xyz))],
                self.specs['normal_mlp'], self.specs['normal_out'])
            self.plans['lvis'] = fused_mlp.plan_from_specs(
                [(3, self._nf(self.n_freqs_xyz)),
                 (3, self._nf(self.n_freqs_ldir))],
                self.specs['lvis_mlp'], self.specs['lvis_out'])

    def chain_dtype(self, name):
        """Compute dtype of the named big chain ('lvis', 'brdf'):
        ``big_chain_dtype`` unless ``f32_chains`` pins it to f32."""
        return None if name in self.f32_chains else self.big_chain_dtype

    def _chain(self, params, mlp_name, out_name, plan, x_raw,
               compute_dtype=None, needs_dx=True, needs_dw=True):
        """One fused embed -> MLP -> head evaluation. ``needs_dx=False``
        (the inputs are data, e.g. xyz/surf2l) lets the kernel backward
        skip the input cotangent; ``needs_dw=False`` (frozen weights, e.g.
        the joint model's BRDF prior) skips all dW/db work."""
        p = fused_mlp.params_from_tree(params[mlp_name], params[out_name])
        return fused_mlp.apply_chain(
            plan, x_raw, p, force_reference=not self.fused_mlp,
            compute_dtype=compute_dtype, needs_dx=needs_dx,
            needs_dw=needs_dw)

    def init_params(self, generator):
        return {name: ckptutil.tree_map(lambda t: t.to(self.device),
                                        spec.init(generator))
                for name, spec in self.specs.items()}

    def calc_ldir(self, pts):
        """(N, 3) -> (N, L, 3) unit directions surface -> light pixels."""
        surf2l = self.lxyz.reshape(1, -1, 3) - pts[:, None, :]
        return safe_l2_normalize(surf2l, dim=2)

    @staticmethod
    def calc_vdir(cam_loc, pts):
        return safe_l2_normalize(cam_loc - pts, dim=1)

    def pred_normal_at(self, params, pts, eps=1e-6):
        normal = self._chain(params, 'normal_mlp', 'normal_out',
                             self.plans['normal'], self.xyz_scale * pts,
                             needs_dx=False,
                             needs_dw=self.shape_heads_need_dw)
        # eps avoids all-zero normals producing zero tangents downstream
        return normal + eps

    def pred_lvis_at(self, params, pts, surf2l):
        """(N, 3), (N, L, 3) -> (N, L), one dense chain over N*L rows."""
        n, l = surf2l.shape[0], surf2l.shape[1]
        surf_rep = (self.xyz_scale * pts)[:, None, :].expand(n, l, 3)
        x_raw = torch.cat(
            (surf_rep.reshape(-1, 3), surf2l.reshape(-1, 3)), dim=-1)
        lvis = self._chain(params, 'lvis_mlp', 'lvis_out',
                           self.plans['lvis'], x_raw,
                           compute_dtype=self.chain_dtype('lvis'),
                           needs_dx=False,
                           needs_dw=self.shape_heads_need_dw)
        return lvis.reshape(n, l)

    def _forward_chunked(self, fn, pts, chunk):
        """``fn`` over chunks of ``chunk`` rows of ``pts``; the last chunk
        is padded with copies of the last row, as the JAX package's
        ``lax.map`` over static chunks, so every chunk holds the rows it
        holds there."""
        n = pts.shape[0]
        if n <= chunk:
            return fn(pts)
        n_chunks = -(-n // chunk)
        pad = n_chunks * chunk - n
        if pad:
            pts = torch.cat([pts, pts[-1:].expand(pad, pts.shape[1])], dim=0)
        outs = [fn(pts[i * chunk:(i + 1) * chunk]) for i in range(n_chunks)]
        return {k: torch.cat([o[k] for o in outs], dim=0)[:n]
                for k in outs[0]}

    def _jitter(self, xyz, generator, jitter_noise):
        """The smoothness jitter: ``jitter_noise`` (already scaled) or
        ``xyz_jitter_std * N(0, 1)`` drawn from ``generator``; None when
        ``xyz_jitter_std`` is 0. (The JAX model silently drops the probes
        when its key is None; here a missing source raises.)"""
        if self.xyz_jitter_std <= 0:
            return None
        if jitter_noise is not None:
            return jitter_noise
        if generator is None:
            raise ValueError(
                "Train mode with xyz_jitter_std > 0 draws the smoothness "
                "jitter: pass a generator or jitter_noise")
        return self.xyz_jitter_std * torch.randn(
            xyz.shape, generator=generator, dtype=xyz.dtype,
            device=xyz.device)

    def apply(self, params, batch, mode='train', generator=None,
              jitter_noise=None):
        """Normals and light visibility at the batch's surface points.
        Train mode runs the batch in one block; the smoothness probes at
        ``xyz + noise`` (see :meth:`_jitter`) ride the same chain calls
        as the main rows: each head whose smoothness weight is nonzero
        runs once on 2N stacked rows, and a head whose weight is zero
        runs on N. Vali and test modes walk ray chunks."""
        self._validate_mode(mode)
        alpha = batch['alpha']
        xyz, normal, lvis = batch['xyz'], batch['normal'], batch['lvis']
        normal_jitter, lvis_jitter = None, None
        if mode == 'train':
            noise = self._jitter(xyz, generator, jitter_noise)
            jit_normal = noise is not None and self.normal_smooth_weight > 0
            jit_lvis = noise is not None and self.lvis_smooth_weight > 0
            n = xyz.shape[0]
            if noise is not None:
                xyz_all = torch.cat([xyz, xyz + noise], dim=0)
            normal_all = self.pred_normal_at(
                params, xyz_all if jit_normal else xyz)
            lvis_in = xyz_all if jit_lvis else xyz
            lvis_all = self.pred_lvis_at(params, lvis_in,
                                         self.calc_ldir(lvis_in))
            out = {'normal': normal_all[:n], 'lvis': lvis_all[:n]}
            if jit_normal:
                normal_jitter = safe_l2_normalize(normal_all[n:], dim=1)
            if jit_lvis:
                lvis_jitter = lvis_all[n:]
        else:
            def forward(pts):
                return {'normal': self.pred_normal_at(params, pts),
                        'lvis': self.pred_lvis_at(params, pts,
                                                  self.calc_ldir(pts))}

            out = self._forward_chunked(forward, xyz, self.eval_ray_chunk)
        pred = {'normal': safe_l2_normalize(out['normal'], dim=1),
                'lvis': out['lvis']}
        gt = {'normal': normal, 'lvis': lvis, 'alpha': alpha}
        loss_kwargs = {'normal_jitter': normal_jitter,
                       'lvis_jitter': lvis_jitter}
        to_vis = {'gt_alpha': alpha}
        for k, v in pred.items():
            to_vis['pred_' + k] = v
        for k in ('normal', 'lvis'):
            to_vis['gt_' + k] = gt[k]
        return pred, gt, loss_kwargs, to_vis

    def compute_loss(self, params, pred, gt, normal_jitter=None,
                     lvis_jitter=None, **kwargs):
        """Per-example loss; signals composited onto the background
        first (reference shape.py:239-277)."""
        smooth_loss = mae_lastdim if self.smooth_use_l1 else mse_lastdim
        alpha = gt['alpha']
        bgv = 1.0 if self.white_bg else 0.0

        def blend(x):
            return x * alpha + bgv * (1 - alpha)

        normal_pred, lvis_pred = blend(pred['normal']), blend(pred['lvis'])
        loss = self.normal_loss_weight * mse_lastdim(blend(gt['normal']),
                                                     normal_pred)
        loss = loss + self.lvis_loss_weight * mse_lastdim(blend(gt['lvis']),
                                                          lvis_pred)
        if normal_jitter is not None:
            loss = loss + self.normal_smooth_weight * smooth_loss(
                normal_pred, blend(normal_jitter))
        if lvis_jitter is not None:
            loss = loss + self.lvis_smooth_weight * smooth_loss(
                lvis_pred, blend(lvis_jitter))
        return loss

    # ------ host-side vis ------

    def vis_batch(self, data_dict, outdir, mode='train'):
        """One view's normal and visibility maps (pred and gt); in vali
        mode also the pred-vs-gt flipbooks. Writes metadata.json."""
        self._validate_mode(mode)
        if mode == 'train':
            return
        data_dict = dict(data_dict)
        hw = tuple(int(x) for x in data_dict.pop('hw'))
        id_ = data_dict.pop('id')
        imgs = {}
        for k, v in data_dict.items():
            v = np.asarray(v)
            if k.endswith('normal'):
                imgs[k] = v.reshape(hw + (3,))
            elif k.endswith(('occu', 'alpha')):
                imgs[k] = v.reshape(hw)
            elif k.endswith('lvis'):
                imgs[k] = v.reshape(hw + (v.shape[-1],))
            else:
                raise NotImplementedError(k)
        img_dict = {}
        alpha = imgs['gt_alpha']
        for k, v in imgs.items():
            if k.endswith('normal'):
                v = (v + 1) / 2
            elif k.endswith('lvis'):
                v = np.mean(v, axis=2)
            else:
                img_dict[k] = ioutil.write_img(v, join(outdir, k + '.png'))
                continue
            bg = np.ones_like(v) if self.white_bg else np.zeros_like(v)
            img_dict[k] = ioutil.write_img(imgops.alpha_blend(v, alpha, bg),
                                           join(outdir, k + '.png'))
        if mode == 'vali':
            font_color = (0, 0, 0) if self.white_bg else (1.0, 1.0, 1.0)
            for k in ('normal', 'lvis'):
                visutil.make_anim(
                    (visutil.put_text(img_dict['gt_' + k], "Initial",
                                      color=font_color),
                     visutil.put_text(img_dict['pred_' + k], "Prediction",
                                      color=font_color)),
                    join(outdir, 'pred-vs-gt_%s.apng' % k))
        ioutil.write_json({'id': id_}, join(outdir, 'metadata.json'))

    def compile_batch_vis(self, batch_vis_dirs, outpref, mode='train'):
        """Vali: one HTML page of the epoch's flipbooks; returns its
        path. Test-time videos come from the joint model."""
        self._validate_mode(mode)
        if mode == 'train':
            return None
        if mode != 'vali':
            raise ValueError(
                "The shape model compiles only validation batches (use the "
                "NeRFactor model for test-time videos)")
        rows = []
        for batch_dir in batch_vis_dirs:
            metadata = ioutil.read_json(join(batch_dir, 'metadata.json'))
            rows.append([str(metadata),
                         join(batch_dir, 'pred-vs-gt_normal.apng'),
                         join(batch_dir, 'pred-vs-gt_lvis.apng')])
        if not rows:
            raise ValueError("No validation views to compile")
        html = visutil.HTML(
            bgcolor='white' if self.white_bg else 'black',
            text_color='black' if self.white_bg else 'white')
        html.add_header("Refining and Caching Geometry Initialization")
        table = html.add_table()
        for r in rows:
            table.add_row(r, ['text', 'image', 'image'],
                          captions=["Metadata", "Normal",
                                    "Light Visibility"])
        out_html = outpref + '.html'
        html.save(out_html)
        return self.config.get('viewer_prefix', fallback='') + out_html
