"""Vanilla NeRF (coarse + fine), stage 1 of the pipeline (counterpart of
nerfactor_tpu/models/nerf.py).

Per level, an 8 x 256 ReLU trunk over posenc(xyz, 10) with the input skip
after layer 4, a 1-wide sigma head (ReLU applied at accumulation), a
256-wide linear bottleneck, and a [128, 3] rgb head over bottleneck (+)
posenc(view, 4). With ``fused_mlp`` the field runs as one fused evaluation
(ops/fused_nerf.py: kernels K3-fwd and K3-bwd on CUDA tensors), or, without
views, as one fused chain (ops/fused_mlp.py, kernel K1). Geometry
distillation reads sigma alone (:meth:`Model.eval_sigma`): the trunk and
the sigma head as one fused chain, kernel K1.

Training evaluates all rays x samples of a step in one pass; evaluation
walks chunks of ``eval_ray_chunk`` rays, the last one padded as the JAX
package pads it. Random draws (stratified jitter, sigma noise, importance
samples) come from a ``torch.Generator`` or are passed in.

Not ported: the JAX package's ``_train_ray_limit`` /
``_render_rays_train_chunked``, a guard against a TPU compiler crash at
8192-ray train dispatches of the unfused f32 program.
"""

from os.path import exists, join

import numpy as np
import torch

from nerfactor_tpu_torch.models.base import BaseModel
from nerfactor_tpu_torch.models import networks
from nerfactor_tpu_torch.ops import encoding, sampling
from nerfactor_tpu_torch.ops import img as imgops
from nerfactor_tpu_torch.ops import fused_mlp, fused_nerf
from nerfactor_tpu_torch.utils import ckpt as ckptutil, io as ioutil
from nerfactor_tpu_torch.utils import vis as visutil
from nerfactor_tpu_torch.utils.logging import Logger
from nerfactor_tpu_torch.utils.metrics import psnr as psnr_fn

logger = Logger(loggee="models/nerf")


class Model(BaseModel):
    def __init__(self, config, debug=False, device='cuda'):
        super().__init__(config, debug=debug, device=device)
        self.use_views = config.getboolean('use_views')
        self.near = config.getfloat('near')
        self.far = config.getfloat('far')
        self.n_samples_coarse = config.getint('n_samples_coarse')
        self.n_samples_fine = config.getint('n_samples_fine')
        self.lin_in_disp = config.getboolean('lin_in_disp')
        self.perturb = config.getboolean('perturb')
        self.noise_std = config.getfloat('noise_std', fallback=0.0)
        self.white_bg = config.getboolean('white_bg')
        self.pos_enc = config.getboolean('pos_enc')
        self.n_freqs_xyz = config.getint('n_freqs_xyz')
        self.n_freqs_view = config.getint('n_freqs_view')
        mlp_width = config.getint('mlp_width')
        enc_depth = config.getint('enc_depth')
        self.act = config.get('act', fallback='relu')
        xyz_dims = encoding.embed_dims(3, self.n_freqs_xyz) \
            if self.pos_enc else 3
        view_dims = encoding.embed_dims(3, self.n_freqs_view) \
            if (self.pos_enc and self.use_views) else 3
        self.specs = {
            'enc': networks.MLPSpec(
                xyz_dims, [mlp_width] * enc_depth, acts=self.act,
                skip_at=[enc_depth // 2]),
        }
        enc_out = self.specs['enc'].out_dim
        if self.use_views:
            self.specs['sigma_out'] = networks.MLPSpec(
                enc_out, [1], acts=None)
            self.specs['bottleneck'] = networks.MLPSpec(
                enc_out, [mlp_width], acts=None)
            self.specs['rgb_out'] = networks.MLPSpec(
                mlp_width + view_dims, [mlp_width // 2, 3],
                acts=[self.act, None])
        else:
            self.specs['rgbs_out'] = networks.MLPSpec(
                enc_out, [4], acts=None)
        # bf16 operands (f32 accumulation) for the rays x samples field
        # evaluations; the compositing, the resampling and the losses stay
        # f32
        self.big_chain_dtype = torch.bfloat16 if config.getboolean(
            'bf16_big_chains', fallback=False) else None
        # fused_mlp=False runs the plain program on every device, as in the
        # JAX package; True takes the CUDA kernels for CUDA tensors
        self.fused_mlp = config.getboolean('fused_mlp', fallback=False)
        nf_xyz = self.n_freqs_xyz if self.pos_enc else 0
        nf_view = self.n_freqs_view \
            if (self.pos_enc and self.use_views) else 0
        if self.use_views:
            self.nerf_plan = fused_nerf.make_nerf_plan(
                nf_xyz, nf_view, mlp_width, enc_depth, enc_depth // 2,
                self.act, (mlp_width // 2, 3), (self.act, None))
        else:
            self.rgbs_plan = fused_mlp.plan_from_specs(
                [(3, nf_xyz)], self.specs['enc'], self.specs['rgbs_out'])
        self.sigma_plan = fused_mlp.plan_from_specs(
            [(3, nf_xyz)], self.specs['enc'], self.specs[self._sigma_head])
        # Eval-time ray chunk: mlp_chunk counts flattened samples
        mlp_chunk = config.getint('mlp_chunk', fallback=1048576)
        n_total = self.n_samples_coarse + max(self.n_samples_fine, 0)
        self.eval_ray_chunk = max(256, mlp_chunk // max(n_total, 1))

    # ------ params ------

    def init_params(self, generator):
        levels = ['coarse'] + (['fine'] if self.n_samples_fine > 0 else [])
        params = {'%s_%s' % (level, name): spec.init(generator)
                  for level in levels for name, spec in self.specs.items()}
        return ckptutil.tree_map(lambda t: t.to(self.device), params)

    # ------ compute ------

    def _embed_xyz(self, pts):
        return encoding.posenc(pts, self.n_freqs_xyz) if self.pos_enc \
            else pts

    def _embed_view(self, views):
        if self.pos_enc and self.use_views:
            return encoding.posenc(views, self.n_freqs_view)
        return views

    @staticmethod
    def _pairs(layers):
        return [(l['w'], l['b']) for l in layers]

    @property
    def _sigma_head(self):
        """The head whose last column is sigma."""
        return 'sigma_out' if self.use_views else 'rgbs_out'

    def eval_nerf_at(self, params, pts, views, use_fine=False):
        """(n_rays, n_samples, 3) x2 -> (n_rays, n_samples, 4) raw rgb and
        sigma."""
        pref = 'fine_' if use_fine else 'coarse_'
        dt = self.big_chain_dtype
        shape = pts.shape[:2]
        pts_flat = pts.reshape(-1, 3)
        if self.fused_mlp:
            if self.use_views:
                p = (self._pairs(params[pref + 'enc']),
                     self._pairs(params[pref + 'sigma_out']),
                     self._pairs(params[pref + 'bottleneck']),
                     self._pairs(params[pref + 'rgb_out']))
                rgb, sigma = fused_nerf.apply_nerf(
                    self.nerf_plan, pts_flat, views.reshape(-1, 3), p,
                    compute_dtype=dt)
                return torch.cat([rgb, sigma], dim=-1).reshape(shape + (4,))
            p = fused_mlp.params_from_tree(params[pref + 'enc'],
                                           params[pref + 'rgbs_out'])
            rgbs = fused_mlp.apply_chain(self.rgbs_plan, pts_flat, p,
                                         compute_dtype=dt, needs_dx=False)
            return rgbs.reshape(shape + (4,))
        feat = self.specs['enc'].apply(params[pref + 'enc'],
                                       self._embed_xyz(pts_flat),
                                       compute_dtype=dt)
        if self.use_views:
            views_embed = self._embed_view(views.reshape(-1, 3))
            sigma = self.specs['sigma_out'].apply(
                params[pref + 'sigma_out'], feat, compute_dtype=dt)
            bott = self.specs['bottleneck'].apply(
                params[pref + 'bottleneck'], feat, compute_dtype=dt)
            rgb = self.specs['rgb_out'].apply(
                params[pref + 'rgb_out'], torch.cat((bott, views_embed), -1),
                compute_dtype=dt)
            rgbs = torch.cat((rgb, sigma), dim=-1)
        else:
            rgbs = self.specs['rgbs_out'].apply(
                params[pref + 'rgbs_out'], feat, compute_dtype=dt)
        return rgbs.reshape(shape + (4,))

    def eval_sigma(self, params, pts, use_fine=False, compute_dtype=None):
        """Pre-ReLU sigma at points ``pts`` (N, 3) -> (N, 1), for geometry
        distillation. The points are row-major: the JAX package's
        ``input_t`` (its TPU kernel's transposed (3, N) boundary) has no
        counterpart here.

        ``compute_dtype`` is passed only by the visibility march, which
        evaluates without gradients; the depth/normal pass differentiates
        through this w.r.t. ``pts`` in f32. The weights are frozen, so the
        fused chain's backward computes dx alone (``needs_dw=False``)."""
        pref = 'fine_' if use_fine else 'coarse_'
        head = self._sigma_head
        if self.fused_mlp:
            p = fused_mlp.params_from_tree(params[pref + 'enc'],
                                           params[pref + head])
            out = fused_mlp.apply_chain(self.sigma_plan, pts, p,
                                        compute_dtype=compute_dtype,
                                        needs_dw=False)
            return out[:, -1:]
        feat = self.specs['enc'].apply(params[pref + 'enc'],
                                       self._embed_xyz(pts),
                                       compute_dtype=compute_dtype)
        out = self.specs[head].apply(params[pref + head], feat,
                                     compute_dtype=compute_dtype)
        return out[:, -1:]  # rgbs_out packs sigma last

    def render_rays(self, params, rayo, rayd, mode='train', generator=None,
                    t_rand_coarse=None, sigma_noise=None, u_fine=None):
        """Coarse and fine renders of the rays: ({'rgb', 'occu', 'depth',
        'disp'}, the same for the fine level or {}). In train mode, the
        stratified jitter (with ``perturb``), the sigma noise (with
        ``noise_std > 0``) and the importance samples (with ``perturb``)
        are ``t_rand_coarse`` (n_rays, n_coarse) uniform, ``sigma_noise``
        (n_rays, n_coarse) standard normal and ``u_fine`` (n_rays, n_fine)
        uniform where given, else drawn from ``generator``."""
        train = mode == 'train'
        perturb = self.perturb and train
        noise_std = self.noise_std if train else 0.0
        rayd = rayd / torch.clamp(torch.linalg.norm(rayd, dim=1, keepdim=True),
                                  min=1e-12)
        n_rays = rayo.shape[0]
        z = sampling.gen_z(
            self.near, self.far, self.n_samples_coarse, n_rays,
            lin_in_disp=self.lin_in_disp, perturb=perturb,
            generator=generator, t_rand=t_rand_coarse, device=rayo.device)
        pts = rayo[:, None, :] + rayd[:, None, :] * z[:, :, None]
        views = rayd[:, None, :].expand(pts.shape)
        rgbs = self.eval_nerf_at(params, pts, views, use_fine=False)
        weights = sampling.accumulate_sigma(
            rgbs[:, :, 3], z, rayd, noise_std=noise_std, generator=generator,
            noise=sigma_noise)
        coarse = sampling.accumulate(rgbs, z, weights, self.white_bg)
        if self.n_samples_fine <= 0:
            return coarse, {}
        z = sampling.gen_z_fine(z, weights, self.n_samples_fine,
                                perturb=perturb, generator=generator,
                                u=u_fine)
        pts = rayo[:, None, :] + rayd[:, None, :] * z[:, :, None]
        views = rayd[:, None, :].expand(pts.shape)
        rgbs = self.eval_nerf_at(params, pts, views, use_fine=True)
        weights = sampling.accumulate_sigma(rgbs[:, :, 3], z, rayd)
        fine = sampling.accumulate(rgbs, z, weights, self.white_bg)
        return coarse, fine

    def _render_rays_chunked(self, params, rayo, rayd, mode):
        """Chunks of ``eval_ray_chunk`` rays, the last padded with copies
        of the last ray (as the JAX package's lax.map over chunks)."""
        n, chunk = rayo.shape[0], self.eval_ray_chunk
        if n <= chunk:
            return self.render_rays(params, rayo, rayd, mode=mode)
        pad = -n % chunk
        if pad:
            rayo = torch.cat([rayo, rayo[-1:].expand(pad, 3)])
            rayd = torch.cat([rayd, rayd[-1:].expand(pad, 3)])
        outs = [self.render_rays(params, rayo[i:i + chunk],
                                 rayd[i:i + chunk], mode=mode)
                for i in range(0, n + pad, chunk)]

        def unchunk(level):
            return {k: torch.cat([o[level][k] for o in outs])[:n]
                    for k in outs[0][level]}
        return unchunk(0), unchunk(1)

    def train_draws(self, generator, batch, world=1):
        """:meth:`render_rays`' draws (``t_rand_coarse``, ``sigma_noise``,
        ``u_fine``) for world x the batch's rays."""
        rayo = batch['rayo']
        n, device = world * rayo.shape[0], rayo.device
        coarse, fine = (n, self.n_samples_coarse), (n, self.n_samples_fine)
        draws = {}
        if (self.perturb or self.noise_std > 0) and generator is None:
            raise ValueError("Train mode with perturb or noise_std > 0 "
                             "draws: pass a generator")
        if self.perturb:
            draws['t_rand_coarse'] = torch.rand(coarse, generator=generator,
                                                device=device)
        if self.noise_std > 0:
            draws['sigma_noise'] = torch.randn(coarse, generator=generator,
                                               device=device)
        if self.perturb and self.n_samples_fine > 0:
            draws['u_fine'] = torch.rand(fine, generator=generator,
                                         device=device)
        return draws

    def apply(self, params, batch, mode='train', generator=None,
              jitter_noise=None, t_rand_coarse=None, sigma_noise=None,
              u_fine=None):
        """Renders the rays of ``batch`` ({'rayo', 'rayd', 'rgb'} tensors
        on the model's device). Train mode renders the batch in one pass
        with its draws from ``generator`` (or given, see
        :meth:`render_rays`); vali and test modes draw nothing and walk
        ray chunks. ``jitter_noise`` belongs to the shape models' train
        step and must be None here."""
        self._validate_mode(mode)
        if jitter_noise is not None:
            raise ValueError("NeRF has no smoothness jitter")
        rayo, rayd = batch['rayo'], batch['rayd']
        if mode == 'train':
            coarse, fine = self.render_rays(
                params, rayo, rayd, mode=mode, generator=generator,
                t_rand_coarse=t_rand_coarse, sigma_noise=sigma_noise,
                u_fine=u_fine)
        else:
            coarse, fine = self._render_rays_chunked(params, rayo, rayd, mode)
        pred = {'coarse': coarse['rgb'], 'fine': fine.get('rgb')}
        gt = batch['rgb']
        to_vis = {'gt_rgb': gt}
        for k, v in coarse.items():
            to_vis['coarse_' + k] = v
        for k, v in fine.items():
            to_vis['fine_' + k] = v
        return pred, gt, {}, to_vis

    def compute_loss(self, params, pred, gt, **kwargs):
        """Per-ray loss over the coarse and (if any) fine renders."""
        loss = 0.0
        for weight, loss_func in self.wloss:
            loss = loss + weight * loss_func(gt, pred['coarse'],
                                             keep_batch=True)
            if pred['fine'] is not None:
                loss = loss + weight * loss_func(gt, pred['fine'],
                                                 keep_batch=True)
        return loss

    # ------ host-side vis ------

    def vis_batch(self, data_dict, outdir, mode='train'):
        """Writes one view's images on the config's background; in vali
        mode also the fine-vs-gt and fine-vs-coarse flipbooks and a
        metadata.json with the fine render's PSNR."""
        self._validate_mode(mode)
        if mode == 'train':
            return
        data_dict = dict(data_dict)
        hw = tuple(int(x) for x in data_dict.pop('hw'))
        id_ = data_dict.pop('id')
        imgs = {}
        for k, v in data_dict.items():
            v = np.asarray(v)
            if k.endswith('rgb'):
                imgs[k] = v.reshape(hw + (3,))
            elif k.endswith(('occu', 'depth', 'disp')):
                imgs[k] = v.reshape(hw)
            else:
                raise NotImplementedError(k)
        img_dict = {}
        for k, v in imgs.items():
            if k.endswith('depth'):
                im = (v - self.near) / (self.far - self.near)
                alpha = imgs[k.replace('depth', 'occu')]
                bg = np.ones_like(im) if self.white_bg else np.zeros_like(im)
                im = imgops.alpha_blend(im, alpha, bg)
            elif k.endswith('disp'):
                min_disp, max_disp = 1 / self.far, 1 / self.near
                im = (v - min_disp) / (max_disp - min_disp)
                alpha = imgs[k.replace('disp', 'occu')]
                bg = np.ones_like(im) if self.white_bg else np.zeros_like(im)
                im = imgops.alpha_blend(im, alpha, bg)
            elif k.endswith('occu'):
                im = 1 - v if self.white_bg else v
            else:
                im = v
            img_dict[k] = ioutil.write_img(im, join(outdir, k + '.png'))
        if mode == 'test':
            ioutil.write_json({'id': id_}, join(outdir, 'metadata.json'))
            return
        font_color = (0, 0, 0) if self.white_bg else (1.0, 1.0, 1.0)

        def lbl(img, text):
            return visutil.put_text(img, text, color=font_color)
        visutil.make_anim(
            (lbl(img_dict['gt_rgb'], "Ground Truth"),
             lbl(img_dict['fine_rgb'], "Prediction (fine)")),
            join(outdir, 'fine-vs-gt_rgb.apng'))
        for buf in ('rgb', 'depth', 'disp', 'occu'):
            visutil.make_anim(
                (lbl(img_dict['fine_' + buf], "Prediction (fine)"),
                 lbl(img_dict['coarse_' + buf], "Prediction (coarse)")),
                join(outdir, 'fine-vs-coarse_%s.apng' % buf))
        psnr = psnr_fn(img_dict['gt_rgb'], img_dict['fine_rgb'],
                       drange='uint8')
        ioutil.write_json({'id': id_, 'psnr': psnr},
                          join(outdir, 'metadata.json'))

    def compile_batch_vis(self, batch_vis_dirs, outpref, mode='train',
                          fps=12):
        """Vali: one HTML page over the epoch's views; test: a video of
        the views' fine renders. Returns the path written (a video falls
        back to .apng without a codec), or None."""
        self._validate_mode(mode)
        if mode == 'train':
            return None
        if mode == 'vali':
            outpath = self._compile_into_webpage(batch_vis_dirs,
                                                 outpref + '.html')
        else:
            outpath = self._compile_into_video(batch_vis_dirs,
                                               outpref + '.mp4', fps=fps)
        if outpath is None:
            return None
        return self.config.get('viewer_prefix', fallback='') + outpath

    def _compile_into_webpage(self, batch_dirs, out_html):
        rows = []
        for batch_dir in batch_dirs:
            metadata = ioutil.read_json(join(batch_dir, 'metadata.json'))
            rows.append([
                str(metadata),
                join(batch_dir, 'fine-vs-gt_rgb.apng'),
                join(batch_dir, 'fine-vs-coarse_rgb.apng'),
                join(batch_dir, 'fine-vs-coarse_depth.apng'),
                join(batch_dir, 'fine-vs-coarse_disp.apng'),
                join(batch_dir, 'fine-vs-coarse_occu.apng')])
        if not rows:
            raise ValueError("No validation views to compile")
        caps = ["Metadata", "RGB", "RGB", "Depth", "Disparity", "Occupancy"]
        html = visutil.HTML(
            bgcolor='white' if self.white_bg else 'black',
            text_color='black' if self.white_bg else 'white')
        html.add_header("NeRF")
        table = html.add_table()
        for r in rows:
            table.add_row(r, ['text'] + ['image'] * 5, captions=caps)
        return html.save(out_html)

    def _compile_into_video(self, batch_dirs, out_mp4, fps=12):
        """The views' fine rgb in the order of their ids, each beside its
        nearest real capture (``<data_root>/test_phys_nn``) where there is
        exactly one; returns the path written, or None without frames."""
        data_root = self.config.get('data_root')
        frames = {}
        for batch_dir in batch_dirs:
            json_path = join(batch_dir, 'metadata.json')
            pred_path = join(batch_dir, 'fine_rgb.png')
            if not exists(json_path) or not exists(pred_path):
                logger.warn("Skipping %s: missing files", batch_dir)
                continue
            id_ = ioutil.read_json(json_path)['id']
            frame = ioutil.load_img(pred_path)
            nn_paths = ioutil.sortglob(join(data_root, 'test_phys_nn'),
                                       id_ + '_nn_*.png')
            if len(nn_paths) == 1:
                frame = imgops.hconcat((frame, ioutil.load_img(nn_paths[0])))
            frames[id_] = frame
        return visutil.make_video([frames[k] for k in sorted(frames)],
                                  out_mp4, fps=fps)
