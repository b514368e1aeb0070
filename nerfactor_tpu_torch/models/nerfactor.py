"""NeRFactor: the joint shape/reflectance/illumination model (counterpart
of nerfactor_tpu/models/nerfactor.py).

Per surface point the model predicts albedo and a BRDF latent code (and,
unless ``shape_mode = nerf``, normals and light visibility), evaluates
the frozen learned BRDF prior in local shading frames, and integrates the
rendering equation against the learned 16 x 32 environment light. A
subclass with ``uses_learned_brdf = False`` (models/nerfactor_microfacet.py)
overrides ``_init_brdf_config``, ``_make_brdf_z_out_spec`` and
``eval_spec_at`` and builds, restores and visualises no prior.
Relighting is algebra, as in the JAX package: the per-light contribution
is channel-rank structured (brdf = albedo/pi + achromatic spec), so the
render and every OLAT/probe relight are (N, L) matmuls and column slices
(see :meth:`Model.render`).

On CUDA tensors the four heads run kernel K1 and the BRDF prior runs
kernel K2 (with ``fused_mlp``/``fused_rusink``, as the shipped config sets
them), forward and, in training, backward; the render is plain f32
PyTorch. Training supervises the render with the image loss plus the
geometry, smoothness and light priors (:meth:`Model.compute_loss`).
"""

import math
from os.path import join, dirname, exists, basename

import numpy as np
import torch

from nerfactor_tpu_torch.utils import config as configutil
from nerfactor_tpu_torch.utils.logging import Logger
from nerfactor_tpu_torch.models.losses import mse_lastdim, mae_lastdim
from nerfactor_tpu_torch.models.shape import Model as ShapeModel
from nerfactor_tpu_torch.models import networks
from nerfactor_tpu_torch.ops import encoding
from nerfactor_tpu_torch.ops import fused_mlp
from nerfactor_tpu_torch.ops import fused_rusink
from nerfactor_tpu_torch.ops import geom as geomops
from nerfactor_tpu_torch.ops import img as imgops
from nerfactor_tpu_torch.ops.chunk import chunked_apply_tree
from nerfactor_tpu_torch.ops.light import (
    make_olat_envmaps, vis_light, load_light)
from nerfactor_tpu_torch.ops.math import safe_l2_normalize
from nerfactor_tpu_torch.utils import (
    ckpt as ckptutil, io as ioutil, vis as visutil)
from nerfactor_tpu_torch.utils.metrics import psnr as psnr_fn, ssim as ssim_fn

logger = Logger(loggee="models/nerfactor")

SHAPE_PARAM_KEYS = ('normal_mlp', 'normal_out', 'lvis_mlp', 'lvis_out')
BRDF_PARAM_KEYS = ('brdf_mlp', 'brdf_out', 'latent_code')


class Model(ShapeModel):
    uses_learned_brdf = True

    def __init__(self, config, debug=False, device='cuda'):
        self._init_brdf_config(config)
        self.shape_mode = config.get('shape_mode')
        if self.shape_mode not in ('scratch', 'frozen', 'finetune', 'nerf'):
            raise ValueError("shape_mode: %s" % self.shape_mode)
        self.shape_model_ckpt = config.get('shape_model_ckpt', fallback=None)
        self.config_shape = None
        if self.shape_mode in ('frozen', 'finetune'):
            self.config_shape = self._load_sub_config(self.shape_model_ckpt)
        super().__init__(config, debug=debug, device=device)
        if self.shape_mode == 'frozen':
            # Shape MLPs get zero updates (trainable_mask): their kernel
            # backwards skip all dW/db work
            self.shape_heads_need_dw = False
        # dir2rusink inside the BRDF chain kernel; False runs the unfused
        # program, as in the JAX package
        self.fused_rusink = config.getboolean('fused_rusink',
                                              fallback=False)
        self.albedo_smooth_weight = config.getfloat('albedo_smooth_weight')
        self.brdf_smooth_weight = config.getfloat('brdf_smooth_weight')
        self.albedo_slope = config.getfloat('albedo_slope', fallback=0.7)
        self.albedo_bias = config.getfloat('albedo_bias', fallback=0.1)
        self.learned_brdf_scale = config.getfloat(
            'learned_brdf_scale', fallback=1.0)
        self.default_z = config.getfloat('default_z', fallback=0.1)
        self.light_init_max = config.getfloat('light_init_max')
        self.light_tv_weight = config.getfloat('light_tv_weight')
        self.light_achro_weight = config.getfloat('light_achro_weight')
        self.linear2srgb = config.getboolean('linear2srgb')
        light_h = config.getint('light_h')
        self.light_res = (light_h, 2 * light_h)
        # ------ Novel lighting for test-time relighting
        self.olat_inten = config.getfloat('olat_inten', fallback=200.0)
        self.ambient_inten = config.getfloat('ambient_inten', fallback=0.0) \
            if self.white_bg else 0.0
        olats = make_olat_envmaps(
            *self.light_res, olat_inten=self.olat_inten,
            ambient_inten=self.ambient_inten, limit=2 if debug else None)
        self.olat_names = list(olats.keys())
        # Flat light indices of the OLATs, row-major over (i, j)
        self.olat_inds = torch.as_tensor(np.asarray([
            np.ravel_multi_index(tuple(int(x) for x in name.split('-')),
                                 self.light_res)
            for name in self.olat_names], np.int64), device=device)
        self.embed_light_h = config.getint('embed_light_h', fallback=32)
        # OLAT thumbnails are needed at vis time only; built lazily
        self._olats = olats
        self._novel_olat_uint = None
        self.novel_probes = self._load_probes()
        self.novel_probes_uint = {
            k: vis_light(v, h=self.embed_light_h)
            for k, v in self.novel_probes.items()}
        self.probe_names = list(self.novel_probes.keys())
        self.probes_flat = None
        if self.novel_probes:
            self.probes_flat = torch.as_tensor(np.stack(
                [v.reshape(-1, 3) for v in self.novel_probes.values()]),
                dtype=torch.float32, device=device)

    @property
    def novel_olat_uint(self):
        if self._novel_olat_uint is None:
            self._novel_olat_uint = {
                k: vis_light(v, h=self.embed_light_h)
                for k, v in self._olats.items()}
        return self._novel_olat_uint

    def _init_brdf_config(self, config):
        """Learned BRDF prior config (frozen)."""
        self.pred_brdf = config.getboolean('pred_brdf')
        self.brdf_model_ckpt = config.get('brdf_model_ckpt')
        self.config_brdf = self._load_sub_config(self.brdf_model_ckpt)
        self.z_dim = self.config_brdf.getint('z_dim')
        self.normalize_brdf_z = self.config_brdf.getboolean('normalize_z')
        self.pos_enc_rusink = self.config_brdf.getboolean('pos_enc')
        self.n_freqs_rusink = self.config_brdf.getint('n_freqs')

    @staticmethod
    def _load_sub_config(ckpt_path):
        ini = configutil.get_config_ini(ckpt_path)
        return configutil.Config(configutil.read_config(ini))

    def _load_probes(self):
        probes = {}
        test_envmap_dir = self.config.get('test_envmap_dir', fallback=None)
        if not test_envmap_dir or not exists(test_envmap_dir):
            logger.warn("No test envmap dir; skipping light probes")
            return probes
        for path in ioutil.sortglob(test_envmap_dir,
                                    ext=('hdr', 'exr', 'npy')):
            name = basename(path).rsplit('.', 1)[0]
            try:
                probes[name] = load_light(path, envmap_h=self.light_res[0])
            except Exception as e:  # codec availability varies
                logger.warn("Failed to load probe %s (%s)", path, e)
        return probes

    # ------ network specs & params ------

    def _init_specs(self):
        w, d, s = self.mlp_width, self.mlp_depth, self.mlp_skip_at
        xyz_dims = self._xyz_dims()
        self.specs = {}
        # Albedo head: sigmoid in [0, 1], scaled to [bias, slope + bias]
        self.specs['albedo_mlp'] = networks.MLPSpec(
            xyz_dims, [w] * d, acts='relu', skip_at=[s])
        self.specs['albedo_out'] = networks.MLPSpec(
            self.specs['albedo_mlp'].out_dim, [3], acts='sigmoid')
        if self.pred_brdf:
            self.specs['brdf_z_mlp'] = networks.MLPSpec(
                xyz_dims, [w] * d, acts='relu', skip_at=[s])
            self.specs['brdf_z_out'] = self._make_brdf_z_out_spec()
        # Shape heads exist unless geometry comes straight from NeRF buffers
        if self.shape_mode != 'nerf':
            shape_cfg = self.config_shape if self.shape_mode in (
                'frozen', 'finetune') else self.config
            sw = shape_cfg.getint('mlp_width')
            sd = shape_cfg.getint('mlp_depth')
            ss = shape_cfg.getint('mlp_skip_at')
            self.specs['normal_mlp'] = networks.MLPSpec(
                xyz_dims, [sw] * sd, acts='relu', skip_at=[ss])
            self.specs['normal_out'] = networks.MLPSpec(
                self.specs['normal_mlp'].out_dim, [3], acts=None)
            self.specs['lvis_mlp'] = networks.MLPSpec(
                xyz_dims + self._ldir_dims(), [sw] * sd, acts='relu',
                skip_at=[ss])
            self.specs['lvis_out'] = networks.MLPSpec(
                self.specs['lvis_mlp'].out_dim, [1], acts='sigmoid')
        if self.uses_learned_brdf:
            # Frozen BRDF prior nets (shapes from the BRDF experiment's
            # config)
            rusink_dims = encoding.embed_dims(3, self.n_freqs_rusink) \
                if self.pos_enc_rusink else 3
            bw = self.config_brdf.getint('mlp_width')
            bd = self.config_brdf.getint('mlp_depth')
            bs = self.config_brdf.getint('mlp_skip_at')
            self.specs['brdf_mlp'] = networks.MLPSpec(
                self.z_dim + rusink_dims, [bw] * bd, acts='relu',
                skip_at=[bs])
            self.specs['brdf_out'] = networks.MLPSpec(
                self.specs['brdf_mlp'].out_dim, [1], acts='softplus')

    def _make_brdf_z_out_spec(self):
        """The head of the per-point BRDF property: the prior's latent
        code, linear."""
        return networks.MLPSpec(
            self.specs['brdf_z_mlp'].out_dim, [self.z_dim], acts=None)

    def _init_plans(self):
        super()._init_plans()
        xyz_part = [(3, self._nf(self.n_freqs_xyz))]
        self.plans['albedo'] = fused_mlp.plan_from_specs(
            xyz_part, self.specs['albedo_mlp'], self.specs['albedo_out'])
        if self.pred_brdf:
            self.plans['brdf_z'] = fused_mlp.plan_from_specs(
                xyz_part, self.specs['brdf_z_mlp'],
                self.specs['brdf_z_out'])
        if self.uses_learned_brdf:
            nf_rusink = self.n_freqs_rusink if self.pos_enc_rusink else 0
            self.plans['brdf'] = fused_mlp.plan_from_specs(
                [(self.z_dim, 0), (3, nf_rusink)],
                self.specs['brdf_mlp'], self.specs['brdf_out'])

    def init_params(self, generator):
        """Fresh heads and light, plus the restored frozen BRDF prior
        (with the learned prior) and (for shape_mode frozen/finetune) the
        restored shape MLPs."""
        params = {name: spec.init(generator)
                  for name, spec in self.specs.items()}
        params['light'] = self.light_init_max * torch.rand(
            self.light_res + (3,), generator=generator)
        if self.uses_learned_brdf:
            params.update(self._restore_brdf_prior())
        if self.shape_mode in ('frozen', 'finetune'):
            shape_params = self._restore_shape()
            for k in SHAPE_PARAM_KEYS:
                params[k] = shape_params[k]
        return ckptutil.tree_map(lambda t: t.to(self.device), params)

    def _restore_brdf_prior(self):
        """brdf_mlp/brdf_out/latent_code from the BRDF experiment's
        checkpoint. The latent table's shape comes from its own leaf (the
        last one: 'latent_code' sorts after 'brdf_*'), so the MERL data
        the BRDF model globs for its identities is not needed."""
        leaves = ckptutil.read_leaves(self.brdf_model_ckpt)
        template = {
            'brdf_mlp': self.specs['brdf_mlp'].init(torch.Generator()),
            'brdf_out': self.specs['brdf_out'].init(torch.Generator()),
            'latent_code': torch.empty(leaves[-1].shape)}
        restored = ckptutil.restore_trained_params(self.brdf_model_ckpt,
                                                   template)
        return {k: restored[k] for k in BRDF_PARAM_KEYS}

    def _restore_shape(self):
        """The pre-trained shape MLPs (shape_mode frozen/finetune)."""
        template = ShapeModel(self.config_shape, device='cpu').init_params(
            torch.Generator())
        return ckptutil.restore_trained_params(self.shape_model_ckpt,
                                               template)

    def needs_dw_false_keys(self):
        """The BRDF prior chain always runs needs_dw=False (it is always
        frozen); the shape chains do so only under shape_mode=frozen. Only
        keys of the model's parameters are named."""
        keys = set()
        if self.uses_learned_brdf:
            keys.update(('brdf_mlp', 'brdf_out'))
        if not self.shape_heads_need_dw:
            keys.update(SHAPE_PARAM_KEYS)
        return frozenset(keys)

    def trainable_mask(self, params):
        """False leaves get zero gradient updates: the BRDF prior always,
        the shape MLPs under shape_mode=frozen (reference nerfactor.py:60,
        158)."""
        frozen = set(BRDF_PARAM_KEYS)
        if self.shape_mode == 'frozen':
            frozen.update(SHAPE_PARAM_KEYS)
        return {k: ckptutil.tree_map(lambda _, k=k: k not in frozen, v)
                for k, v in params.items()}

    # ------ compute ------

    def light_from(self, params):
        """Non-negative environment light."""
        return torch.clamp(params['light'], min=0.0)

    def pred_albedo_at(self, params, pts):
        """Albedo in [bias, slope + bias]."""
        albedo = self._chain(params, 'albedo_mlp', 'albedo_out',
                             self.plans['albedo'], self.xyz_scale * pts,
                             needs_dx=False)
        return self.albedo_slope * albedo + self.albedo_bias

    def pred_brdf_at(self, params, pts):
        z = self._chain(params, 'brdf_z_mlp', 'brdf_z_out',
                        self.plans['brdf_z'], self.xyz_scale * pts,
                        needs_dx=False)
        if self.normalize_brdf_z:
            z = safe_l2_normalize(z, dim=1)
        return z

    def default_brdf_at(self, pts):
        return self.default_z * torch.ones(
            (pts.shape[0], self.z_dim), dtype=pts.dtype, device=pts.device)

    def eval_spec_at(self, params, pts2l, pts2c, normal, brdf_prop):
        """(N,L,3),(N,3),(N,3),(N,z) -> (N,L) achromatic specular BRDF,
        scaled by ``learned_brdf_scale``, back-lit pairs zeroed."""
        n, l = pts2l.shape[0], pts2l.shape[1]
        world2local = geomops.gen_world2local(normal)  # (N,3,3)
        vdir = torch.einsum('jkl,jl->jk', world2local, pts2c)  # (N,3)
        ldir = torch.einsum('jkl,jnl->jnk', world2local, pts2l)  # (N,L,3)
        ldir_flat = ldir.reshape(-1, 3)
        vdir_flat = vdir[:, None, :].expand(n, l, 3).reshape(-1, 3)
        z_flat = brdf_prop[:, None, :].expand(n, l, self.z_dim).reshape(
            -1, self.z_dim)
        # The BRDF prior is always frozen: its chain's backward computes
        # input cotangents only
        if self.fused_rusink and self.fused_mlp and self.pos_enc_rusink:
            p = fused_mlp.params_from_tree(params['brdf_mlp'],
                                           params['brdf_out'])
            spec_flat = fused_rusink.apply_rusink_chain(
                self.plans['brdf'], z_flat, ldir_flat, vdir_flat, p,
                compute_dtype=self.chain_dtype('brdf'))
        else:
            rusink = geomops.dir2rusink(ldir_flat, vdir_flat)  # (NL,3)
            spec_flat = self._chain(
                params, 'brdf_mlp', 'brdf_out', self.plans['brdf'],
                torch.cat((z_flat, rusink), dim=1),
                compute_dtype=self.chain_dtype('brdf'), needs_dw=False)
        # Zero out back-lit directions (local cos = ldir_z <= 0)
        front_lit = ldir_flat[:, 2:] > 0
        spec = torch.where(front_lit, spec_flat, 0.0).reshape(n, l)
        return spec * self.learned_brdf_scale

    def _finish_render(self, rgb):
        rgb = torch.clamp(rgb, 0.0, 1.0)
        if self.linear2srgb:
            rgb = imgops.linear2srgb(rgb)
        return rgb

    def render(self, params, lvis, spec, albedo, l, n, relight_olat=False,
               relight_probes=False):
        """Rendering equation + optional relights, without building the
        (N, L, 3) contribution tensor: with w = lvis * max(cos, 0) * dOmega
        and s = spec * w, every light contraction is
        ``albedo/pi * (w @ light) + s @ light``; OLAT k is the k-th column
        of (w, s), the ambient term their row sums. All in true f32."""
        cos = torch.einsum('ijk,ik->ij', l, n)  # (N,L)
        front_lit = (cos > 0).to(spec.dtype)
        w = (front_lit * lvis * cos) * self.lareas.reshape(1, -1)  # (N,L)
        s = spec * w  # (N,L)
        lam = albedo / math.pi  # (N,3)
        light_flat = self.light_from(params).reshape(-1, 3)  # (L,3)
        rgb = self._finish_render(lam * (w @ light_flat) + s @ light_flat)
        rgb_olat = None
        if relight_olat:
            w_o = w[:, self.olat_inds]  # (N, n_olat)
            s_o = s[:, self.olat_inds]
            olat = self.olat_inten * (
                lam[:, None, :] * w_o[:, :, None] + s_o[:, :, None])
            if self.ambient_inten > 0:
                ambient = lam * torch.sum(w, dim=1, keepdim=True) \
                    + torch.sum(s, dim=1, keepdim=True)  # (N,3)
                olat = olat + self.ambient_inten * ambient[:, None, :]
            rgb_olat = self._finish_render(olat)  # (N, n_olat, 3)
        rgb_probes = None
        if relight_probes and self.probes_flat is not None:
            pw = torch.einsum('nl,plc->npc', w, self.probes_flat)
            ps = torch.einsum('nl,plc->npc', s, self.probes_flat)
            rgb_probes = self._finish_render(
                lam[:, None, :] * pw + ps)  # (N, P, 3)
        return rgb, rgb_olat, rgb_probes

    # ------ forward ------

    def _forward_rays(self, params, xyz, rayo, normal_init, lvis_init,
                      albedo_scales=None, albedo_override=None,
                      brdf_z_override=None, relight_olat=False,
                      relight_probes=False, jitter_noise=None):
        """Full reflectance forward for a block of rays.

        ``jitter_noise`` (train only): the smoothness probes at
        ``xyz + jitter_noise`` ride the same chain calls as the main rows:
        each head whose smoothness weight is nonzero runs once on 2N
        stacked rows. Their outputs come back under ``*_jitter`` keys."""
        n = xyz.shape[0]
        jit = jitter_noise is not None
        jit_shape = jit and self.shape_mode != 'nerf'
        jit_normal = jit_shape and self.normal_smooth_weight > 0
        jit_lvis = jit_shape and self.lvis_smooth_weight > 0
        jit_albedo = jit and self.albedo_smooth_weight > 0
        jit_brdf = jit and self.pred_brdf and self.brdf_smooth_weight > 0
        if jit:
            xyz_j = xyz + jitter_noise
            xyz_all = torch.cat([xyz, xyz_j], dim=0)

        def stacked(twin_on):
            return xyz_all if twin_on else xyz

        out = {}
        surf2l = self.calc_ldir(xyz)  # (N,L,3)
        surf2c = self.calc_vdir(rayo, xyz)  # (N,3)
        if self.shape_mode == 'nerf':
            normal_pred = normal_init
            # 0 visibility in all directions leads to problematic gradients
            lvis_pred = torch.clamp(lvis_init, 1e-8, 1.0)
        else:
            normal_all = self.pred_normal_at(params, stacked(jit_normal))
            normal_pred = normal_all[:n]
            if jit_normal:
                out['normal_jitter'] = safe_l2_normalize(normal_all[n:],
                                                         dim=1)
            surf2l_in = torch.cat([surf2l, self.calc_ldir(xyz_j)], dim=0) \
                if jit_lvis else surf2l
            lvis_all = self.pred_lvis_at(params, stacked(jit_lvis),
                                         surf2l_in)
            lvis_pred = lvis_all[:n]
            if jit_lvis:
                out['lvis_jitter'] = lvis_all[n:]
        normal_pred = safe_l2_normalize(normal_pred, dim=1)
        albedo_all = self.pred_albedo_at(params, stacked(jit_albedo))
        albedo = albedo_all[:n]
        if jit_albedo:
            out['albedo_jitter'] = albedo_all[n:]
        if albedo_scales is not None:
            albedo = albedo_scales.reshape(1, 3) * albedo
        if albedo_override is not None:
            albedo = albedo_override.expand(albedo.shape)
        if self.pred_brdf:
            brdf_all = self.pred_brdf_at(params, stacked(jit_brdf))
            brdf_prop = brdf_all[:n]
            if jit_brdf:
                out['brdf_prop_jitter'] = brdf_all[n:]
        else:
            brdf_prop = self.default_brdf_at(xyz)
        if brdf_z_override is not None:
            brdf_prop = brdf_z_override.reshape(1, self.z_dim).expand(
                brdf_prop.shape)
        spec = self.eval_spec_at(
            params, surf2l, surf2c, normal_pred, brdf_prop)
        rgb_pred, rgb_olat, rgb_probes = self.render(
            params, lvis_pred, spec, albedo, surf2l, normal_pred,
            relight_olat=relight_olat, relight_probes=relight_probes)
        out.update({'rgb': rgb_pred, 'normal': normal_pred,
                    'lvis': lvis_pred, 'albedo': albedo, 'brdf': brdf_prop})
        if rgb_olat is not None:
            out['rgb_olat'] = rgb_olat
        if rgb_probes is not None:
            out['rgb_probes'] = rgb_probes
        return out

    def _as_tensor(self, x):
        return None if x is None else torch.as_tensor(
            np.asarray(x, np.float32), device=self.device)

    JITTER_KEYS = ('normal_jitter', 'lvis_jitter', 'albedo_jitter',
                   'brdf_prop_jitter')

    def apply(self, params, batch, mode='train', generator=None,
              jitter_noise=None, relight_olat=False, relight_probes=False,
              albedo_scales=None, albedo_override=None,
              brdf_z_override=None):
        """Forward over all rays of ``batch`` (a dict of tensors on the
        model's device). Train mode runs the batch in one block, with the
        smoothness jitter ``xyz_jitter_std * N(0, 1)`` drawn from
        ``generator`` (or given as ``jitter_noise``, already scaled);
        vali/test modes walk chunks of ``eval_ray_chunk`` rays."""
        self._validate_mode(mode)
        albedo_scales = self._as_tensor(albedo_scales)
        albedo_override = self._as_tensor(albedo_override)
        brdf_z_override = self._as_tensor(brdf_z_override)
        xyz = batch['xyz']
        if mode == 'train':
            jitter_noise = self._jitter(xyz, generator, jitter_noise)
            out = self._forward_rays(
                params, xyz, batch['rayo'], batch['normal'], batch['lvis'],
                albedo_scales=albedo_scales, albedo_override=albedo_override,
                brdf_z_override=brdf_z_override, relight_olat=relight_olat,
                relight_probes=relight_probes, jitter_noise=jitter_noise)
        else:
            inputs = {'xyz': xyz, 'rayo': batch['rayo'],
                      'normal': batch['normal'], 'lvis': batch['lvis']}
            # A per-ray albedo edit is chunked with the rays
            per_ray_override = albedo_override is not None \
                and albedo_override.shape[0] == xyz.shape[0] > 1
            if per_ray_override:
                inputs['albedo_override'] = albedo_override

            def forward(tree):
                return self._forward_rays(
                    params, tree['xyz'], tree['rayo'], tree['normal'],
                    tree['lvis'], albedo_scales=albedo_scales,
                    albedo_override=tree['albedo_override']
                    if per_ray_override else albedo_override,
                    brdf_z_override=brdf_z_override,
                    relight_olat=relight_olat,
                    relight_probes=relight_probes)

            out = chunked_apply_tree(forward, inputs, self.eval_ray_chunk)
        loss_kwargs = {'mode': mode}
        for k in self.JITTER_KEYS:
            loss_kwargs[k] = out.get(k)
        pred = {k: out[k] for k in ('rgb', 'normal', 'lvis', 'albedo',
                                    'brdf', 'rgb_olat', 'rgb_probes')
                if k in out}
        gt = {'rgb': batch['rgb'], 'normal': batch['normal'],
              'lvis': batch['lvis'], 'alpha': batch['alpha']}
        to_vis = {'pred_light': self.light_from(params)}
        if self.uses_learned_brdf:
            to_vis['seen_z'] = networks.latent_code_z(
                params['latent_code'], normalize=self.normalize_brdf_z)
        for k, v in pred.items():
            to_vis['pred_' + k] = v
        for k, v in gt.items():
            to_vis['gt_' + k] = v
        return pred, gt, loss_kwargs, to_vis

    # ------ loss ------

    def compute_loss(self, params, pred, gt, mode='train',
                     normal_jitter=None, lvis_jitter=None,
                     albedo_jitter=None, brdf_prop_jitter=None, **kwargs):
        """Reconstruction + geometry respect + smoothness + light priors
        (reference nerfactor.py:463-541); a per-example vector."""
        smooth_loss = mae_lastdim if self.smooth_use_l1 else mse_lastdim
        alpha = gt['alpha']
        bgv = 1.0 if self.white_bg else 0.0

        def blend(x):
            return x * alpha + bgv * (1.0 - alpha)

        loss = mse_lastdim(blend(gt['rgb']), blend(pred['rgb']))
        if mode == 'vali':
            return loss
        if self.shape_mode in ('scratch', 'finetune'):
            normal_pred = blend(pred['normal'])
            lvis_pred = blend(pred['lvis'])
            loss = loss + self.normal_loss_weight * mse_lastdim(
                blend(gt['normal']), normal_pred)
            loss = loss + self.lvis_loss_weight * mse_lastdim(
                blend(gt['lvis']), lvis_pred)
            if normal_jitter is not None:
                loss = loss + self.normal_smooth_weight * smooth_loss(
                    normal_pred, blend(normal_jitter))
            if lvis_jitter is not None:
                loss = loss + self.lvis_smooth_weight * smooth_loss(
                    lvis_pred, blend(lvis_jitter))
        if albedo_jitter is not None:
            loss = loss + self.albedo_smooth_weight * smooth_loss(
                pred['albedo'], albedo_jitter)
        if brdf_prop_jitter is not None:
            loss = loss + self.brdf_smooth_weight * smooth_loss(
                pred['brdf'], brdf_prop_jitter)
        # Light priors: scalar TV terms broadcast onto the batch vector
        light = self.light_from(params)
        if self.light_tv_weight > 0:
            dx = light - torch.roll(light, 1, 1)
            dy = light - torch.roll(light, 1, 0)
            loss = loss + self.light_tv_weight * torch.sum(dx ** 2 + dy ** 2)
        if self.light_achro_weight > 0:
            dc = light - torch.roll(light, 1, 2)
            loss = loss + self.light_achro_weight * torch.sum(dc ** 2)
        return loss

    # ------ host-side vis ------

    def _brdf_prop_as_img(self, brdf_prop, seen_z):
        """BRDF latent code as RGB, normalized by the span of the seen
        (MERL) codes."""
        seen_z_rgb = np.asarray(seen_z)[:, :min(3, self.z_dim)]
        min_, max_ = seen_z_rgb.min(), seen_z_rgb.max()
        range_ = max_ - min_
        if not range_ > 0:
            raise ValueError("Range of seen BRDF Zs is 0")
        z_rgb = brdf_prop[..., :min(3, self.z_dim)]
        z_rgb = (np.clip(z_rgb, min_, max_) - min_) / range_
        if z_rgb.shape[-1] == 1:
            z_rgb = np.concatenate([z_rgb] * 3, axis=-1)
        return z_rgb

    def vis_batch(self, data_dict, outdir, mode='train', light_vis_h=256,
                  olat_vis=False, alpha_thres=0.8):
        """Writes one view's images, as the JAX model's ``vis_batch``:
        pred/gt maps and probe relights (and on ``olat_vis`` the OLAT
        relights and per-light visibility); in vali mode also the
        pred-vs-gt flipbooks and a metadata.json with PSNR and SSIM."""
        self._validate_mode(mode)
        data_dict = dict(data_dict)
        pred_light = np.asarray(data_dict.pop('pred_light'))
        seen_z = np.asarray(data_dict.pop('seen_z')) \
            if 'seen_z' in data_dict else None
        # Same for all views of an epoch; written once
        light_vis_path = join(dirname(outdir), 'pred_light.png')
        if not exists(light_vis_path):
            light_uint = vis_light(pred_light, h=light_vis_h)
            ioutil.write_img(
                light_uint.astype(np.float32) / 255.0, light_vis_path)
        if mode == 'train':
            return
        hw = tuple(int(x) for x in data_dict.pop('hw'))
        id_ = data_dict.pop('id')
        # Flat rays back into images
        imgs = {}
        for k, v in data_dict.items():
            v = np.asarray(v)
            if k in ('pred_rgb_olat', 'pred_rgb_probes'):
                imgs[k] = v.reshape(hw + (v.shape[1], 3))
            elif k.endswith(('rgb', 'albedo', 'normal')):
                imgs[k] = v.reshape(hw + (3,))
            elif k.endswith(('occu', 'depth', 'disp', 'alpha')):
                imgs[k] = v.reshape(hw)
            elif k.endswith('brdf'):
                imgs[k] = v.reshape(hw + (-1,))
            elif k.endswith('lvis'):
                imgs[k] = v.reshape(hw + (v.shape[-1],))
            else:
                raise NotImplementedError(k)
        alpha = imgs['gt_alpha'].copy()
        alpha[alpha < alpha_thres] = 0  # stricter compositing
        lareas = self.lareas.cpu().numpy()
        lareas_upper = lareas[:lareas.shape[0] // 2, :]

        def bg_like(x):
            return np.ones_like(x) if self.white_bg else np.zeros_like(x)

        def composite_on_avg_light(render, light_uint):
            # The upper hemisphere's solid-angle-weighted average light as
            # the background color
            light = imgops.resize(imgops.normalize_uint(light_uint),
                                  new_h=lareas.shape[0])
            light_upper = light[:light.shape[0] // 2, :, :]
            avg = np.array([
                np.average(light_upper[:, :, i], weights=lareas_upper)
                for i in range(3)])
            bg = np.tile(avg[None, None, :], render.shape[:2] + (1,))
            return imgops.alpha_blend(render, alpha, bg)

        img_dict = {}

        def write(k, img):
            img_dict[k] = ioutil.write_img(img, join(outdir, k + '.png'))

        for k, v in imgs.items():
            if k == 'pred_rgb_olat':
                olat_first_n = int(np.prod(self.light_res)) // 2  # top half
                for i, lname in enumerate(self.olat_names[:olat_first_n]):
                    if i >= v.shape[2]:
                        break
                    write(k + '_' + lname, composite_on_avg_light(
                        v[:, :, i, :], self.novel_olat_uint[lname]))
            elif k == 'pred_rgb_probes':
                for i, lname in enumerate(self.probe_names):
                    write(k + '_' + lname, composite_on_avg_light(
                        v[:, :, i, :], self.novel_probes_uint[lname]))
            elif k.endswith('rgb'):
                write(k, imgops.alpha_blend(v, alpha, bg_like(v)))
            elif k.endswith('normal'):
                v_ = (v + 1) / 2
                write(k, imgops.alpha_blend(v_, alpha, bg_like(v_)))
            elif k.endswith('albedo'):
                write(k, imgops.alpha_blend(v ** (1 / 2.2), alpha,
                                            bg_like(v)))
            elif k.endswith('lvis'):
                mean = np.mean(v, axis=2)
                write(k, imgops.alpha_blend(mean, alpha, bg_like(mean)))
                if olat_vis and k == 'pred_lvis':
                    n_olat_vis = 4 if self.debug else v.shape[2] // 2
                    for i in range(min(n_olat_vis, v.shape[2])):
                        ij = np.unravel_index(i, self.light_res)
                        write(k + '_olat_%04d-%04d' % ij, imgops.alpha_blend(
                            v[:, :, i], alpha, bg_like(mean)))
            elif k.endswith('brdf'):
                v_ = self._brdf_prop_as_img(v, seen_z)
                write(k, imgops.alpha_blend(v_, alpha, bg_like(v_)))
            else:
                write(k, v)
        if mode == 'test':
            ioutil.write_json({'id': id_}, join(outdir, 'metadata.json'))
            return
        # Pred-vs-GT flipbooks + PSNR/SSIM metadata (vali)
        font_color = (0, 0, 0) if self.white_bg else (1.0, 1.0, 1.0)

        def lbl(img, text):
            return visutil.put_text(img, text, color=font_color)

        visutil.make_anim(
            (lbl(img_dict['gt_rgb'], "Ground Truth"),
             lbl(img_dict['pred_rgb'], "Prediction")),
            join(outdir, 'pred-vs-gt_rgb.apng'))
        if self.shape_mode != 'nerf':
            for k in ('normal', 'lvis'):
                visutil.make_anim(
                    (lbl(img_dict['gt_' + k], "Initial"),
                     lbl(img_dict['pred_' + k], "Prediction")),
                    join(outdir, 'pred-vs-gt_%s.apng' % k))
        psnr = psnr_fn(img_dict['gt_rgb'], img_dict['pred_rgb'])
        ssim = ssim_fn(img_dict['gt_rgb'], img_dict['pred_rgb'])
        ioutil.write_json({'id': id_, 'psnr': psnr, 'ssim': ssim},
                          join(outdir, 'metadata.json'))

    def compile_batch_vis(self, batch_vis_dirs, outpref, mode='train',
                          fps=12):
        """Vali: one HTML page over the epoch's views; test: the video of
        :meth:`_compile_into_video`. Returns the path written (a video
        falls back to .apng without a codec), or None."""
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
            row = [str(metadata),
                   join(batch_dir, 'pred-vs-gt_rgb.apng'),
                   join(batch_dir, 'pred_rgb.png'),
                   join(batch_dir, 'pred_albedo.png'),
                   join(batch_dir, 'pred_brdf.png')]
            caps = ["Metadata", "RGB", "RGB (pred.)", "Albedo (pred.)",
                    "BRDF (pred.)"]
            if self.shape_mode == 'nerf':
                row += [join(batch_dir, 'gt_normal.png'),
                        join(batch_dir, 'gt_lvis.png')]
                caps += ["Normal (initial)", "Light Visibility (initial)"]
            else:
                row += [join(batch_dir, 'pred-vs-gt_normal.apng'),
                        join(batch_dir, 'pred_normal.png'),
                        join(batch_dir, 'pred-vs-gt_lvis.apng'),
                        join(batch_dir, 'pred_lvis.png')]
                caps += ["Normal", "Normal (pred.)", "Light Visibility",
                         "Light Visibility (pred.)"]
            rows.append((row, caps))
        if not rows:
            raise ValueError("No validation views to compile")
        html = visutil.HTML(
            bgcolor='white' if self.white_bg else 'black',
            text_color='black' if self.white_bg else 'white')
        html.add_header("NeRFactor")
        table = html.add_table()
        for row, caps in rows:
            table.add_row(row, ['text'] + ['image'] * (len(row) - 1),
                          captions=caps)
        return html.save(out_html)

    def _compile_into_video(self, batch_dirs, out_mp4, fps=12):
        """View synthesis under the estimated light (its thumbnail inset),
        the last view's OLAT relights, then the views there and back under
        each probe in turn; returns the path written, or None without
        frames."""
        if self.config.get('dataset') == 'mvs_shape':
            data_root = self.config.get('mvs_root')
        else:
            data_root = self.config.get('data_root')
        batch_dirs = sorted(batch_dirs)
        if self.debug:
            batch_dirs = batch_dirs[:10]
        # The estimated light's thumbnail, which vis_batch saves once
        light_uint = None
        light_png = join(dirname(batch_dirs[0]), 'pred_light.png')
        if exists(light_png):
            light_uint = (ioutil.load_img(light_png) * 255).astype(np.uint8)
        frames = []

        def add(batch_dir, rows, light):
            frame = visutil.make_frame(batch_dir, rows, data_root=data_root,
                                       rgb_embed_light=light)
            if frame is not None:
                frames.append(frame)

        for batch_dir in batch_dirs:
            add(batch_dir, (('normal', 'lvis', 'nn'),
                            ('brdf', 'albedo', 'rgb')), light_uint)
        # Relighting: the OLATs of the final view
        relight_dir = batch_dirs[-1]
        for lvis_path in ioutil.sortglob(relight_dir, 'pred_lvis_olat*.png'):
            olat_id = basename(lvis_path)[len('pred_lvis_olat_'):-len('.png')]
            add(relight_dir, (('normal', 'lvis_olat_%s' % olat_id, 'nn'),
                              ('brdf', 'albedo', 'rgb_olat_%s' % olat_id)),
                self.novel_olat_uint.get(olat_id))
        # Relighting and view synthesis at once: the views there and back,
        # twice, the probes taking equal shares in turn
        if self.probe_names:
            roundtrip = list(reversed(batch_dirs)) + batch_dirs
            roundtrip += roundtrip
            n_per_probe = len(roundtrip) / len(self.probe_names)
            probe_i = 0
            for view_i, batch_dir in enumerate(roundtrip):
                name = self.probe_names[probe_i]
                add(batch_dir, (('normal', 'lvis', 'nn'),
                                ('brdf', 'albedo', 'rgb_probes_%s' % name)),
                    self.novel_probes_uint[name])
                if view_i + 1 > n_per_probe * (probe_i + 1):
                    probe_i += 1
        if frames:
            return visutil.make_video(frames, out_mp4, fps=fps)
        return None
