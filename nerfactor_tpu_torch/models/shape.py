"""Shape model: surface MLPs for normal(xyz) and light visibility(xyz,
ldir) (counterpart of nerfactor_tpu/models/shape.py, the parts the joint
model uses).

The joint NeRFactor model builds on this class for its shape heads and
restores their weights from a shape checkpoint. Both heads run as fused
chains (ops/fused_mlp.py): on the GPU the lvis chain, at rays x lights
scale, is the largest kernel launch of inference and training.
"""

import numpy as np
import torch

from nerfactor_tpu_torch.models.base import BaseModel
from nerfactor_tpu_torch.models import networks
from nerfactor_tpu_torch.ops import encoding
from nerfactor_tpu_torch.ops import fused_mlp
from nerfactor_tpu_torch.ops.light import gen_light_xyz
from nerfactor_tpu_torch.ops.math import safe_l2_normalize


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
        if self.config.get('mvs_root', fallback=None) is not None:
            raise NotImplementedError(
                "MVS light locations (mvs_root) are not ported yet "
                "(ROADMAP.md, Queue 1, variants)")
        light_h = self.config.getint('light_h')
        return gen_light_xyz(light_h, 2 * light_h)

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
        return {name: spec.init(generator)
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
