"""Learned latent-code BRDF prior over the MERL database (counterpart of
nerfactor_tpu/models/brdf.py; the stage ``brdf.ini`` trains).

A GLO latent table assigns each MERL material a code z; an MLP maps z (+)
posenc(Rusinkiewicz angles) to a softplus reflectance. Training enforces
Helmholtz reciprocity by also evaluating the (phi_d + pi) twin, stacked
along the batch into the same MLP pass, against the same target, and the
loss compares log- or divide-transformed reflectance. The MLP is plain f32
PyTorch on any device, as the JAX package runs it on XLA (brdf.ini has no
``fused_mlp``).
"""

import functools
import math
from os.path import basename, exists, join

import numpy as np
import torch

from nerfactor_tpu_torch.brdf import merl
from nerfactor_tpu_torch.brdf.renderer import SphereRenderer
from nerfactor_tpu_torch.models.base import BaseModel
from nerfactor_tpu_torch.models import networks
from nerfactor_tpu_torch.ops import encoding
from nerfactor_tpu_torch.utils import (
    ckpt as ckptutil, io as ioutil, vis as visutil)
from nerfactor_tpu_torch.utils.logging import Logger

logger = Logger(loggee="models/brdf")


N_VIS = 64  # rows of reflectance in a log10 chart
FPS = 2  # of the interpolation video


@functools.lru_cache(maxsize=1)
def sphere_renderer(envmap_h, ims, spp):
    """The test-time sphere renderer under the 'point' light; the same
    for every identity of a test table, so it is built once."""
    return SphereRenderer('point', None, envmap_h=envmap_h, envmap_inten=40,
                          ims=ims, spp=spp)


class Model(BaseModel):
    def __init__(self, config, debug=False, device='cuda'):
        super().__init__(config, debug=debug, device=device)
        self.n_freqs = config.getint('n_freqs')
        self.pos_enc = config.getboolean('pos_enc')
        self.z_dim = config.getint('z_dim')
        self.z_gauss_mean = config.getfloat('z_gauss_mean')
        self.z_gauss_std = config.getfloat('z_gauss_std')
        self.normalize_z = config.getboolean('normalize_z')
        rusink_dims = encoding.embed_dims(3, self.n_freqs) if self.pos_enc \
            else 3
        self.mlp_spec = networks.MLPSpec(
            self.z_dim + rusink_dims, [config.getint('mlp_width')]
            * config.getint('mlp_depth'), acts='relu',
            skip_at=[config.getint('mlp_skip_at')])
        self.out_spec = networks.MLPSpec(
            self.mlp_spec.out_dim, [1], acts='softplus')
        # BRDF identities from the data dir
        train_npz = ioutil.sortglob(config.get('data_root'), 'train_*.npz')
        self.brdf_names = [
            basename(x)[len('train_'):-len('.npz')] for x in train_npz]
        self.loss_transform = config.get('loss_transform', fallback='log')

    # ------ params ------

    def init_params(self, generator):
        params = {
            'brdf_mlp': self.mlp_spec.init(generator),
            'brdf_out': self.out_spec.init(generator),
            'latent_code': networks.init_latent_code(
                generator, max(len(self.brdf_names), 1), self.z_dim,
                mean=self.z_gauss_mean, std=self.z_gauss_std)}
        return ckptutil.tree_map(lambda t: t.to(self.device), params)

    # ------ compute ------

    def eval_brdf(self, params, z, rusink):
        """(N, z_dim) x (N, 3) -> (N, 1) reflectance."""
        embed = encoding.posenc(rusink, self.n_freqs) if self.pos_enc \
            else rusink
        feat = self.mlp_spec.apply(params['brdf_mlp'],
                                   torch.cat((z, embed), dim=-1))
        return self.out_spec.apply(params['brdf_out'], feat)

    def lookup_z(self, params, i):
        """Latent code(s) of the identity index tensor ``i``."""
        return networks.latent_code_lookup(
            params['latent_code'], i, normalize=self.normalize_z)

    def interp_z(self, params, w1, i1, w2, i2):
        return networks.latent_code_interp(
            params['latent_code'], w1, i1, w2, i2,
            normalize=self.normalize_z)

    def apply(self, params, batch, mode='train', z_override=None, **kwargs):
        """``batch`` carries 'rusink' (B, 3), 'refl' (B, 1) and the
        identity index 'i' (a scalar). Test-time identities (seen or
        interpolated) come in as ``z_override`` (B or 1, z_dim). Other
        keyword arguments (the trainer's jitter source) are unused."""
        self._validate_mode(mode)
        rusink, refl = batch['rusink'], batch['refl']
        n = rusink.shape[0]
        if z_override is not None:
            z = z_override.expand(n, self.z_dim)
        else:
            i = torch.as_tensor(batch['i'], device=rusink.device)
            z = self.lookup_z(params, i.long().expand(n))
        # The reciprocity twin shares the MLP pass: stacked along the batch
        rusink_reci = torch.cat((rusink[:, :1] + math.pi, rusink[:, 1:]),
                                dim=1)
        both = self.eval_brdf(params, torch.cat((z, z), dim=0),
                              torch.cat((rusink, rusink_reci), dim=0))
        brdf, brdf_reci = both[:n], both[n:]
        pred = {'brdf': brdf, 'brdf_reci': brdf_reci}
        gt = {'brdf': refl}
        to_vis = {'z': z, 'brdf': brdf, 'brdf_reci': brdf_reci,
                  'gt_brdf': refl}
        return pred, gt, {}, to_vis

    def _transform(self, x):
        if self.loss_transform.lower() == 'none':
            return x
        if self.loss_transform == 'log':
            return torch.log(torch.clamp(x, min=1e-12))
        if self.loss_transform == 'divide':
            return x / (x + 1.0)
        raise NotImplementedError(self.loss_transform)

    def compute_loss(self, params, pred, gt, **kwargs):
        f = self._transform
        loss = 0.0
        for weight, loss_func in self.wloss:
            for k in ('brdf', 'brdf_reci'):
                loss = loss + weight * loss_func(f(gt['brdf']), f(pred[k]),
                                                 keep_batch=True)
        return loss

    # ------ host-side vis ------

    def vis_batch(self, data_dict, outdir, mode='train'):
        """One identity's latent code and log10 reflectance as bar charts
        (vali: beside the ground truth); in test mode also the
        characteristic slice and a sphere render, where the test table
        holds the reference's [slice rows | render rows] layout."""
        self._validate_mode(mode)
        if mode == 'train':
            return
        ioutil.write_json({'id': data_dict['id']},
                          join(outdir, 'metadata.json'))
        visutil.bar_chart(np.asarray(data_dict['z'])[0],
                          join(outdir, 'z.png'))
        pred = np.asarray(data_dict['brdf'])
        brdf_val = np.hstack((np.asarray(data_dict['brdf_reci']), pred))
        if mode == 'vali':
            brdf_val = np.hstack((brdf_val, np.asarray(data_dict['gt_brdf'])))
        step = max(1, int(brdf_val.shape[0] / N_VIS))
        brdf_val = np.log10(np.maximum(brdf_val[::step, :], 1e-12))
        visutil.bar_chart(brdf_val.T, join(outdir, 'log10_brdf.png'))
        if mode == 'vali':
            return
        renderer = sphere_renderer(int(data_dict['envmap_h']),
                                   int(data_dict['ims']),
                                   int(data_dict['spp']))
        cslice_shape = merl.BRDF_SHAPE[1:]
        cslice_end_i = int(np.prod(cslice_shape))
        lvis = renderer.lvis.astype(bool)
        n_render = int(lvis.sum())
        if pred.shape[0] != cslice_end_i + n_render:
            # Not the reference's test layout (merl/make_dataset.py:54-69
            # there), e.g. a synthetic rusink grid: the bar charts stand
            logger.warn(
                "Test rusink rows (%d) != cslice+render layout (%d+%d);"
                " skipping slice/render visualization",
                pred.shape[0], cslice_end_i, n_render)
            return
        cslice = pred[:cslice_end_i, :].reshape(cslice_shape)
        ioutil.write_img(merl.characteristic_slice_as_img(cslice),
                         join(outdir, 'cslice.png'))
        brdf_map = np.zeros_like(renderer.lcontrib)
        brdf_map[lvis] = pred[cslice_end_i:, :]
        ioutil.write_img(np.clip(renderer.render(brdf_map), 0, 1),
                         join(outdir, 'render.png'))

    def compile_batch_vis(self, batch_vis_dirs, outpref, mode='train'):
        """An HTML page over the identities; in test mode also the
        interpolation video over the interpolated identities' renders.
        Returns where to view them."""
        self._validate_mode(mode)
        if mode == 'train':
            return None
        rows = []
        for batch_dir in batch_vis_dirs:
            metadata = ioutil.read_json(join(batch_dir, 'metadata.json'))
            row = [str(metadata), join(batch_dir, 'z.png'),
                   join(batch_dir, 'log10_brdf.png')]
            caps = ["Metadata", "Latent Code", "BRDF (log-scale)"]
            if mode == 'test':
                # Absent when the test table lacks the slice + render layout
                for png, cap in (('cslice.png', "Pred. (char. slice)"),
                                 ('render.png', "Pred. (render)")):
                    if exists(join(batch_dir, png)):
                        row.append(join(batch_dir, png))
                        caps.append(cap)
            rows.append((row, caps))
        if not rows:
            raise ValueError("No identities to compile")
        html = visutil.HTML()
        html.add_header("BRDF-MLP")
        table = html.add_table()
        for row, caps in rows:
            table.add_row(row, ['text'] + ['image'] * (len(row) - 1),
                          captions=caps)
        out_html = outpref + '.html'
        html.save(out_html)
        viewer_prefix = self.config.get('viewer_prefix', fallback='')
        view_at = viewer_prefix + out_html
        if mode == 'vali':
            return view_at
        # Interpolation video over the interpolated identities, in order
        frames = []
        for batch_dir in batch_vis_dirs:
            id_ = ioutil.read_json(join(batch_dir, 'metadata.json'))['id']
            render_path = join(batch_dir, 'render.png')
            if '_' not in id_ or not exists(render_path):
                continue
            frame = ioutil.load_img(render_path)
            frames.append((int(id_.split('_')[0]),
                           (frame * 255).astype(np.uint8)))
        if frames:
            outvid = visutil.make_video(
                [f for _, f in sorted(frames, key=lambda p: p[0])],
                outpref + '.mp4', fps=FPS)
            view_at += '\n\t%s' % (viewer_prefix + outvid)
        return view_at
