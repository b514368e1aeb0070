"""Distills a trained NeRF into per-view geometry buffers on PyTorch:
alpha, surface xyz, normals (the negated, normalised sigma gradient) and
light visibility (counterpart of nerfactor_tpu/geometry_from_nerf.py, same
CLI plus ``--device``):

  python -m nerfactor_tpu_torch.geometry_from_nerf \\
      --trained_nerf=/out/lego/lr1e-4 --data_root=/data/lego \\
      --out_root=/out/lego_geom --imh=256 --light_h=16 [--spp=1] \\
      [--device=cuda]

The latest ``ckpt-N`` under ``<trained_nerf>/checkpoints`` is restored
through ``utils/ckpt.py``, so a checkpoint the JAX package wrote loads as
one the port wrote. ``--device`` picks the torch device: on ``cuda`` the
sigma chain runs through kernel K1 (``ops/fused_mlp.py``): the visibility
march's forwards in bf16 on the tensor cores (``--bf16_march``, the
default; transmittance accumulates in f32), the depth/normal pass's
forwards and its input cotangent (K1-bwd with dx alone: the weights are
frozen) in f32 on the CUDA cores. ``cpu`` runs their plain versions.

Against the JAX package:
  * both passes walk blocks of the JAX package's sizes (``ray_block``,
    ``pair_block``) in a plain loop that never waits on the card: block
    i + 1 is issued before block i's result is copied (``non_blocking``)
    into pinned host memory, and the host waits once, at the end. The
    JAX package's ``lax.map`` supers with their lag-1 conversion, and the
    static-shape padding, exist for TPU dispatch: every row of the chain
    is independent, so the last block is simply short;
  * no rays (or no hit pixels) give empty outputs; the JAX
    ``_super_mapped`` builds a wrongly shaped operand for them;
  * :meth:`AsyncWriter.close` raises when the writer thread died without
    recording an error (a BaseException in a write); the JAX one returns
    silently;
  * ``--lpix_chunk`` is accepted and unused, as in the JAX package: all
    light pixels of a block go in one pass.
"""

import argparse
import os
import queue
import threading
import time
from os.path import join, basename, exists

import numpy as np
import torch

from nerfactor_tpu_torch import datasets, models
from nerfactor_tpu_torch.ops import img as imgops, sampling
from nerfactor_tpu_torch.ops.light import gen_light_xyz
from nerfactor_tpu_torch.utils import buffers, ckpt as ckptutil
from nerfactor_tpu_torch.utils import config as configutil, io as ioutil
from nerfactor_tpu_torch.utils import trace
from nerfactor_tpu_torch.utils.logging import Logger

logger = Logger(loggee="geometry_from_nerf")

# A pass over blocks and its parts on the host (utils/trace.py: recorded
# while a torch profiler runs)
DISTILL = trace.span('program.distill')
DISTILL_INPUTS = trace.span('program.distill.inputs')
DISTILL_BLOCK = trace.span('program.distill.block')
DISTILL_COPY_OUT = trace.span('program.distill.copy_out')
DISTILL_WAIT = trace.span('program.distill.wait')

BUFFER_FILES = ('alpha.png', 'lvis.npy', 'lvis.png', 'normal.npy',
                'normal.png', 'xyz.npy', 'xyz.png')


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument('--trained_nerf', required=True,
                   help="trained NeRF dir up to and incl. the lr folder")
    p.add_argument('--data_root', default='', help="input data root")
    p.add_argument('--out_root', required=True, help="output root")
    p.add_argument('--imh', type=int, default=None)
    p.add_argument('--scene_bbox', default=None,
                   help="x_min,x_max,y_min,y_max,z_min,z_max for real scenes")
    p.add_argument('--lvis_far', type=float, default=1.0)
    p.add_argument('--occu_thres', type=float, default=0.0)
    p.add_argument('--light_h', type=int, default=16)
    p.add_argument('--mlp_chunk', type=int, default=1_048_576,
                   help="flattened sample rows per depth/normal block")
    p.add_argument('--lpix_chunk', type=int, default=1,
                   help="accepted for CLI parity; unused (all light "
                        "pixels are marched in one pass)")
    p.add_argument('--spp', type=int, default=1)
    p.add_argument('--lvis_dtype', default='float32',
                   choices=['float32', 'float16'],
                   help="on-disk dtype of lvis.npy (f16 halves the "
                        "largest buffer; loaders accept both)")
    p.add_argument('--fps', type=int, default=12)
    p.add_argument('--bf16_march', action=argparse.BooleanOptionalAction,
                   default=True,
                   help="run the sigma evaluations of the visibility march "
                        "in bf16 (no gradients; transmittance accumulates "
                        "in f32; the differentiated depth/normal pass "
                        "always runs f32)")
    p.add_argument('--view_shard', default='0/1',
                   help="'i/n': process only every n-th view starting at "
                        "i; distillation is independent per view, so n "
                        "processes or hosts each run one shard")
    p.add_argument('--debug', action='store_true')
    p.add_argument('--device', default='cuda', help="torch device")
    return p.parse_args(argv)


def _parse_bbox(scene_bbox):
    if not scene_bbox:
        return None
    vals = [float(x) for x in scene_bbox.split(',')]
    if len(vals) != 6:
        raise ValueError("scene_bbox needs 6 comma-separated floats, got %r"
                         % scene_bbox)
    return np.array(vals, np.float32)


def _in_bounds_mask(pts, bbox):
    """Whether each point of ``pts`` (..., 3) lies in ``bbox`` (6 floats:
    x_min, x_max, y_min, y_max, z_min, z_max; None: everywhere)."""
    if bbox is None:
        return torch.ones(pts.shape[:-1], dtype=torch.bool, device=pts.device)
    lo, hi = [float(v) for v in bbox[0::2]], [float(v) for v in bbox[1::2]]
    inside = [(pts[..., c] >= lo[c]) & (pts[..., c] <= hi[c])
              for c in range(3)]
    return inside[0] & inside[1] & inside[2]


class GeometryDistiller:
    """The restored NeRF and the two passes of distillation, each over
    blocks of rays (depth and normal) or of surface points x lights
    (visibility) on the model's device."""

    def __init__(self, model, params, config, args):
        self.model = model
        self.params = params
        self.args = args
        self.device = torch.device(model.device)
        self.bbox = _parse_bbox(args.scene_bbox)
        self.near = config.getfloat('near')
        self.far = config.getfloat('far')
        self.lin_in_disp = config.getboolean('lin_in_disp')
        # As the reference, distillation adds 64 to both sample counts
        # (geometry_from_nerf.py:250-251, 178-179)
        self.n_coarse = 64 + config.getint('n_samples_coarse')
        self.n_fine = 64 + config.getint('n_samples_fine')
        lxyz, _ = gen_light_xyz(args.light_h, 2 * args.light_h)
        self.lxyz = torch.as_tensor(lxyz.reshape(-1, 3), dtype=torch.float32,
                                    device=self.device)
        self.n_lights = self.lxyz.shape[0]
        # The JAX package's block sizes: mlp_chunk sample rows a
        # depth/normal block; 8 x mlp_chunk rows a visibility block, of
        # whole surface points (all their lights)
        n_samples = max(self.n_coarse + self.n_fine, 1)
        self.ray_block = max(512, args.mlp_chunk // n_samples)
        self.pair_block = max(256, 8 * args.mlp_chunk // n_samples)
        self.lvis_block_pts = max(1, self.pair_block // self.n_lights)

    def _map_blocks(self, fn, inputs, block, widths):
        """``fn`` over consecutive ``block``-row slices of ``inputs``
        ((n, ...) host arrays, moved to the device once), the last slice
        short; returns fn's outputs over all n rows as float32 numpy
        arrays of shapes (n,) + ``widths[i]``. The host never waits on a
        block: block i + 1 is issued before block i's outputs are copied
        (non-blocking) into pinned host memory, and the one wait is at the
        end. The call is the span ``program.distill``, its parts
        ``program.distill.{inputs,block,copy_out,wait}``; the class's
        counters count the rows (``points``) and the bytes moved to the
        device and back."""
        with DISTILL:
            n = inputs[0].shape[0]
            on_card = self.device.type == 'cuda'
            outs = [torch.empty((n,) + tuple(w), dtype=torch.float32,
                                pin_memory=on_card) for w in widths]
            if n:
                with DISTILL_INPUTS:
                    inputs = [np.asarray(a, np.float32) for a in inputs]
                    GeometryDistiller.h2d_bytes += sum(a.nbytes
                                                       for a in inputs)
                    inputs = [torch.as_tensor(a).to(self.device)
                              for a in inputs]
                pending = None
                for i in range(0, n, block):
                    with DISTILL_BLOCK:
                        res = fn(*(a[i:i + block] for a in inputs))
                    if pending is not None:
                        self._copy_out(outs, *pending)
                    pending = (i, res)
                self._copy_out(outs, *pending)
                GeometryDistiller.points += n
                if on_card:
                    with DISTILL_WAIT:
                        torch.cuda.current_stream(self.device).synchronize()
            return tuple(o.numpy() for o in outs)

    @staticmethod
    def _copy_out(outs, start, res):
        with DISTILL_COPY_OUT:
            for out, r in zip(outs, res):
                dst = out[start:start + r.shape[0]]
                dst.copy_(r, non_blocking=True)
                GeometryDistiller.d2h_bytes += dst.nbytes

    def _sigma_with_bounds(self, pts, use_fine, compute_dtype=None):
        """ReLU'd sigma (N, 1) at ``pts`` (N, 3), zero outside the scene
        bbox."""
        sigma = torch.relu(self.model.eval_sigma(
            self.params, pts, use_fine=use_fine, compute_dtype=compute_dtype))
        if self.bbox is not None:
            inside = _in_bounds_mask(pts, self.bbox)
            sigma = torch.where(inside[:, None], sigma,
                                torch.zeros_like(sigma))
        return sigma

    # ------ camera -> object ------

    def depth_normal_block(self, rayo, rayd):
        """(B, 3) x2 -> occupancy (B,), expected depth (B,) and expected
        normal (B, 3). The fine level's sigma and its gradient w.r.t. the
        points come from one backward pass: sigma at a point depends on
        that point alone, so the gradient of the sum is each point's own."""
        rayd = rayd / torch.clamp(torch.linalg.norm(rayd, dim=1, keepdim=True),
                                  min=1e-12)
        n = rayo.shape[0]
        with torch.no_grad():
            z = sampling.gen_z(self.near, self.far, self.n_coarse, n,
                               lin_in_disp=self.lin_in_disp,
                               device=rayo.device)
            pts = rayo[:, None, :] + rayd[:, None, :] * z[:, :, None]
            sigma = self._sigma_with_bounds(
                pts.reshape(-1, 3), use_fine=False).reshape(n, self.n_coarse)
            weights = sampling.accumulate_sigma(sigma, z, rayd)
            z = sampling.gen_z_fine(z, weights, self.n_fine)
            pts = (rayo[:, None, :] + rayd[:, None, :] * z[:, :, None]
                   ).reshape(-1, 3)
        with torch.enable_grad():
            pts.requires_grad_(True)
            sigma = self._sigma_with_bounds(pts, use_fine=True)
            grads, = torch.autograd.grad(sigma.sum(), pts)
        with torch.no_grad():
            normal = -grads / torch.clamp(
                torch.linalg.norm(grads, dim=1, keepdim=True), min=1e-12)
            n_total = z.shape[1]
            weights = sampling.accumulate_sigma(
                sigma.detach().reshape(n, n_total), z, rayd)
            occu = torch.sum(weights, dim=-1)
            exp_depth = torch.sum(weights * z, dim=-1)
            exp_normal = torch.einsum(
                'nsc,ns->nc', normal.reshape(n, n_total, 3), weights)
        return occu, exp_depth, exp_normal

    def compute_depth_and_normal(self, rayo, rayd):
        """(n, 3) host rays -> occupancy (n,), depth (n,), normal (n, 3)
        numpy, over blocks of ``ray_block`` rays."""
        return self._map_blocks(self.depth_normal_block, [rayo, rayd],
                                self.ray_block, [(), (), (3,)])

    # ------ object -> light ------

    def lvis_block(self, surf, normal):
        """(S, 3) x2 -> (S, L) light visibility: every light of the block's
        surface points marched in one batch, zero where the light is behind
        the surface."""
        s = surf.shape[0]
        with torch.no_grad():
            surf2l = self.lxyz[None, :, :] - surf[:, None, :]  # (S, L, 3)
            surf2l = surf2l / torch.clamp(
                torch.linalg.norm(surf2l, dim=-1, keepdim=True), min=1e-12)
            front_lit = torch.einsum('slc,sc->sl', surf2l, normal) > 0
            o = surf[:, None, :].expand(surf2l.shape).reshape(-1, 3)
            d = surf2l.reshape(-1, 3)
            n_pairs = s * self.n_lights
            march_dt = torch.bfloat16 if self.args.bf16_march else None
            z = sampling.gen_z(0.1, self.args.lvis_far, self.n_coarse,
                               n_pairs, lin_in_disp=self.lin_in_disp,
                               device=surf.device)
            pts = (o[:, None, :] + d[:, None, :] * z[:, :, None]).reshape(-1, 3)
            sigma = self._sigma_with_bounds(
                pts, use_fine=False, compute_dtype=march_dt).reshape(
                    n_pairs, self.n_coarse)
            weights = sampling.accumulate_sigma(sigma, z, d)
            z = sampling.gen_z_fine(z, weights, self.n_fine)
            pts = (o[:, None, :] + d[:, None, :] * z[:, :, None]).reshape(-1, 3)
            sigma = self._sigma_with_bounds(
                pts, use_fine=True, compute_dtype=march_dt).reshape(
                    n_pairs, z.shape[1])
            weights = sampling.accumulate_sigma(sigma, z, d)
            lvis = 1.0 - torch.sum(weights, dim=-1).reshape(s, self.n_lights)
            return (torch.where(front_lit, lvis, torch.zeros_like(lvis)),)

    def compute_light_visibility(self, surf, normal):
        """(n, 3) host surface points and normals -> (n, L) visibility in
        [0, 1], over blocks of ``lvis_block_pts`` points."""
        lvis, = self._map_blocks(self.lvis_block, [surf, normal],
                                 self.lvis_block_pts, [(self.n_lights,)])
        return np.clip(lvis, 0.0, 1.0)


trace.counters(GeometryDistiller, 'points', 'h2d_bytes', 'd2h_bytes')


class AsyncWriter:
    """One background thread for the per-view buffer writes, so PNG and
    video encoding and the H x W x 512 lvis.npy write overlap the next
    view's device work. ``maxsize`` bounds the lvis buffers in flight."""

    def __init__(self, maxsize=2):
        self._q = queue.Queue(maxsize=maxsize)
        self._err = None
        self._finished = False
        self._t = threading.Thread(target=self._run, daemon=True)
        self._t.start()

    def _run(self):
        while True:
            fn = self._q.get()
            if fn is None:
                self._finished = True
                return
            try:
                fn()
            except Exception as e:  # re-raised on the main thread
                logger.error("Background buffer write failed: %r", e)
                if self._err is None:  # keep the first failure
                    self._err = e

    def _check_alive(self):
        if not self._t.is_alive():
            raise RuntimeError(
                "Background writer thread died (BaseException in a buffer "
                "write); see the log above")

    def submit(self, fn):
        if self._err is not None:
            raise self._err
        # A BaseException escaping a write kills the worker without
        # setting _err: a full queue would then block forever
        while True:
            self._check_alive()
            try:
                self._q.put(fn, timeout=5)
                return
            except queue.Full:
                continue

    def close(self):
        """Waits for the queued writes; raises the first write's error, or
        RuntimeError if the worker died of a BaseException."""
        while self._t.is_alive():
            try:
                self._q.put(None, timeout=5)
                break
            except queue.Full:
                continue
        self._t.join()
        if self._err is not None:
            raise self._err
        if not self._finished:
            self._check_alive()


def average_supersamples(map_ss, sps):
    if sps == 1:
        return map_ss
    maps = [map_ss[i::sps, j::sps, ...]
            for i in range(sps) for j in range(sps)]
    return np.mean(np.stack(maps, axis=0), axis=0)


def process_view(distiller, batch, out_root, args, writer=None):
    """Distils one view's buffers under ``out_root/<id>/`` (skipped when
    they are all there). Returns its record (id, rays, hit pixels, seconds
    of each pass), or None when skipped."""
    sps = int(np.sqrt(args.spp))
    id_ = batch['id']
    hw = tuple(int(x) for x in batch['hw'])
    rayo = np.asarray(batch['rayo'], np.float32)
    rayd = np.asarray(batch['rayd'], np.float32)
    rayd = rayd / np.linalg.norm(rayd, axis=1, keepdims=True)

    out_dir = join(out_root, id_)
    os.makedirs(out_dir, exist_ok=True)
    if all(exists(join(out_dir, f)) for f in BUFFER_FILES):
        logger.info("Skipping %s since it's done already", id_)
        return None

    t0 = time.perf_counter()
    occu, exp_depth, exp_normal = distiller.compute_depth_and_normal(
        rayo, rayd)
    t_dn = time.perf_counter() - t0
    occu = np.where(occu < args.occu_thres, 0.0, occu)

    hw_ss = (hw[0] * sps, hw[1] * sps)
    alpha_map = average_supersamples(occu.reshape(hw_ss), sps)
    alpha_map = np.clip(alpha_map, 0.0, 1.0)

    surf = rayo + rayd * exp_depth[:, None]
    xyz_map = average_supersamples(surf.reshape(hw_ss + (3,)), sps)
    xyz_map = imgops.alpha_blend(xyz_map, alpha_map)

    normal_map = average_supersamples(exp_normal.reshape(hw_ss + (3,)), sps)
    # Background normals are (0, 1, 0): (0, 0, 0) would give zero tangents
    # downstream (reference geometry_from_nerf.py:140-144)
    normal_bg = np.tile(np.array([0.0, 1.0, 0.0], np.float32),
                        hw + (1,)).reshape(hw + (3,))
    normal_map = imgops.alpha_blend(normal_map, alpha_map, normal_bg)
    norm = np.linalg.norm(normal_map, axis=2, keepdims=True)
    normal_map = normal_map / np.maximum(norm, 1e-12)
    normal_map = np.clip(normal_map, -1.0, 1.0)

    # Surface -> light visibility, for hit pixels only
    hit = alpha_map.reshape(-1) > 0
    surf_hit = average_supersamples(surf.reshape(hw_ss + (3,)), sps)
    surf_hit = surf_hit.reshape(-1, 3)[hit]
    normal_hit = normal_map.reshape(-1, 3)[hit]
    t1 = time.perf_counter()
    lvis_hit = distiller.compute_light_visibility(surf_hit, normal_hit)
    t_lvis = time.perf_counter() - t1
    logger.info(
        "%s: depth/normal %.1f s (%d rays), lvis %.1f s (%d hit pts x "
        "%d dirs), host glue %.1f s", id_, t_dn, rayo.shape[0], t_lvis,
        int(surf_hit.shape[0]), distiller.n_lights, t1 - t0 - t_dn)
    lvis = np.zeros(hw + (distiller.n_lights,), dtype=np.float32)
    lvis[hit.reshape(hw)] = lvis_hit
    lvis *= alpha_map.reshape(hw + (1,))

    def write_all():
        buffers.write_alpha(alpha_map, out_dir)
        buffers.write_xyz(xyz_map, out_dir)
        buffers.write_normal(normal_map, out_dir)
        buffers.write_lvis(lvis, args.fps, out_dir,
                           dtype=np.dtype(args.lvis_dtype))

    if writer is None:
        write_all()
    else:
        writer.submit(write_all)
    return {'id': id_, 'rays': int(rayo.shape[0]),
            'hit_pixels': int(hit.sum()), 'depth_normal_s': t_dn,
            'lvis_s': t_lvis}


def latest_checkpoint(trained_nerf):
    """The ``ckpt-N`` prefix of the highest N under the run's checkpoints."""
    ckpts = ioutil.sortglob(join(trained_nerf, 'checkpoints'), 'ckpt-*.npz')
    if not ckpts:
        raise FileNotFoundError("No checkpoint under %s" % trained_nerf)
    steps = [int(basename(x)[len('ckpt-'):-len('.npz')]) for x in ckpts]
    return ckpts[int(np.argmax(steps))][:-len('.npz')]


def load_distiller(args):
    """The :class:`GeometryDistiller` of parsed ``args`` on
    ``args.device``: the NeRF run's config with ``--imh`` and
    ``--data_root`` applied, its model and the latest checkpoint's
    weights. Returns (distiller, config, the checkpoint's prefix)."""
    device = torch.device(args.device)
    latest_ckpt = latest_checkpoint(args.trained_nerf)
    parser = configutil.read_config(configutil.get_config_ini(latest_ckpt))
    if args.imh is not None:
        parser.set('DEFAULT', 'imh', str(args.imh))
    if args.data_root:
        parser.set('DEFAULT', 'data_root', args.data_root)
    config = configutil.Config(parser)
    Model = models.get_model_class(config.get('model'))
    model = Model(config, device=device)
    params = ckptutil.restore_trained_params(
        latest_ckpt, model.init_params(torch.Generator().manual_seed(0)),
        device=device)
    return GeometryDistiller(model, params, config, args), config, latest_ckpt


def main(argv=None):
    """Distils every view (of this process's shard); returns {'ckpt',
    'views': each processed view's record (see :func:`process_view`)}."""
    args = parse_args(argv)
    shard_i, shard_n = (int(x) for x in args.view_shard.split('/'))
    if not 0 <= shard_i < shard_n:
        raise ValueError("--view_shard must be 'i/n' with 0 <= i < n, got %r"
                         % args.view_shard)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    distiller, config, latest_ckpt = load_distiller(args)

    Dataset = datasets.get_dataset_class(config.get('dataset'))
    view_i = 0
    records = []
    writer = AsyncWriter()
    try:
        for mode in ('train', 'vali', 'test'):
            try:
                dataset = Dataset(config, mode, always_all_rays=True,
                                  spp=args.spp)
            except FileNotFoundError:
                logger.warn("No '%s' views; skipping", mode)
                continue
            t_prev = time.perf_counter()
            for batch in dataset.build_pipeline(no_shuffle=True):
                mine = view_i % shard_n == shard_i
                view_i += 1
                if not mine:
                    continue
                t_loaded = time.perf_counter()
                rec = process_view(distiller, batch, args.out_root, args,
                                   writer=writer)
                t_done = time.perf_counter()
                logger.info("%s: view wall %.1f s (data load %.1f s)",
                            batch['id'], t_done - t_prev, t_loaded - t_prev)
                t_prev = t_done
                if rec is not None:
                    records.append(dict(rec, wall_s=t_done - t_loaded))
                if args.debug:
                    break
    finally:
        writer.close()
    return {'ckpt': latest_ckpt, 'views': records}


if __name__ == '__main__':
    main()
