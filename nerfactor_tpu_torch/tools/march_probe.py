"""Timing probe of geometry distillation's two passes on random NeRF
weights (counterpart of tools/march_probe.py; the throughput does not
depend on trained values):

  * ``lvis_march_torch``: ``GeometryDistiller.compute_light_visibility``,
    seconds per 4096 surface points x 512 light directions;
  * ``depth_normal_torch``: ``compute_depth_and_normal``, seconds per 16384
    rays.

By default at nerf.ini's full width (8 x 256 trunk, 64 + 128 samples ->
128 + 192 for distillation, mlp_chunk 1,048,576); ``--jax_shapes`` takes
the JAX tool's shapes instead (128 wide, 32 + 64 -> 96 + 128 samples,
``--mlp_chunk`` 262,144). Both use light_h 16 (512 directions), near 2,
far 6, lvis_far 2.5, bf16 march: surface points on the unit sphere with
outward normals, rays from (0, 0, 4) downward.

Each pass is warmed on one block, then timed over all its points or rays
(host clock; the pass ends in a wait on the card), then profiled over
PROFILE_BLOCKS blocks for the device's busy time and idle share and its
time by kernel. Each stage prints one JSON line, with the card's name
and power limit. ``--device cpu`` runs the plain versions as a check of
the tool; it measures nothing of the card.

    python -m nerfactor_tpu_torch.tools.march_probe [--jax_shapes]
    python -m nerfactor_tpu_torch.tools.march_probe --device cpu \\
        --n_surf 2 --light_h 1 --n_rays 8
"""

import argparse
import json
import time

import numpy as np
import torch

from nerfactor_tpu_torch import geometry_from_nerf as geo
from nerfactor_tpu_torch.models.nerf import Model as NerfModel
from nerfactor_tpu_torch.ops import fused_mlp as fm
from nerfactor_tpu_torch.utils import card, config as configutil

# Blocks of each pass in the profiled window
PROFILE_BLOCKS = 4


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--jax_shapes', action='store_true',
                    help="the JAX tool's shapes: 128 wide, 32 + 64 samples, "
                         "mlp_chunk 262144 unless --mlp_chunk says otherwise")
    ap.add_argument('--mlp_chunk', type=int, default=None)
    ap.add_argument('--n_surf', type=int, default=4096)
    ap.add_argument('--n_rays', type=int, default=16384)
    ap.add_argument('--light_h', type=int, default=16)
    ap.add_argument('--device', default='cuda',
                    help="cuda (the kernels) or cpu (the plain versions)")
    return ap.parse_args(argv)


def k1_launches():
    return {'K1-fwd': fm.chain_kernel.launches,
            'K1-fwd tc': fm.chain_kernel.tc_launches,
            'K1-fwd f32 tc': fm.chain_kernel.f32_tc_launches,
            'K1-bwd': fm.chain_kernel_bwd.launches,
            'K1-bwd tc': fm.chain_kernel_bwd.tc_launches,
            'K1-bwd dx tc': fm.chain_kernel_bwd.dx_tc_launches,
            'K1-bwd dW': fm.chain_kernel_bwd.dw_launches}


def profile_window(run, device):
    """Device busy ms, wall ms and idle share of one call of ``run``, and
    the device ms of its 6 longest kernels, from a torch.profiler window;
    None off the card."""
    if device.type != 'cuda':
        return None
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with card.profiler_window(acts) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize(device)
        wall_us = 1e6 * (time.perf_counter() - t0)
    by_kernel = {}
    for e in card.device_events(prof):
        by_kernel[e.key] = by_kernel.get(e.key, 0.0) + getattr(
            e, 'self_device_time_total', 0.0)
    busy_us = sum(by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:6]
    return {'wall_ms': wall_us / 1e3, 'device_busy_ms': busy_us / 1e3,
            'device_idle_share': 1 - busy_us / wall_us if busy_us else None,
            'device_ms_by_kernel': {k[:80]: v / 1e3 for k, v in top}}


def timed(run, device):
    def sync():
        if device.type == 'cuda':
            torch.cuda.synchronize(device)
    sync()
    before = k1_launches()
    t0 = time.perf_counter()
    out = run()
    sync()
    dt = time.perf_counter() - t0
    launches = {k: v - before[k] for k, v in k1_launches().items()}
    return out, dt, launches


def build(args, device):
    """The distiller over nerf.ini (or the JAX tool's shapes) with random
    weights from seed 0."""
    parser = configutil.read_config(configutil.resolve_config_path(
        'nerf.ini'))
    mlp_chunk = args.mlp_chunk or (262144 if args.jax_shapes else 1048576)
    override = 'near=2,far=6,mlp_chunk=%d' % mlp_chunk
    if args.jax_shapes:
        override += ',mlp_width=128,n_samples_coarse=32,n_samples_fine=64'
    configutil.apply_override(parser, override)
    config = configutil.Config(parser)
    model = NerfModel(config, device=device)
    params = model.init_params(torch.Generator().manual_seed(0))
    gargs = geo.parse_args([
        '--trained_nerf', 'unused', '--out_root', 'unused',
        '--light_h', str(args.light_h), '--lvis_far', '2.5',
        '--occu_thres', '0.5', '--mlp_chunk', str(mlp_chunk),
        '--device', str(device)])
    shapes = '%d wide x %d, %d + %d samples, mlp_chunk %d' % (
        config.getint('mlp_width'), config.getint('enc_depth'),
        64 + config.getint('n_samples_coarse'),
        64 + config.getint('n_samples_fine'), mlp_chunk)
    return geo.GeometryDistiller(model, params, config, gargs), shapes


def main(argv=None):
    """Runs both stages; prints and returns their JSON records."""
    args = parse_args(argv)
    device = torch.device(args.device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError("march_probe: no CUDA card (--device cpu runs "
                           "the plain versions)")
    card_name = card.name_and_power() if device.type == 'cuda' else None
    dist, shapes = build(args, device)
    rng = np.random.default_rng(0)
    nrm = rng.normal(size=(args.n_surf, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    surf = nrm.copy()
    rayo = np.tile(np.array([0, 0, 4], np.float32), (args.n_rays, 1))
    rayd = rng.normal(size=(args.n_rays, 3)).astype(np.float32)
    rayd[:, 2] -= 4.0

    stages = (
        ('lvis_march_torch', 4096, 's/4096pts_x_%ddirs' % dist.n_lights,
         dist.lvis_block_pts,
         lambda n: dist.compute_light_visibility(surf[:n], nrm[:n]),
         args.n_surf, lambda out: float(np.mean(out))),
        ('depth_normal_torch', 16384, 's/16384rays', dist.ray_block,
         lambda n: dist.compute_depth_and_normal(rayo[:n], rayd[:n]),
         args.n_rays, lambda out: float(np.mean(out[1]))))
    records = []
    for stage, per, unit, block, run, n, checksum in stages:
        run(min(n, block))  # warm-up: one block
        out, dt, launches = timed(lambda: run(n), device)
        n_blocks = -(-n // block)
        record = {
            'stage': stage, 'value': dt * per / n, 'unit': unit,
            'seconds': dt, 'n': n, 'block': block, 'blocks': n_blocks,
            'ms_per_block': 1e3 * dt / n_blocks, 'k1_launches': launches,
            'checksum': checksum(out), 'config': shapes,
            'device': str(device),
            'card': card_name or 'none (plain versions)',
            'profile': profile_window(
                lambda: run(min(n, block * PROFILE_BLOCKS)), device),
            'profile_blocks': min(n_blocks, PROFILE_BLOCKS)}
        print(json.dumps(record))
        records.append(record)
    return records


if __name__ == '__main__':
    main()
