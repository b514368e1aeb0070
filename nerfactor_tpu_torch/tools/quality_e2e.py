"""End-to-end quality harness of the PyTorch port on the analytic-sphere
scene (counterpart of tools/quality_e2e.py, same flags and stages, plus
``--device``): trains the BRDF prior, the shape stage and the joint
NeRFactor model through the port's own CLIs, then reports the validation
PSNR of the joint model's re-rendered views.

The sphere's shading is exactly representable (Lambertian + achromatic
specular under an environment light) and its geometry buffers are exact,
so a correct pipeline reaches a high PSNR. ``--from_nerf`` first trains a
NeRF on the photos and distils its geometry (geometry_from_nerf), and the
later stages take those buffers instead of the exact ones.

  python -m nerfactor_tpu_torch.tools.quality_e2e --workdir=/tmp/quality \\
      [--imh=32] [--light_h=8] [--epochs_shape=100] [--epochs_joint=150] \\
      [--from_nerf] [--device=cuda]

Prints one JSON line (per_view_psnr, mean_psnr, stage_walls_min,
total_min) and writes the same record to <workdir>/quality_e2e.json. The
checkpoints lie under <workdir>/out/{merl/lr1e-2,shape/lr1e-2,
nerfactor/lr5e-3[,nerf/lr5e-4]}/checkpoints/.
"""

import argparse
import json
import os
import time
from contextlib import contextmanager
from os.path import join

import numpy as np

from nerfactor_tpu_torch import geometry_from_nerf, trainvali
from nerfactor_tpu_torch.tools import synth_scene
from nerfactor_tpu_torch.utils import io as ioutil


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument('--workdir', required=True)
    p.add_argument('--imh', type=int, default=32)
    p.add_argument('--light_h', type=int, default=8)
    p.add_argument('--n_train', type=int, default=8)
    p.add_argument('--epochs_brdf', type=int, default=200)
    p.add_argument('--epochs_shape', type=int, default=100)
    p.add_argument('--epochs_joint', type=int, default=150)
    p.add_argument('--mlp_width', type=int, default=64)
    p.add_argument('--n_rays', type=int, default=512)
    p.add_argument('--from_nerf', action='store_true',
                   help="train a NeRF, distil its geometry "
                        "(geometry_from_nerf) and feed the distilled buffers "
                        "downstream instead of the exact ones")
    p.add_argument('--epochs_nerf', type=int, default=600)
    p.add_argument('--distill_mlp_chunk', type=int, default=262144,
                   help="geometry_from_nerf --mlp_chunk")
    p.add_argument('--extra_override', default='',
                   help="extra config overrides for the NeRF, shape and "
                        "joint stages (e.g. bf16_big_chains=False)")
    p.add_argument('--n_materials', type=int, default=2,
                   help="synthetic BRDF-table materials for the prior "
                        "(>=20 to mirror the reference's hardcoded "
                        "20-identity interpolation sweep)")
    p.add_argument('--device', default='cuda', help="torch device")
    return p.parse_args(argv)


def write_inputs(args, root):
    """The scene with exact buffers (unless already there), two .npy
    light probes and the synthetic MERL-format tables; returns (probe
    dir, tables dir)."""
    if not os.path.exists(join(root, 'train_000')):
        synth_scene.make_scene(root, n_train=args.n_train, n_vali=2,
                               n_test=3, imh=args.imh, with_buffers=True,
                               light_h=args.light_h)
    # Light probes for test.py (PSNR does not read them)
    probe_dir = join(root, 'envmaps')
    rng = np.random.RandomState(0)
    for name in ('probeA', 'probeB'):
        ioutil.save_np(rng.rand(args.light_h, 2 * args.light_h, 3).astype(
            np.float32), join(probe_dir, name + '.npy'))
    # Near-constant materials, so the prior learns a low-dimensional
    # specular family
    brdf_data = join(root, 'brdf_npz')
    os.makedirs(brdf_data, exist_ok=True)
    grid = np.stack(np.meshgrid(
        np.linspace(0, np.pi, 18), np.linspace(0, np.pi / 2, 9),
        np.linspace(0, np.pi / 2, 9), indexing='ij'), -1).reshape(-1, 3)
    if args.n_materials == 2:
        materials = (('matte', 0.05), ('shiny', 0.6))
    else:
        materials = tuple(
            ('mat%02d' % i, v) for i, v in enumerate(
                np.linspace(0.05, 0.6, args.n_materials)))
    for i, (name, val) in enumerate(materials):
        refl = val * np.ones((grid.shape[0], 1), np.float32)
        for mode in ('train', 'vali'):
            np.savez(join(brdf_data, '%s_%s.npz' % (mode, name)),
                     i=i, name=name, envmap_h=args.light_h, ims=64,
                     spp=1, rusink=grid.astype(np.float32), refl=refl)
    np.savez(join(brdf_data, 'test.npz'), envmap_h=args.light_h, ims=64,
             spp=1, rusink=grid.astype(np.float32))
    return probe_dir, brdf_data


def mlp_override(args):
    return ('mlp_width=%d,mlp_depth=4,mlp_skip_at=2,mlp_chunk=65536'
            % args.mlp_width)


def train(args, config, overrides, extra=True):
    """``trainvali`` on a shipped config; ``extra`` appends
    ``--extra_override``."""
    if extra and args.extra_override:
        overrides = overrides + [args.extra_override]
    trainvali.main(['--config', config, '--config_override',
                    ','.join(overrides), '--device', args.device])


def nerf_stage(args, root, out):
    """Trains the NeRF; returns its run dir (up to the lr folder)."""
    nerf_out = join(out, 'nerf')
    train(args, 'nerf.ini', [
        'data_root=%s' % root, 'outroot=%s' % nerf_out,
        'imh=%d' % args.imh, 'epochs=%d' % args.epochs_nerf,
        'ckpt_period=%d' % args.epochs_nerf,
        'vali_period=%d' % args.epochs_nerf, 'vali_batches=1',
        'n_rays_per_step=%d' % args.n_rays, 'n_samples_coarse=32',
        'n_samples_fine=64', 'near=2', 'far=6', mlp_override(args),
        'lr=5e-4'])
    return join(nerf_out, 'lr5e-4')


def distill_stage(args, nerf_dir, surf_root):
    geometry_from_nerf.main([
        '--trained_nerf', nerf_dir, '--out_root', surf_root,
        '--imh', str(args.imh), '--light_h', str(args.light_h),
        '--lvis_far', '2.5', '--occu_thres', '0.5',
        '--mlp_chunk', str(args.distill_mlp_chunk),
        '--device', args.device])


def brdf_stage(args, brdf_data, out):
    """Trains the BRDF prior; returns its last checkpoint."""
    brdf_out = join(out, 'merl')
    train(args, 'brdf.ini', [
        'data_root=%s' % brdf_data, 'outroot=%s' % brdf_out,
        'epochs=%d' % args.epochs_brdf,
        'ckpt_period=%d' % args.epochs_brdf,
        'vali_period=%d' % args.epochs_brdf, 'vali_batches=1',
        'n_rays_per_step=512', mlp_override(args), 'lr=1e-2'], extra=False)
    return join(brdf_out, 'lr1e-2', 'checkpoints',
                'ckpt-%d' % args.epochs_brdf)


def shape_stage(args, root, surf_root, out):
    """Trains the shape stage; returns its last checkpoint."""
    shape_out = join(out, 'shape')
    train(args, 'shape.ini', [
        'data_root=%s' % root, 'data_nerf_root=%s' % surf_root,
        'outroot=%s' % shape_out, 'imh=%d' % args.imh,
        'light_h=%d' % args.light_h, 'epochs=%d' % args.epochs_shape,
        'ckpt_period=%d' % args.epochs_shape,
        'vali_period=%d' % args.epochs_shape, 'vali_batches=1',
        'n_rays_per_step=%d' % args.n_rays, mlp_override(args), 'lr=1e-2'])
    return join(shape_out, 'lr1e-2', 'checkpoints',
                'ckpt-%d' % args.epochs_shape)


def joint_stage(args, root, surf_root, joint_out, brdf_ckpt, shape_ckpt,
                probe_dir):
    """Trains the joint model into ``joint_out``; returns its run dir."""
    train(args, 'nerfactor.ini', [
        'data_root=%s' % root, 'data_nerf_root=%s' % surf_root,
        'outroot=%s' % joint_out, 'brdf_model_ckpt=%s' % brdf_ckpt,
        'shape_model_ckpt=%s' % shape_ckpt,
        'test_envmap_dir=%s' % probe_dir, 'imh=%d' % args.imh,
        'light_h=%d' % args.light_h, 'epochs=%d' % args.epochs_joint,
        'ckpt_period=%d' % args.epochs_joint,
        'vali_period=%d' % args.epochs_joint, 'vali_batches=2',
        'n_rays_per_step=%d' % args.n_rays, mlp_override(args), 'lr=5e-3'])
    return join(joint_out, 'lr5e-3')


def vali_psnrs(run_dir):
    """[(view id, PSNR)] of the last validation epoch of a joint run."""
    vali_dir = join(run_dir, 'vis_vali')
    last = sorted(os.listdir(vali_dir))[-1]
    psnrs = []
    for batch_dir in sorted(os.listdir(join(vali_dir, last))):
        meta_path = join(vali_dir, last, batch_dir, 'metadata.json')
        if os.path.isfile(meta_path):
            meta = ioutil.read_json(meta_path)
            if 'psnr' in meta:
                psnrs.append((meta['id'], meta['psnr']))
    return psnrs


def main(argv=None):
    """Runs the stages; returns the record it prints."""
    args = parse_args(argv)
    wk = args.workdir
    root, out = join(wk, 'data'), join(wk, 'out')
    probe_dir, brdf_data = write_inputs(args, root)
    stage_walls = {}  # stage -> wall-clock seconds

    @contextmanager
    def staged(name):
        t0 = time.time()
        yield
        stage_walls[name] = time.time() - t0

    surf_root = join(root, 'surf')
    if args.from_nerf:
        with staged('nerf'):
            nerf_dir = nerf_stage(args, root, out)
        surf_root = join(out, 'surf_from_nerf')
        with staged('distill'):
            distill_stage(args, nerf_dir, surf_root)
    with staged('brdf'):
        brdf_ckpt = brdf_stage(args, brdf_data, out)
    with staged('shape'):
        shape_ckpt = shape_stage(args, root, surf_root, out)
    with staged('joint'):
        joint_dir = joint_stage(args, root, surf_root,
                                join(out, 'nerfactor'), brdf_ckpt,
                                shape_ckpt, probe_dir)

    psnrs = vali_psnrs(joint_dir)
    record = {
        'per_view_psnr': psnrs,
        'mean_psnr': float(np.mean([p for _, p in psnrs]))
        if psnrs else None,
        'stage_walls_min': {k: round(v / 60.0, 2)
                            for k, v in stage_walls.items()},
        'total_min': round(sum(stage_walls.values()) / 60.0, 2)}
    print(json.dumps(record))
    with open(join(wk, 'quality_e2e.json'), 'w') as h:
        json.dump(record, h)
    return record


if __name__ == '__main__':
    main()
