"""NeRFactor inference on PyTorch: relighting and view synthesis, plus
albedo color correction and albedo and BRDF edits (counterpart of
nerfactor_tpu/test.py, same CLI):

  python -m nerfactor_tpu_torch.test --ckpt=/path/to/ckpt-10 \
      [--color_correct_albedo] [--tgt_albedo=gold] [--tgt_brdf=pearl-paint] \
      [--sv_axis_i=0 --sv_axis_min=-1.5 --sv_axis_max=1.5] [--debug] \
      [--device=cuda]

The config is found from the checkpoint path by convention
(<outroot>/<xname>/checkpoints/ckpt-N -> <outroot>/<xname>.ini). Each
test view gets the per-view images of nerfactor_tpu/test.py under
<outroot>/<xname>/vis_test/ckpt-N[_edit]/batch?????????/; the last view
also gets the OLAT relights, and the views are compiled into
<outroot>/<xname>/vis_test/ckpt-N[_edit].mp4 (.apng without a video
codec): view synthesis, the OLATs, then the probes. ``--tgt_brdf``
names a material of the BRDF prior's training tables: its latent code
replaces the predicted one at every point. ``--device`` picks the torch
device (the CUDA kernels run on ``cuda``; ``cpu`` runs their plain
versions).
"""

import argparse
import time
from os.path import join, basename

import numpy as np
import torch

from nerfactor_tpu_torch.utils import config as configutil
from nerfactor_tpu_torch.utils.logging import Logger
from nerfactor_tpu_torch import datasets, models
from nerfactor_tpu_torch.models.brdf import Model as BRDFModel
from nerfactor_tpu_torch.ops import img as imgops
from nerfactor_tpu_torch.utils import ckpt as ckptutil, io as ioutil

logger = Logger(loggee="test")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument('--ckpt', required=True,
                   help="path to checkpoint (prefix only)")
    p.add_argument('--color_correct_albedo', action='store_true')
    p.add_argument('--sv_axis_i', type=int, default=0,
                   help="along which axis we do spatially-varying edits")
    p.add_argument('--sv_axis_min', type=float, default=-1.5)
    p.add_argument('--sv_axis_max', type=float, default=1.5)
    p.add_argument('--tgt_albedo', default=None, help="albedo edit name")
    p.add_argument('--tgt_brdf', default=None, help="BRDF edit name")
    p.add_argument('--debug', action='store_true')
    p.add_argument('--device', default='cuda', help="torch device")
    return p.parse_args(argv)


def compute_rgb_scales(ckpt_path, alpha_thres=0.9):
    """Per-channel least-squares scales matching predicted albedo to the
    ground truth of the first validation view (reference test.py:46-88)."""
    config_ini = configutil.get_config_ini(ckpt_path)
    config = configutil.Config(configutil.read_config(config_ini))
    vali_dir = join(config_ini[:-len('.ini')], 'vis_vali')
    epoch_dirs = ioutil.sortglob(vali_dir, 'epoch?????????')
    if not epoch_dirs:
        raise FileNotFoundError(
            "No validation epochs to color-correct against in %s" % vali_dir)
    batch_dirs = ioutil.sortglob(epoch_dirs[-1], 'batch?????????')
    metadata = ioutil.read_json(join(batch_dirs[0], 'metadata.json'))
    pred = ioutil.load_img(join(batch_dirs[0], 'pred_albedo.png'))
    gt = ioutil.load_img(join(config.get('data_root'), metadata['id'],
                              'albedo.png'), force_rgba=True)
    pred = pred[:, :, :3] ** 2.2  # undo gamma
    gt = imgops.resize(gt, new_h=pred.shape[0])
    is_fg = gt[:, :, 3] > alpha_thres
    opt_scale = []
    for i in range(3):
        x_hat = pred[:, :, i][is_fg]
        x = gt[:, :, i][is_fg]
        opt_scale.append(x_hat.dot(x) / x_hat.dot(x_hat))
    return np.asarray(opt_scale, np.float32)


ALBEDO_EDITS = ('aluminium', 'gold', 'green', 'rainbow', 'turbo')


def get_albedo_override(args, xyz):
    """Solid-color or spatially-varying albedo edits (reference
    test.py:91-132). ``xyz`` is the (N, 3) surface buffer."""
    solid = {'aluminium': (0.913, 0.921, 0.925), 'gold': (1.0, 0.843, 0.0),
             'green': (0.0, 1.0, 0.0)}
    if args.tgt_albedo in solid:
        return np.asarray(solid[args.tgt_albedo], np.float32).reshape(1, 3)
    axis = np.asarray(xyz)[:, args.sv_axis_i]
    if args.tgt_albedo == 'rainbow':
        rainbow = np.asarray([
            (0.58, 0, 0.83), (0.29, 0, 0.51), (0, 0, 1), (0, 1, 0),
            (1, 1, 0), (1, 0.5, 0), (1, 0, 0)], np.float32)
        band_width = (args.sv_axis_max - args.sv_axis_min) / len(rainbow)
        band = np.floor((axis - args.sv_axis_min) / band_width).astype(int)
        out = rainbow[np.clip(band, 0, len(rainbow) - 1)]
        # Out-of-range points keep zero albedo, as the reference's
        # scatter-only-in-band
        in_range = (axis >= args.sv_axis_min) & (axis < args.sv_axis_max)
        out[~in_range] = 0.0
        return out.astype(np.float32)
    if args.tgt_albedo == 'turbo':
        from matplotlib import cm
        x = (axis - args.sv_axis_min) / (args.sv_axis_max - args.sv_axis_min)
        return cm.get_cmap('turbo')(np.clip(x, 0, 1))[:, :3].astype(
            np.float32)
    raise NotImplementedError("Target albedo: %s" % args.tgt_albedo)


def main(argv=None):
    """Runs inference and compiles the views into a video; returns
    {'outroot', 'view_seconds', 'brdf_z_override', 'video'}: the seconds
    of each view's forward (device work included) and its image writes,
    the latent code a --tgt_brdf edit put on every point (None without
    one), and the path of the video written (an .apng without a video
    codec)."""
    args = parse_args(argv)
    if args.debug:
        logger.warn("Debug mode: on")
    if args.tgt_albedo and args.tgt_albedo not in ALBEDO_EDITS:
        raise SystemExit(
            "Unknown --tgt_albedo '%s'; choose one of %s"
            % (args.tgt_albedo, ', '.join(ALBEDO_EDITS)))
    # The rendering equation and every f32 chain stay true f32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device(args.device)

    config_ini = configutil.get_config_ini(args.ckpt)
    config = configutil.Config(configutil.read_config(config_ini))
    outroot = join(config_ini[:-len('.ini')], 'vis_test',
                   basename(args.ckpt))
    if args.tgt_albedo:
        outroot += '_%s' % args.tgt_albedo
    if args.tgt_brdf:
        outroot += '_%s' % args.tgt_brdf

    # Dataset: test trajectory (placeholder RGB)
    Dataset = datasets.get_dataset_class(config.get('dataset'))
    dataset = Dataset(config, 'test', debug=args.debug)
    n_views = dataset.get_n_views()
    datapipe = dataset.build_pipeline(no_shuffle=True)

    # Model + restored params
    Model = models.get_model_class(config.get('model'))
    model = Model(config, debug=args.debug, device=device)
    params = model.init_params(torch.Generator().manual_seed(0))
    params = ckptutil.restore_trained_params(args.ckpt, params,
                                             device=device)

    albedo_scales = None
    if (not args.tgt_albedo) and args.color_correct_albedo:
        albedo_scales = compute_rgb_scales(args.ckpt)
        logger.info("Albedo scales: %s", albedo_scales)

    # BRDF edit: the named MERL material's latent code
    brdf_z_override = None
    if args.tgt_brdf:
        ind = BRDFModel(model.config_brdf, device='cpu').brdf_names.index(
            args.tgt_brdf)
        brdf_z_override = params['latent_code'][ind, :].cpu().numpy()

    logger.info("Running inference on %d views on %s", n_views, device)
    view_seconds = []
    for batch_i, batch in enumerate(datapipe):
        t0 = time.perf_counter()
        relight_olat = batch_i == n_views - 1  # only for the final view
        meta = {k: v for k, v in batch.items()
                if k not in dataset.array_keys}
        arrays = {k: torch.as_tensor(np.asarray(batch[k], np.float32),
                                     device=device)
                  for k in dataset.array_keys}
        albedo_override = None
        if args.tgt_albedo:
            albedo_override = get_albedo_override(args, batch['xyz'])
        with torch.no_grad():
            _, _, _, to_vis = model.apply(
                params, arrays, mode='test', relight_olat=relight_olat,
                relight_probes=True, albedo_scales=albedo_scales,
                albedo_override=albedo_override,
                brdf_z_override=brdf_z_override)
        to_vis_np = {k: v.cpu().numpy() for k, v in to_vis.items()}
        to_vis_np.update(meta)
        outdir = join(outroot, 'batch{i:09d}'.format(i=batch_i))
        model.vis_batch(to_vis_np, outdir, mode='test',
                        olat_vis=relight_olat)
        view_seconds.append(time.perf_counter() - t0)
        logger.info("View %d: %.3f s", batch_i, view_seconds[-1])
        if args.debug:
            break
    batch_vis_dirs = ioutil.sortglob(outroot, 'batch?????????')
    video = model.compile_batch_vis(batch_vis_dirs, outroot, mode='test')
    logger.info("Compilation available for viewing at\n\t%s", video)
    return {'outroot': outroot, 'view_seconds': view_seconds,
            'brdf_z_override': brdf_z_override, 'video': video}


if __name__ == '__main__':
    main()
