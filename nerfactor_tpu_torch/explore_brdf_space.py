"""BRDF prior testing on PyTorch: reconstructions of the seen materials
and the latent-space interpolation video (counterpart of
nerfactor_tpu/explore_brdf_space.py, same CLI):

  python -m nerfactor_tpu_torch.explore_brdf_space --ckpt=/path/to/ckpt-50 \
      [--debug] [--device=cuda]

The config is found from the checkpoint path by convention
(<outroot>/<xname>/checkpoints/ckpt-N -> <outroot>/<xname>.ini). Every
test identity gets, under <outroot>/<xname>/vis_test/ckpt-N/batch?????????/,
its latent code and log10 reflectance as bar charts, a metadata.json, and
where the test table has the reference's layout, the characteristic slice
and a sphere render; then an HTML page and the interpolation video
(ckpt-N.mp4, or ckpt-N.apng without an mp4 backend).
"""

import argparse
from os.path import join, basename, exists

import torch

from nerfactor_tpu_torch import datasets, models
from nerfactor_tpu_torch.trainvali import split_batch, to_device
from nerfactor_tpu_torch.utils import config as configutil, io as ioutil
from nerfactor_tpu_torch.utils import ckpt as ckptutil
from nerfactor_tpu_torch.utils.logging import Logger

logger = Logger(loggee="explore_brdf_space")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument('--ckpt', required=True,
                   help="path to checkpoint (prefix only, e.g. .../ckpt-50)")
    p.add_argument('--debug', action='store_true')
    p.add_argument('--device', default='cuda', help="torch device")
    return p.parse_args(argv)


def main(argv=None):
    """Runs inference over every test identity; returns {'outroot',
    'view_at'}."""
    args = parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device(args.device)
    config_ini = configutil.get_config_ini(args.ckpt)
    config = configutil.Config(configutil.read_config(config_ini))
    outroot = join(config_ini[:-len('.ini')], 'vis_test', basename(args.ckpt))

    Dataset = datasets.get_dataset_class(config.get('dataset'))
    dataset = Dataset(config, 'test', debug=args.debug)
    datapipe = dataset.build_pipeline(no_shuffle=True)

    Model = models.get_model_class(config.get('model'))
    model = Model(config, debug=args.debug, device=device)
    params = ckptutil.restore_trained_params(
        args.ckpt, model.init_params(torch.Generator().manual_seed(0)),
        device=device)

    logger.info("Running inference over %d identities",
                dataset.get_n_brdfs())
    for batch_i, batch in enumerate(datapipe):
        outdir = join(outroot, f'batch{batch_i:09d}')
        if all(exists(join(outdir, x)) for x in (
                'cslice.png', 'log10_brdf.png', 'metadata.json',
                'render.png', 'z.png')):
            continue
        meta, arrays = split_batch(dataset, batch)
        id_ = meta['id']
        with torch.no_grad():
            if '_' in id_ and int(arrays['i']) == -1:
                # Interpolated identity: '<i>_<w1>_<mat1>_<w2>_<mat2>'
                _, w1, mat1, w2, mat2 = id_.split('_')
                z = model.interp_z(params, float(w1),
                                   model.brdf_names.index(mat1), float(w2),
                                   model.brdf_names.index(mat2))
            else:
                z = model.lookup_z(params, torch.as_tensor(
                    [int(arrays['i'])], device=device))
            to_vis = model.apply(params, to_device(arrays, device),
                                 mode='test', z_override=z)[3]
        to_vis_np = {k: v.cpu().numpy() for k, v in to_vis.items()}
        to_vis_np.update(meta)
        model.vis_batch(to_vis_np, outdir, mode='test')
        if args.debug and batch_i > 2:
            break

    batch_vis_dirs = ioutil.sortglob(outroot, 'batch?????????')
    view_at = model.compile_batch_vis(batch_vis_dirs, outroot, mode='test')
    logger.info("Compilation available for viewing at\n\t%s", view_at)
    return {'outroot': outroot, 'view_at': view_at}


if __name__ == '__main__':
    main()
