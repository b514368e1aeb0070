"""NeRF test-trajectory rendering on PyTorch (counterpart of
nerfactor_tpu/nerf_test.py, same CLI):

  python -m nerfactor_tpu_torch.nerf_test --ckpt=/path/to/ckpt-20 \
      [--debug] [--device=cuda]

The config is found from the checkpoint path by convention
(<outroot>/<xname>/checkpoints/ckpt-N -> <outroot>/<xname>.ini). Each test
view gets its coarse and fine rgb, depth, disparity and occupancy images
and a metadata.json under <outroot>/<xname>/vis_test/ckpt-N/batch?????????/.
``--device`` picks the torch device (the CUDA kernels run on ``cuda``;
``cpu`` runs their plain versions). The fine renders are compiled into
<outroot>/<xname>/vis_test/ckpt-N.mp4 (.apng without a video codec).
"""

import argparse
import time
from os.path import join, basename

import numpy as np
import torch

from nerfactor_tpu_torch import datasets, models
from nerfactor_tpu_torch.utils import ckpt as ckptutil, io as ioutil
from nerfactor_tpu_torch.utils import config as configutil
from nerfactor_tpu_torch.utils.logging import Logger

logger = Logger(loggee="nerf_test")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument('--ckpt', required=True,
                   help="path to checkpoint (prefix only)")
    p.add_argument('--debug', action='store_true')
    p.add_argument('--device', default='cuda', help="torch device")
    return p.parse_args(argv)


def main(argv=None):
    """Renders the test views and compiles them into a video; returns
    {'outroot', 'view_seconds', 'video'}: the seconds of each view's
    render (device work included) and image writes, and the path of the
    video written (an .apng without a video codec)."""
    args = parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device(args.device)
    config_ini = configutil.get_config_ini(args.ckpt)
    config = configutil.Config(configutil.read_config(config_ini))
    outroot = join(config_ini[:-len('.ini')], 'vis_test', basename(args.ckpt))

    Dataset = datasets.get_dataset_class(config.get('dataset'))
    dataset = Dataset(config, 'test', debug=args.debug)
    n_views = dataset.get_n_views()
    datapipe = dataset.build_pipeline(no_shuffle=True)

    Model = models.get_model_class(config.get('model'))
    model = Model(config, debug=args.debug, device=device)
    params = ckptutil.restore_trained_params(
        args.ckpt, model.init_params(torch.Generator().manual_seed(0)),
        device=device)

    logger.info("Rendering %d views on %s", n_views, device)
    view_seconds = []
    for batch_i, batch in enumerate(datapipe):
        t0 = time.perf_counter()
        meta = {k: v for k, v in batch.items()
                if k not in dataset.array_keys}
        arrays = {k: torch.as_tensor(np.asarray(batch[k], np.float32),
                                     device=device)
                  for k in dataset.array_keys}
        with torch.no_grad():
            to_vis = model.apply(params, arrays, mode='test')[3]
        to_vis_np = {k: v.cpu().numpy() for k, v in to_vis.items()}
        to_vis_np.update(meta)
        outdir = join(outroot, 'batch{i:09d}'.format(i=batch_i))
        model.vis_batch(to_vis_np, outdir, mode='test')
        view_seconds.append(time.perf_counter() - t0)
        logger.info("View %d: %.3f s", batch_i, view_seconds[-1])
        if args.debug:
            break
    batch_vis_dirs = ioutil.sortglob(outroot, 'batch?????????')
    video = model.compile_batch_vis(batch_vis_dirs, outroot, mode='test')
    logger.info("Compilation available for viewing at\n\t%s", video)
    return {'outroot': outroot, 'view_seconds': view_seconds,
            'video': video}


if __name__ == '__main__':
    main()
