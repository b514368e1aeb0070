"""Manual data-pipeline debugging harness (counterpart of
nerfactor_tpu/debug/dataloader.py; reference
nerfactor/debug/dataloader.py): loads one view, samples one batch, and
drops into an interactive shell when available. Host-side only.

  python -m nerfactor_tpu_torch.debug.dataloader \
      --config_ini=/path/exp.ini [--mode=test] [--interact]

``main`` returns the batch.
"""

import argparse

import numpy as np

from nerfactor_tpu_torch import datasets
from nerfactor_tpu_torch.utils import config as configutil
from nerfactor_tpu_torch.utils.logging import Logger

logger = Logger(loggee="debug/dataloader")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument('--config_ini', required=True)
    p.add_argument('--mode', default='test',
                   choices=['train', 'vali', 'test'])
    p.add_argument('--interact', action='store_true',
                   help="drop into IPython/pdb on the first batch")
    return p.parse_args(argv)


def describe(name, x):
    arr = np.asarray(x)
    if arr.dtype.kind in 'fiu':
        logger.info(
            "%s: shape=%s dtype=%s min=%.4g max=%.4g", name, arr.shape,
            arr.dtype, arr.min() if arr.size else float('nan'),
            arr.max() if arr.size else float('nan'))
    else:
        logger.info("%s: %r", name, x)


def main(argv=None):
    args = parse_args(argv)
    parser = configutil.read_config(args.config_ini)
    config = configutil.Config(parser)
    Dataset = datasets.get_dataset_class(config.get('dataset'))
    dataset = Dataset(config, args.mode)
    logger.info("%d files; first: %s", len(dataset.files),
                dataset.files[0])
    # Raw single-view load (pre-sampling)
    data = dataset._load_one(dataset.files[0])
    for k, v in data.items():
        describe('raw.%s' % k, v)
    # One pipeline batch (post-sampling)
    datapipe = dataset.build_pipeline(no_shuffle=True)
    batch = next(iter(datapipe))
    for k, v in batch.items():
        describe('batch.%s' % k, v)
    if args.interact:
        try:
            from IPython import embed
            embed()
        except ImportError:
            import pdb
            pdb.set_trace()
    return batch


if __name__ == '__main__':
    main()
