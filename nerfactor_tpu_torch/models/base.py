"""Model contract (counterpart of nerfactor_tpu/models/base.py).

A model is a configuration object on a device; its parameters live in a
plain tree of tensors (the JAX package's layout, see utils/ckpt.py):

  model = Model(config, device='cuda')
  params = model.init_params(torch.Generator().manual_seed(0))
  pred, gt, loss_kwargs, to_vis = model.apply(params, batch, mode='train',
                                              generator=g)
  per_example = model.compute_loss(params, pred, gt, **loss_kwargs)

Host-side visualization (vis_batch, compile_batch_vis) works on NumPy
arrays.
"""

from nerfactor_tpu_torch.models import losses as losses_mod
from nerfactor_tpu_torch.utils.logging import Logger

logger = Logger(loggee="models/base")


class BaseModel:
    def __init__(self, config, debug=False, device='cuda'):
        self.config = config
        self.debug = debug
        self.device = device
        if debug:
            logger.warn("Model in debug mode; behavior may be different")
        self.wloss = losses_mod.init_wloss(config.get('loss'))

    @staticmethod
    def _validate_mode(mode):
        if mode not in ('train', 'vali', 'test'):
            raise ValueError(mode)

    def init_params(self, generator):
        raise NotImplementedError

    def apply(self, params, batch, mode='train', **kwargs):
        """Returns (pred, gt, loss_kwargs, to_vis)."""
        raise NotImplementedError

    def train_draws(self, generator, batch, world=1):
        """The random draws of a train-mode ``apply`` on ``world`` x the
        rows of ``batch``, drawn from ``generator`` in the order ``apply``
        draws them, as keyword arguments of ``apply``; each has the rays
        as its leading axis. A data-parallel step (parallel/train.py)
        keeps its rank's rows. None here."""
        return {}

    def needs_dw_false_keys(self):
        """Top-level param keys whose fused chains run with
        ``needs_dw=False`` in the training forward. Each must be a frozen
        subtree of ``trainable_mask``; ``make_train_step`` checks it."""
        return frozenset()

    def compute_loss(self, params, pred, gt, **kwargs):
        """Returns the per-example loss, shape (batch,)."""
        raise NotImplementedError

    def vis_batch(self, data_dict, outdir, mode='train', **kwargs):
        raise NotImplementedError

    def compile_batch_vis(self, batch_vis_dirs, outpref, mode='train',
                          **kwargs):
        raise NotImplementedError
