"""Train and eval steps and the optimizer (counterpart of
nerfactor_tpu/parallel/train.py): on one device, or data parallel over
the ranks of a process group (parallel/mesh.py), each on its part of the
global batch.

The optimizer is the JAX package's TF-exact Adam(amsgrad) with the same
state layout: ``(count, m, v, vhat)`` inside a 1-tuple, the leaves
``optax.chain`` flattens to, so a checkpoint's ``opt_state`` moves between
the packages unchanged. Parameters and optimizer state are trees of
dicts and lists with tensor leaves (utils/ckpt.py).
"""

from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from nerfactor_tpu_torch.parallel import mesh
from nerfactor_tpu_torch.utils.ckpt import tree_leaves, tree_map


class TfAdamState(NamedTuple):
    count: torch.Tensor  # int32 scalar: steps taken
    m: object
    v: object
    vhat: object


class Optimizer:
    """A chain of gradient transforms ending in Adam, as ``optax.chain``:
    ``init(params)`` gives the state, ``update(grads, state)`` the
    parameter steps and the next state."""

    def __init__(self, clip, schedule, b1=0.9, b2=0.999, eps=1e-7):
        self.clip = clip
        self.schedule = schedule
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params):
        def zeros():
            return tree_map(torch.zeros_like, params)
        return (TfAdamState(count=torch.zeros([], dtype=torch.int32),
                            m=zeros(), v=zeros(), vhat=zeros()),)

    def lr_t(self, count):
        """lr * sqrt(1 - b2^t) / (1 - b1^t) at t = count + 1, in f32 as
        the JAX package (the schedule reads the pre-increment count)."""
        f32 = np.float32
        lr = f32(self.schedule(count))
        t = f32(count + 1)
        return float(lr * np.sqrt(f32(1) - f32(self.b2) ** t)
                     / (f32(1) - f32(self.b1) ** t))

    def update(self, grads, state):
        """tf.keras.optimizers.Adam(amsgrad=True) with TF's semantics,
        as the JAX package's ``_tf_adam_amsgrad``:

            m_t    = b1 m + (1 - b1) g
            v_t    = b2 v + (1 - b2) g^2
            vhat_t = max(vhat, v_t)
            step   = -lr_t m_t / (sqrt(vhat_t) + eps)

        eps goes to the BIASED sqrt(vhat), the bias corrections into lr_t.
        (torch.optim.Adam(amsgrad=True) puts eps on the corrected
        denominator: ~9 dB of joint-stage PSNR, QUALITY.md.) The state's
        tensors are updated in place; returns (steps, state)."""
        (adam,) = state
        if self.clip is not None:
            grads = tree_map(self.clip, grads)
        count = int(adam.count)
        lr_t = self.lr_t(count)
        b1, b2 = self.b1, self.b2
        steps = []
        for g, m, v, vh in zip(tree_leaves(grads), tree_leaves(adam.m),
                               tree_leaves(adam.v), tree_leaves(adam.vhat)):
            m.mul_(b1).add_(g * (1.0 - b1))
            v.mul_(b2).add_(torch.square(g) * (1.0 - b2))
            torch.maximum(vh, v, out=vh)
            steps.append(-lr_t * m / (torch.sqrt(vh) + self.eps))
        adam.count.fill_(count + 1)
        return steps, state


def clip_by_per_leaf_norm(max_norm):
    """Keras 'clipnorm': each gradient tensor clipped to L2 norm
    ``max_norm`` (not a global norm)."""
    def clip(g):
        norm = torch.sqrt(torch.sum(torch.square(g)))
        return g * torch.clamp(max_norm / torch.clamp(norm, min=1e-12),
                               max=1.0)
    return clip


def clip_by_value(max_delta):
    def clip(g):
        return torch.clamp(g, -max_delta, max_delta)
    return clip


def exponential_decay(init_value, transition_steps, decay_rate):
    """optax.exponential_decay with staircase=False."""
    def schedule(count):
        f32 = np.float32
        if count <= 0:
            return f32(init_value)
        return f32(init_value) * f32(decay_rate) ** (
            f32(count) / f32(transition_steps))
    return schedule


def build_optimizer(config):
    """Adam(amsgrad) + exponential lr decay + optional gradient clipping,
    reference trainvali.py:109-127."""
    lr = config.getfloat('lr')
    lr_decay_steps = config.getint('lr_decay_steps', fallback=-1)
    if lr_decay_steps and lr_decay_steps > 0:
        schedule = exponential_decay(lr, lr_decay_steps,
                                     config.getfloat('lr_decay_rate'))
    else:
        def schedule(_):
            return np.float32(lr)
    clipnorm = config.getfloat('clipnorm', fallback=-1.0)
    clipvalue = config.getfloat('clipvalue', fallback=-1.0)
    if clipnorm > 0 and clipvalue > 0:
        raise ValueError(
            "Both `clipnorm` and `clipvalue` are active -- turn one off")
    clip = None
    if clipnorm > 0:
        clip = clip_by_per_leaf_norm(clipnorm)
    elif clipvalue > 0:
        clip = clip_by_value(clipvalue)
    return Optimizer(clip, schedule,
                     eps=config.getfloat('adam_eps', fallback=1e-7))


def upcast_batch(arrays):
    """float16/bfloat16 transfer dtypes (e.g. the lvis targets) -> f32."""
    return {k: v.float() if v.dtype in (torch.float16, torch.bfloat16)
            else v for k, v in arrays.items()}


def _check_needs_dw_invariant(model, trainable_mask):
    """The needs_dw=False chains of the model's training forward are right
    only because trainable_mask freezes the same parameter subtrees."""
    keys = getattr(model, 'needs_dw_false_keys', frozenset)()
    if not keys:
        return
    if trainable_mask is None:
        raise ValueError(
            "%s declares needs_dw=False chains for %s but no trainable_mask "
            "was passed to the train step -- their weight gradients would "
            "be silently dropped. Pass trainable_mask=model.trainable_mask("
            "params)." % (type(model).__name__, sorted(keys)))
    for k in sorted(keys):
        if k in trainable_mask and any(tree_leaves(trainable_mask[k])):
            raise ValueError(
                "Param subtree '%s' is flagged needs_dw=False in %s's "
                "forward but is trainable per trainable_mask -- it would "
                "train on zero weight gradients." % (k, type(model).__name__))


def make_train_step(model, optimizer, trainable_mask=None, group=None):
    """Returns ``train_step(params, opt_state, arrays, generator=None,
    jitter_noise=None) -> (params, opt_state, loss)``: the loss and its
    gradients, zero gradients for the leaves ``trainable_mask`` freezes,
    and the optimizer update. ``generator`` draws the jitter noise (or
    ``jitter_noise`` gives it); a model with ``xyz_jitter_std > 0`` needs
    one of the two.

    Parameters and optimizer state are updated in place under
    torch.no_grad() (the JAX package donates both buffers to the jitted
    step); the returned trees are the ones passed in. Gradients are
    taken only for trainable leaves: the frozen ones would be zeroed
    anyway, so their backward work is skipped.

    With a process ``group`` (parallel/mesh.py), ``arrays`` is this
    rank's part of the global batch, the ranks in order. Each rank draws
    the global batch's random draws (``model.train_draws``) from its
    ``generator``, seeded alike on every rank, and keeps its own rows, as
    each device holds its rows of the draws of the JAX package's key; a
    ``jitter_noise`` given is this rank's rows already. The trainable
    gradients and the loss are averaged over the ranks in one all-reduce
    before the optimizer, whose per-leaf clipping (Keras ``clipnorm``)
    then sees the global gradient; the loss returned is the global
    batch's mean. Without a group, nothing of this runs."""
    _check_needs_dw_invariant(model, trainable_mask)

    def train_step(params, opt_state, arrays, generator=None,
                   jitter_noise=None):
        arrays = upcast_batch(arrays)
        leaves = tree_leaves(params)
        mask = tree_leaves(trainable_mask) if trainable_mask is not None \
            else [True] * len(leaves)
        live = tree_map(lambda t: t.detach(), params)
        live_leaves = tree_leaves(live)
        wrt = [t.requires_grad_() for t, m in zip(live_leaves, mask) if m]
        draws = {'jitter_noise': jitter_noise}
        if group is not None and jitter_noise is None:
            world, rank = dist.get_world_size(group), dist.get_rank(group)
            draws.update(mesh.shard_batch(
                model.train_draws(generator, arrays, world), rank, world))
        with torch.enable_grad():
            pred, gt, loss_kwargs, _ = model.apply(
                live, arrays, mode='train', generator=generator, **draws)
            loss = torch.mean(model.compute_loss(live, pred, gt,
                                                 **loss_kwargs))
            got = list(torch.autograd.grad(loss, wrt, allow_unused=True))
        if group is not None:
            got = [torch.zeros_like(t) if g is None else g
                   for t, g in zip(wrt, got)]
            *got, loss = mesh.all_mean(got + [loss.detach()], group)
        got = iter(got)
        grads = []
        for t, m in zip(leaves, mask):
            g = next(got) if m else None
            grads.append(torch.zeros_like(t) if g is None else g)
        with torch.no_grad():
            steps, opt_state = optimizer.update(grads, opt_state)
            for p, s in zip(leaves, steps):
                p.add_(s)
        return params, opt_state, loss.detach()

    return train_step


def make_eval_step(model, mode='vali'):
    """Returns ``eval_step(params, arrays) -> (loss, to_vis)``."""

    def eval_step(params, arrays):
        arrays = upcast_batch(arrays)
        with torch.no_grad():
            pred, gt, loss_kwargs, to_vis = model.apply(params, arrays,
                                                        mode=mode)
            loss = torch.mean(model.compute_loss(params, pred, gt,
                                                 **loss_kwargs))
        return loss, to_vis

    return eval_step
