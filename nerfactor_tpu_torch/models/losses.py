"""Losses with the reference's config-string parsing (counterpart of
nerfactor_tpu/models/losses.py, without the image-window and perceptual
losses).

Configs name losses as comma-joined '<weight><name>' strings like 'l2'
or '1e+2l1' (reference models/base.py:44-79). Every loss takes
``keep_batch`` so the training loop can average a per-example loss over the
batch.
"""

import torch


def parse_loss_and_weight(weight_loss_str):
    """'1e+2l1' -> ('l1', 100.0); 'l2' -> ('l2', 1.0)."""
    for i in range(len(weight_loss_str), -1, -1):
        try:
            weight = float(weight_loss_str[:i])
        except ValueError:
            continue
        return weight_loss_str[i:], weight
    return weight_loss_str, 1.0


def _reduce(loss, keep_batch):
    if keep_batch:
        dims = tuple(range(1, loss.dim()))
        return torch.mean(loss, dim=dims) if dims else loss
    return torch.mean(loss)


def l1(gt, pred, keep_batch=False, weights=None):
    loss = torch.abs(gt - pred)
    if weights is not None:
        loss = loss * weights
    return _reduce(torch.mean(loss, dim=-1), keep_batch)


def l2(gt, pred, keep_batch=False, weights=None):
    loss = torch.square(gt - pred)
    if weights is not None:
        loss = loss * weights
    return _reduce(torch.mean(loss, dim=-1), keep_batch)


def mse_lastdim(gt, pred):
    """Per-row MSE over the last dim only (the reference's
    tf.keras.losses.MSE): (..., D) -> (...)."""
    return torch.mean(torch.square(gt - pred), dim=-1)


def mae_lastdim(gt, pred):
    return torch.mean(torch.abs(gt - pred), dim=-1)


def get_loss_fn(name):
    """The losses the shipped joint and shape configs name ('l2'), and
    'l1'. SSIM, chroma and perceptual losses are not ported yet
    (ROADMAP.md, Queue 1)."""
    if name == 'l1':
        return l1
    if name == 'l2':
        return l2
    raise NotImplementedError(
        "Loss '%s' is not ported yet (ROADMAP.md, Queue 1)" % name)


def init_wloss(loss_config_str):
    """Parses the config 'loss' string into [(weight, fn), ...]."""
    wloss = []
    for x in loss_config_str.split(','):
        name, weight = parse_loss_and_weight(x)
        wloss.append((weight, get_loss_fn(name)))
    return wloss
