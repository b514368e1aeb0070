"""Losses with the reference's config-string parsing (counterpart of
nerfactor_tpu/models/losses.py).

Configs name losses as comma-joined '<weight><name>' strings like 'l2'
or '1e+2lpips' (reference models/base.py:44-79). Every loss takes
``keep_batch`` so the training loop can average a per-example loss over the
batch. The windowed SSIM and the perceptual losses take (N, H, W, C)
image batches; their convolutions run in f32 through cuDNN on the card,
so a caller there turns ``torch.backends.cudnn.allow_tf32`` off, as the
entry points do.
"""

import functools

import numpy as np
import torch
import torch.nn.functional as F


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


def _gauss_window(size=11, sigma=1.5):
    coords = np.arange(size, dtype=np.float64) - (size - 1) / 2
    g = np.exp(-(coords ** 2) / (2.0 * sigma ** 2))
    return torch.as_tensor(g / g.sum(), dtype=torch.float32)


def _depthwise_gauss_valid(img, win):
    """Separable VALID Gaussian filter of each channel of (N, H, W, C)
    (tf.image.ssim's depthwise convolution), as two grouped convs."""
    c, size = img.shape[-1], win.shape[0]
    win = win.to(img.device)
    x = img.permute(0, 3, 1, 2)
    x = F.conv2d(x, win.reshape(1, 1, size, 1).expand(c, 1, size, 1),
                 groups=c)
    x = F.conv2d(x, win.reshape(1, 1, 1, size).expand(c, 1, 1, size),
                 groups=c)
    return x.permute(0, 2, 3, 1)


def ssim_index(gt, pred, max_val=1.0, filter_size=11, filter_sigma=1.5):
    """Per-image SSIM of (N, H, W, C) batches with tf.image.ssim's
    algorithm (11 x 11 Gaussian window of sigma 1.5, VALID padding, k1
    0.01, k2 0.03): an N-vector in [-1, 1] (reference losses.py:68-81)."""
    if gt.dim() != 4:
        raise ValueError("ssim expects (N, H, W, C) image batches")
    if gt.shape[1] < filter_size or gt.shape[2] < filter_size:
        raise ValueError("images must be at least %d x %d for the windowed "
                         "SSIM" % (filter_size, filter_size))
    win = _gauss_window(filter_size, filter_sigma)
    c1 = (0.01 * max_val) ** 2
    c2 = (0.03 * max_val) ** 2
    mu_x = _depthwise_gauss_valid(gt, win)
    mu_y = _depthwise_gauss_valid(pred, win)
    mu_xx = _depthwise_gauss_valid(gt * gt, win)
    mu_yy = _depthwise_gauss_valid(pred * pred, win)
    mu_xy = _depthwise_gauss_valid(gt * pred, win)
    var_x = mu_xx - mu_x * mu_x
    var_y = mu_yy - mu_y * mu_y
    cov = mu_xy - mu_x * mu_y
    lum = (2 * mu_x * mu_y + c1) / (mu_x ** 2 + mu_y ** 2 + c1)
    cs = (2 * cov + c2) / (var_x + var_y + c2)
    return torch.mean(lum * cs, dim=(1, 2, 3))


def ssim(gt, pred, keep_batch=False, weights=None, max_val=1.0):
    """(1 - SSIM) / 2 of (N, H, W, C) batches (reference losses.py:68-81).
    ``weights`` (the alpha) blends both images onto black first, as the
    reference does."""
    if weights is not None:
        gt = gt * weights
        pred = pred * weights
    loss = (1.0 - ssim_index(gt, pred, max_val=max_val)) / 2.0
    return loss if keep_batch else torch.mean(loss)


_RGB_TO_YUV = ((0.299, -0.14714119, 0.61497538),
               (0.587, -0.28886916, -0.51496512),
               (0.114, 0.43601035, -0.10001026))


@functools.lru_cache(maxsize=None)
def _rgb_to_yuv_matrix(dtype, device):
    """The matrix on ``device``, made once: a train step copies nothing
    from the host (a CUDA graph cannot hold a copy from pageable memory)."""
    return torch.tensor(_RGB_TO_YUV, dtype=dtype, device=device)


def rgb_to_yuv(rgb):
    """BT.601 RGB -> YUV, as tf.image.rgb_to_yuv."""
    return rgb @ _rgb_to_yuv_matrix(rgb.dtype, rgb.device)


def uvl2(gt, pred, keep_batch=False, weights=None):
    """L2 on the chroma (the U and V of YUV) only (reference
    losses.py:49-67): hue and saturation errors, not brightness."""
    gt_yuv = rgb_to_yuv(torch.clamp(gt, 0.0, 1.0))
    pred_yuv = rgb_to_yuv(torch.clamp(pred, 0.0, 1.0))
    return l2(gt_yuv[..., 1:], pred_yuv[..., 1:], keep_batch=keep_batch,
              weights=weights)


def get_loss_fn(name):
    """'l1', 'l2', 'ssim', 'uvl2', and with pretrained perceptual weights
    ($NERFACTOR_LPIPS_WEIGHTS, models/perceptual.py) 'lpips' and
    'elpips'; any other name raises."""
    if name == 'l1':
        return l1
    if name == 'l2':
        return l2
    if name == 'ssim':
        return ssim
    if name == 'uvl2':
        return uvl2
    if name in ('lpips', 'elpips'):
        from nerfactor_tpu_torch.models import perceptual
        from nerfactor_tpu_torch.utils.ckpt import tree_map
        params = perceptual.get_params_or_none()
        if params is None:
            raise NotImplementedError(
                "%s needs pretrained perceptual weights (absent from this "
                "repository and from the reference release); set "
                "$NERFACTOR_LPIPS_WEIGHTS to a standard lpips/alexnet "
                "torch checkpoint, or use l1/l2/ssim" % name)

        def params_on(x):
            return tree_map(lambda t: t.to(x.device), params)

        if name == 'lpips':
            def lpips_loss(gt, pred, keep_batch=False, weights=None):
                if weights is not None:  # alpha-blend, as the SSIM loss
                    gt = gt * weights
                    pred = pred * weights
                val = perceptual.lpips(params_on(gt), gt, pred)
                return val if keep_batch else torch.mean(val)

            return lpips_loss

        def elpips_loss(gt, pred, keep_batch=False, weights=None,
                        generator=None, draws=None):
            # The ensemble is drawn from ``generator`` (or given as
            # ``draws``); without either perceptual.elpips raises
            if weights is not None:
                gt = gt * weights
                pred = pred * weights
            val = perceptual.elpips(params_on(gt), gt, pred,
                                    generator=generator, draws=draws)
            return val if keep_batch else torch.mean(val)

        return elpips_loss
    raise NotImplementedError("Loss '%s'" % name)


def init_wloss(loss_config_str):
    """Parses the config 'loss' string into [(weight, fn), ...]."""
    wloss = []
    for x in loss_config_str.split(','):
        name, weight = parse_loss_and_weight(x)
        wloss.append((weight, get_loss_fn(name)))
    return wloss
