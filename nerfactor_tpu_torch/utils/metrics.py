"""Image quality metrics, host side (counterpart of
nerfactor_tpu/utils/metrics.py; reference xiuminglib/metric.py:103, 152,
195). Models compute them on uint8 images."""

import numpy as np


def _dynamic_range(drange):
    if drange == 'uint8':
        return 255.0
    if drange == 'float':
        return 1.0
    return float(drange)


def psnr(im1, im2, drange='uint8'):
    """Peak signal-to-noise ratio in dB."""
    im1 = np.asarray(im1, dtype=np.float64)
    im2 = np.asarray(im2, dtype=np.float64)
    mse = np.mean((im1 - im2) ** 2)
    if mse == 0:
        return float('inf')
    maxv = _dynamic_range(drange)
    return float(10.0 * np.log10(maxv ** 2 / mse))


def ssim(im1, im2, drange='uint8'):
    """Mean local SSIM, 7x7 uniform window (skimage's default, which the
    reference's metric wraps)."""
    maxv = _dynamic_range(drange)
    im1 = np.asarray(im1, dtype=np.float64) / maxv
    im2 = np.asarray(im2, dtype=np.float64) / maxv
    if im1.ndim == 3:
        return float(np.mean([
            ssim(im1[:, :, c], im2[:, :, c], 'float')
            for c in range(im1.shape[2])]))
    from scipy.ndimage import uniform_filter
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    win = 7
    mu1 = uniform_filter(im1, win)
    mu2 = uniform_filter(im2, win)
    s11 = uniform_filter(im1 * im1, win) - mu1 * mu1
    s22 = uniform_filter(im2 * im2, win) - mu2 * mu2
    s12 = uniform_filter(im1 * im2, win) - mu1 * mu2
    num = (2 * mu1 * mu2 + c1) * (2 * s12 + c2)
    den = (mu1 ** 2 + mu2 ** 2 + c1) * (s11 + s22 + c2)
    return float(np.mean(num / den))


def lpips(im1, im2, drange='uint8', params=None):
    """LPIPS (lower is better) of H x W x 3 (or H x W) images, as the
    reference metric (xiuminglib/metric.py:244-278): scaled to [0, 1] by
    the dynamic range, gray stacked to RGB, one batch through the net-lin
    AlexNet on the parameters' device. Raises unless weights are
    available: ``params`` or $NERFACTOR_LPIPS_WEIGHTS
    (models/perceptual.py)."""
    import torch
    from nerfactor_tpu_torch.models import perceptual
    if params is None:
        params = perceptual.get_params_or_none()
    if params is None:
        raise NotImplementedError(
            "LPIPS needs pretrained weights; set $NERFACTOR_LPIPS_WEIGHTS "
            "(see models/perceptual.py)")
    maxv = _dynamic_range(drange)
    device = params['lins'][0].device
    ims = []
    for im in (im1, im2):
        im = np.asarray(im, dtype=np.float32) / maxv
        if im.ndim == 2:
            im = np.dstack([im] * 3)
        ims.append(torch.as_tensor(im[None], device=device))
    with torch.no_grad():
        return float(perceptual.lpips(params, ims[0], ims[1])[0])
