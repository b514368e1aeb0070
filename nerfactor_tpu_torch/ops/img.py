"""Image ops (counterpart of nerfactor_tpu/ops/img.py).

Functions take torch tensors (model-side) or NumPy arrays (host-side
vis); ``resize`` runs on the host through ``F.interpolate``, whose
bilinear antialiased mode matches ``jax.image.resize(method='linear',
antialias=True)``.
"""

import numpy as np
import torch
import torch.nn.functional as F


def alpha_blend(tensor1, alpha, tensor2=None):
    """``tensor1 * alpha + tensor2 * (1 - alpha)``; an (H, W) alpha
    broadcasts over the channels of an (H, W, C) tensor; ``tensor2=None``
    is a zero background."""
    if tensor2 is None:
        xp = np if isinstance(tensor1, np.ndarray) else torch
        tensor2 = xp.zeros_like(tensor1)
    if tensor1.ndim == 3 and alpha.ndim == 2:
        alpha = alpha[:, :, None]
    return tensor1 * alpha + tensor2 * (1.0 - alpha)


def linear2srgb(tensor_0to1, clip=True):
    """Linear -> sRGB transfer curve (reference util/img.py:140-163). On
    tensors the pow input is clamped to 1e-12 so its gradient stays
    finite."""
    if isinstance(tensor_0to1, np.ndarray):
        if clip:
            tensor_0to1 = np.clip(tensor_0to1, 0.0, 1.0)
        nonlin = 1.055 * np.power(tensor_0to1, 1.0 / 2.4) - 0.055
        return np.where(tensor_0to1 <= 0.0031308, tensor_0to1 * 12.92,
                        nonlin)
    if clip:
        tensor_0to1 = torch.clamp(tensor_0to1, 0.0, 1.0)
    safe = torch.clamp(tensor_0to1, min=1e-12)
    nonlin = 1.055 * torch.pow(safe, 1.0 / 2.4) - 0.055
    return torch.where(tensor_0to1 <= 0.0031308, tensor_0to1 * 12.92,
                       nonlin)


def srgb2linear(tensor_0to1):
    """sRGB -> linear transfer curve, the inverse of :func:`linear2srgb`;
    inputs are clipped to [0, 1]."""
    xp = np if isinstance(tensor_0to1, np.ndarray) else torch
    tensor_0to1 = xp.clip(tensor_0to1, 0.0, 1.0)
    lin = tensor_0to1 / 12.92
    nonlin = ((tensor_0to1 + 0.055) / 1.055) ** 2.4
    return xp.where(tensor_0to1 <= 0.04045, lin, nonlin)


def rgb2lum(rgb):
    """Rec. 709 luminance of the last axis."""
    if isinstance(rgb, np.ndarray):
        return rgb @ np.asarray((0.2126, 0.7152, 0.0722), dtype=rgb.dtype)
    return rgb @ torch.tensor((0.2126, 0.7152, 0.0722), dtype=rgb.dtype,
                              device=rgb.device)


def resize(img, new_h=None, new_w=None):
    """Bilinear antialiased resize of an (H, W) or (H, W, C) NumPy array
    on the host; float arrays keep their dtype, others come back f32."""
    h, w = img.shape[0], img.shape[1]
    if new_h is not None and new_w is None:
        new_w = int(round(w / h * new_h))
    elif new_w is not None and new_h is None:
        new_h = int(round(h / w * new_w))
    elif new_h is None and new_w is None:
        raise ValueError("At least one of new height or width required")
    if (new_h, new_w) == (h, w):
        return img
    x = torch.from_numpy(np.asarray(img, np.float32))
    x = x[None, None] if x.dim() == 2 else x.permute(2, 0, 1)[None]
    out = F.interpolate(x, size=(new_h, new_w), mode='bilinear',
                        align_corners=False, antialias=True)[0]
    out = out[0] if img.ndim == 2 else out.permute(1, 2, 0)
    dtype = img.dtype if np.issubdtype(img.dtype, np.floating) \
        else np.float32
    return out.numpy().astype(dtype)


def normalize_uint(arr):
    """uint image -> float in [0, 1]."""
    return arr.astype(np.float32) / np.iinfo(arr.dtype).max


def to_uint(tensor_0to1, dtype=np.uint8):
    """[0, 1] floats -> clipped, truncated unsigned integers."""
    arr = np.clip(np.asarray(tensor_0to1), 0.0, 1.0)
    return (arr * np.iinfo(dtype).max).astype(dtype)


def _concat(img_list, axis, out_size=None):
    """Stacks images along ``axis`` (1 across, 0 down); a gray image
    becomes RGB, and each one is resized to the previous one's extent
    across the stacking axis; the result is resized to ``out_size``
    along it."""
    across = 1 - axis
    total = []
    for im in img_list:
        im = np.asarray(im)
        if im.ndim == 2:
            im = np.dstack([im] * 3)
        if total and im.shape[across] != total[-1].shape[across]:
            size = total[-1].shape[across]
            im = resize(im, new_h=size) if axis == 1 else \
                resize(im, new_w=size)
        total.append(im)
    out = np.concatenate(total, axis=axis)
    if out_size is not None:
        out = resize(out, new_w=out_size) if axis == 1 else \
            resize(out, new_h=out_size)
    return out


def hconcat(img_list, out_w=None):
    """Images side by side, each at the first one's height."""
    return _concat(img_list, 1, out_w)


def vconcat(img_list, out_h=None):
    """Images top to bottom, each at the first one's width."""
    return _concat(img_list, 0, out_h)
