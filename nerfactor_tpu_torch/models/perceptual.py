"""LPIPS (net-lin, AlexNet, v0.1) and its self-ensembled E-LPIPS in
PyTorch (counterpart of nerfactor_tpu/models/perceptual.py).

The reference wraps the frozen ``net-lin_alex_v0.1.pb`` graph as a metric
(xiuminglib/metric.py:195-278): AlexNet's five ReLU taps, each unit-
normalized over channels, squared differences through learned 1x1 linear
heads, spatial means summed over the taps, inputs in [-1, 1]. Its loss
names 'lpips' and 'elpips' point at classes its losses.py never defines
(models/base.py:49-55). No pretrained weights ship with the reference or
this repository: :func:`load_torch_weights` reads the standard
checkpoints where one exists --

  * a full ``lpips.LPIPS(net='alex')`` state dict
    (``net.sliceK.J.weight`` and ``linK.model.1.weight`` keys),
  * or a torchvision ``alexnet`` state dict (``features.J.weight``) with
    the lin-only ``lpips/weights/v0.1/alex.pth`` (``linK.model.1.weight``)
    --

and :func:`get_params_or_none` loads them from ``$NERFACTOR_LPIPS_WEIGHTS``
(and ``$NERFACTOR_LPIPS_LIN_WEIGHTS``). :func:`init_random_params` gives
random parameters of the right shapes, for tests only.

Parameters are {'convs': [(w, b)] * 5, 'lins': [lin] * 5}, the JAX
package's tree with each conv weight in PyTorch's OIHW layout (the JAX
package's is HWIO; utils/ckpt.params_from_jax converts). Images are
(N, H, W, 3) in [0, 1], as there. Convolutions run in f32 through
``F.conv2d``: on the card, call with ``torch.backends.cudnn.allow_tf32``
False (the entry points set it), or the card reads another number than
the CPU.

Two deviations from the JAX package's E-LPIPS, both faults there:
  * its crop offsets ``oy`` and ``ox`` come from one key, so they are
    equal whenever the image is square; here each has its own draw;
  * its loss falls back to a fixed ``PRNGKey(0)`` when no key is passed,
    so every step sees the same "random" ensemble; here :func:`elpips`
    raises without a ``generator`` or explicit ``draws``.
"""

import os

import numpy as np
import torch
import torch.nn.functional as F

# torchvision AlexNet ``features`` trunk: (out_ch, kernel, stride, pad),
# with 3x3/2 max-pools after the first two taps. LPIPS taps every ReLU
# output of the five conv layers.
_ALEX_CONVS = (
    (64, 11, 4, 2),
    (192, 5, 1, 2),
    (384, 3, 1, 1),
    (256, 3, 1, 1),
    (256, 3, 1, 1),
)
_POOL_AFTER = (0, 1)
_TAP_CHANNELS = tuple(c for c, _, _, _ in _ALEX_CONVS)

# lpips.ScalingLayer constants (v0.1), applied to [-1, 1] inputs
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


def init_random_params(generator, lin_positive=True, device='cpu'):
    """Random parameters of the right shapes (tests only: random features
    are not a perceptual metric)."""
    params = {'convs': [], 'lins': []}
    in_ch = 3
    for out_ch, k, _, _ in _ALEX_CONVS:
        w = torch.randn((out_ch, in_ch, k, k), generator=generator) * (
            1.0 / np.sqrt(k * k * in_ch))
        params['convs'].append((w.to(device), torch.zeros(out_ch,
                                                          device=device)))
        in_ch = out_ch
    for c in _TAP_CHANNELS:
        lin = torch.rand((c,), generator=generator)
        if lin_positive:
            lin = torch.abs(lin)  # lpips constrains lin weights >= 0
        params['lins'].append(lin.to(device))
    return params


def load_torch_weights(path, lin_path=None, device='cpu'):
    """LPIPS parameters from standard torch checkpoints (the layouts of
    the module docstring)."""
    state = torch.load(path, map_location='cpu', weights_only=True)
    if lin_path is not None:
        state = dict(state, **torch.load(lin_path, map_location='cpu',
                                         weights_only=True))

    def find(*names):
        for n in names:
            if n in state:
                return state[n].float().to(device)
        raise KeyError("none of %s in checkpoint %s (keys: %s...)"
                       % (names, path, sorted(state)[:8]))

    # The five convs' module indices inside torchvision's features trunk
    # and lpips's slices
    tv_idx = (0, 3, 6, 8, 10)
    slice_of = ((1, 0), (2, 3), (3, 6), (4, 8), (5, 10))
    params = {'convs': [], 'lins': []}
    for i in range(5):
        sk, sj = slice_of[i]
        params['convs'].append((
            find('net.slice%d.%d.weight' % (sk, sj),
                 'features.%d.weight' % tv_idx[i]),
            find('net.slice%d.%d.bias' % (sk, sj),
                 'features.%d.bias' % tv_idx[i])))
    for i in range(5):
        params['lins'].append(find('lin%d.model.1.weight' % i,
                                   'lins.%d.model.1.weight' % i).reshape(-1))
    return params


_WEIGHTS_ENV = 'NERFACTOR_LPIPS_WEIGHTS'
_LIN_ENV = 'NERFACTOR_LPIPS_LIN_WEIGHTS'
_cached = None


def get_params_or_none():
    """Parameters from $NERFACTOR_LPIPS_WEIGHTS (with
    $NERFACTOR_LPIPS_LIN_WEIGHTS for the torchvision-trunk layout), on the
    CPU; None when the variable is unset or its file is absent."""
    global _cached
    if _cached is not None:
        return _cached
    path = os.environ.get(_WEIGHTS_ENV)
    if not path or not os.path.exists(path):
        return None
    _cached = load_torch_weights(path,
                                 lin_path=os.environ.get(_LIN_ENV) or None)
    return _cached


def _features(params, x):
    """(N, 3, H, W) scaled input -> the five ReLU taps, NCHW."""
    taps = []
    for i, ((_, _, stride, pad), (w, b)) in enumerate(zip(
            _ALEX_CONVS, params['convs'])):
        x = F.relu(F.conv2d(x, w, b, stride=stride, padding=pad))
        taps.append(x)
        if i in _POOL_AFTER:
            x = F.max_pool2d(x, kernel_size=3, stride=2)
    return taps


def _unit_normalize(x, eps=1e-10):
    # lpips.normalize_tensor: x / (||x||_channels + eps)
    return x / (torch.sqrt(torch.sum(torch.square(x), dim=1,
                                     keepdim=True)) + eps)


def lpips(params, im0, im1):
    """LPIPS distance between (N, H, W, 3) batches in [0, 1], as the
    reference metric (metric.py:244-278): an (N,) vector, lower is
    better."""
    if im0.dim() != 4 or im0.shape[-1] != 3:
        raise ValueError("lpips expects (N, H, W, 3) batches")
    if im0.shape[1] < 32 or im0.shape[2] < 32:
        raise ValueError("lpips needs images of at least 32 x 32 (five "
                         "conv/pool stages)")
    shift = torch.tensor(_SHIFT, device=im0.device).reshape(1, 3, 1, 1)
    scale = torch.tensor(_SCALE, device=im0.device).reshape(1, 3, 1, 1)

    def prep(im):
        return ((im.permute(0, 3, 1, 2) * 2.0 - 1.0) - shift) / scale

    val = 0.0
    for t0, t1, lin in zip(_features(params, prep(im0)),
                           _features(params, prep(im1)), params['lins']):
        d = torch.square(_unit_normalize(t0) - _unit_normalize(t1))
        per_pix = torch.einsum('nchw,c->nhw', d, lin)  # the 1x1 head
        val = val + torch.mean(per_pix, dim=(1, 2))
    return val


# ---- E-LPIPS: LPIPS averaged over random transformations --------------
#
# The reference names 'elpips' but defines nothing behind it; the
# semantics are the E-LPIPS paper's (Kettunen et al. 2019): the base
# distance averaged over random transformations applied identically to
# both images. As in the JAX package: a crop of (H - 8, W - 8) at random
# offsets (no crop below 40 px), x and y mirror flips, a transpose when
# the crop is square, a channel permutation and a brightness factor in
# [0.2, 1].

_CROP_MARGIN = 8


def _crop_size(h, w):
    return (h - _CROP_MARGIN if h >= 32 + _CROP_MARGIN else h,
            w - _CROP_MARGIN if w >= 32 + _CROP_MARGIN else w)


def draw_transforms(generator, h, w, n_draws=8):
    """``n_draws`` transformations for (h, w) images, each a dict of
    ``oy``, ``ox`` (crop offsets, drawn apart), ``fx``, ``fy`` (flips),
    ``tr`` (transpose), ``perm`` (channel order) and ``mul`` (brightness),
    drawn from ``generator``."""
    ch, cw = _crop_size(h, w)

    def randint(hi):
        return int(torch.randint(0, hi, (), generator=generator))

    draws = []
    for _ in range(n_draws):
        draws.append({
            'oy': randint(h - ch + 1), 'ox': randint(w - cw + 1),
            'fx': bool(randint(2)), 'fy': bool(randint(2)),
            'tr': bool(randint(2)) if ch == cw else False,
            'perm': torch.randperm(3, generator=generator).tolist(),
            'mul': 0.2 + 0.8 * float(torch.rand((), generator=generator))})
    return draws


def transform(im, draw):
    """One transformation (a dict of :func:`draw_transforms`) of an
    (N, H, W, C) batch."""
    ch, cw = _crop_size(im.shape[1], im.shape[2])
    im = im[:, draw['oy']:draw['oy'] + ch, draw['ox']:draw['ox'] + cw, :]
    if draw['fx']:
        im = torch.flip(im, dims=(2,))
    if draw['fy']:
        im = torch.flip(im, dims=(1,))
    if draw['tr'] and ch == cw:
        im = im.transpose(1, 2)
    return im[..., list(draw['perm'])] * draw['mul']


def elpips(params, im0, im1, generator=None, draws=None, n_draws=8):
    """LPIPS averaged over ``n_draws`` transformations drawn from
    ``generator``, or over the explicit ``draws`` (dicts of
    :func:`draw_transforms`), identical for both images: an (N,) vector,
    lower is better. Raises without either."""
    if draws is None:
        if generator is None:
            raise ValueError("E-LPIPS draws its transformations: pass a "
                             "generator or draws")
        draws = draw_transforms(generator, im0.shape[1], im0.shape[2],
                                n_draws)
    vals = [lpips(params, transform(im0, d), transform(im1, d))
            for d in draws]
    return torch.mean(torch.stack(vals), dim=0)
