"""Numerically safe math with custom gradients, and NeRF's resampling
math (counterpart of nerfactor_tpu/ops/math.py).

The Rusinkiewicz transform NaNs in its backward pass without these:
``safe_atan2`` and ``safe_acos`` keep finite gradients at their kinks,
with the same gradient formulas as the JAX package's ``custom_jvp`` rules.
"""

import torch

EPS = 1e-6


class _SafeAtan2(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.atan2(a, b)

    @staticmethod
    def backward(ctx, grad):
        a, b = ctx.saved_tensors
        denom = a ** 2 + b ** 2 + EPS
        return grad * (b / denom), grad * (-a / denom)


class _SafeAcos(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        x_clip = torch.clamp(x, -1.0, 1.0)
        ctx.save_for_backward(x_clip)
        return torch.acos(x_clip)

    @staticmethod
    def backward(ctx, grad):
        (x_clip,) = ctx.saved_tensors
        denom = torch.sqrt(1.0 - x_clip ** 2 + EPS) + EPS
        return grad * (-1.0 / denom)


def safe_atan2(a, b):
    """``atan2(a, b)`` whose gradient is finite at (0, 0):
    d/da = b / (a^2 + b^2 + eps), d/db = -a / (a^2 + b^2 + eps)."""
    return _SafeAtan2.apply(a, b)


def safe_acos(x):
    """``acos(clip(x, -1, 1))`` with gradient
    -1 / (sqrt(1 - x^2 + eps) + eps), large but finite at +-1."""
    return _SafeAcos.apply(x)


def safe_l2_normalize(x, dim=None, eps=EPS):
    """``x * rsqrt(max(sum(x^2), eps))`` over ``dim`` (all if None), as
    ``tf.linalg.l2_normalize``."""
    if dim is None:
        sq = torch.sum(torch.square(x)).reshape((1,) * x.dim())
    else:
        sq = torch.sum(torch.square(x), dim=dim, keepdim=True)
    return x * torch.rsqrt(torch.clamp(sq, min=eps))


def divide_no_nan(num, denom):
    """0 where denom == 0, as ``tf.math.divide_no_nan``."""
    zero = denom == 0
    safe = torch.where(zero, torch.ones_like(denom), denom)
    return torch.where(zero, torch.zeros_like(num * safe), num / safe)


class _CumprodNonzero(torch.autograd.Function):
    """torch.cumprod along the last dim of a tensor with no zero element.
    Its backward is the one torch.cumprod's takes for such an input,
    reversed_cumsum(out * grad) / x, without torch's check for zeros (a
    read of the device's answer back to the host every step, which a
    CUDA graph cannot hold)."""

    @staticmethod
    def forward(ctx, x):
        out = torch.cumprod(x, dim=-1)
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    def backward(ctx, grad):
        x, out = ctx.saved_tensors
        return (out * grad).flip(-1).cumsum(-1).flip(-1).div(x)


def safe_cumprod(x, eps=EPS):
    """Exclusive cumprod of ``x + eps`` along the last dim:
    out[..., i] = prod_{j<i} (x[..., j] + eps), out[..., 0] = 1. ``x`` is
    >= 0 (one minus an opacity), so ``x + eps`` has no zero."""
    cp = _CumprodNonzero.apply(x + eps)
    return torch.cat([torch.ones_like(cp[..., :1]), cp[..., :-1]], dim=-1)


def linspace01(n, device=None):
    """``n`` points evenly spaced over [0, 1], bit for bit as XLA computes
    ``jnp.linspace(0, 1, n)``: i * f32(1 / (n - 1)), the last exactly 1.
    (``torch.linspace`` and i / (n - 1) round some points differently, and
    posenc carries one ulp of a depth up to 2^9 ulps.)"""
    if n == 1:
        return torch.zeros(1, device=device)
    # Made on the device (a fill, no copy from the host), so that a CUDA
    # graph can hold it
    step = torch.full((), 1.0 / (n - 1), dtype=torch.float32, device=device)
    t = torch.arange(n, dtype=torch.float32, device=device) * step
    t[-1:].fill_(1.0)
    return t


def inv_transform_sample(val, weights, n_samples, det=False, u=None,
                         generator=None, eps=1e-5):
    """Inverse-transform (importance) sampling along rays, as the JAX
    package's ``inv_transform_sample`` (reference util/math.py:71-94).

    ``val`` (n_rays, n_bins) positions with unnormalised ``weights`` of
    the same shape; draws ``n_samples`` per ray: evenly spaced in the CDF
    when ``det``, else at the uniform draws ``u`` (n_rays, n_samples),
    or drawn from ``generator`` when ``u`` is None.

    ``searchsorted(cdf, u, right=True)`` counts the CDF entries <= u, the
    index the JAX package builds with a compare-and-sum (a TPU
    workaround), so both pick the same bins.
    """
    denom = torch.sum(weights, dim=-1, keepdim=True) + eps
    cdf = torch.cumsum(weights / denom, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[:, :1]), cdf], dim=-1)
    n_rays, n_bins1 = cdf.shape
    if det:
        u = linspace01(n_samples, device=cdf.device).expand(n_rays, n_samples)
    elif u is None:
        if generator is None:
            raise ValueError("Random sampling needs a generator or draws u")
        u = torch.rand((n_rays, n_samples), generator=generator,
                       device=cdf.device)
    u = u.contiguous()
    ind = torch.searchsorted(cdf.contiguous(), u, right=True)
    below = torch.clamp(ind - 1, min=0)
    above = torch.clamp(ind, max=n_bins1 - 1)
    n_val = val.shape[-1]
    cdf_b = torch.gather(cdf, 1, below)
    cdf_a = torch.gather(cdf, 1, above)
    val_b = torch.gather(val, 1, torch.clamp(below, max=n_val - 1))
    val_a = torch.gather(val, 1, torch.clamp(above, max=n_val - 1))
    denom = cdf_a - cdf_b
    denom = torch.where(denom < eps, torch.ones_like(denom), denom)
    t = (u - cdf_b) / denom
    return val_b + t * (val_a - val_b)
