"""Plain PyTorch pieces that the configurations' references share: the
positional encoding, the skip-MLP, the safe math with its custom
gradients, NeRF's sampling and compositing, the light sphere, TF's
Adam(amsgrad), and the fp8 operand rounding of the precision control.

Frozen copies of the port's plain paths (``nerfactor_tpu_torch/ops/
{encoding,math,sampling,geom,img,light}.py``, ``models/networks.py``,
``parallel/train.py``'s ``Optimizer``), so that a later change to the
program cannot move the yardstick. Nothing here imports the program.
Matrix products run in f32 with TF32 off (the caller turns it off).
"""

import math

import numpy as np
import torch

EPS = 1e-6


# ------ the precision of a chain's operands ------

def fp8(x):
    """``x`` rounded to float8 e4m3 under a per-tensor scale (the amax at
    448, the format's largest), back in f32."""
    scale = torch.clamp(x.abs().amax(), min=1e-30) / 448.0
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def tf32(x):
    """``x`` rounded to TF32 (10 mantissa bits, to nearest), in f32."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


class _Rounded(torch.autograd.Function):
    """``x @ w`` with every product's operands rounded by ``r``: the
    forward's, and the backward's (the output's cotangent with the
    rounded weights or inputs), accumulating in f32."""

    @staticmethod
    def forward(ctx, x, w, r):
        xq, wq = r(x), r(w)
        ctx.save_for_backward(xq, wq)
        ctx.r = r
        return xq @ wq

    @staticmethod
    def backward(ctx, g):
        xq, wq = ctx.saved_tensors
        gq = ctx.r(g)
        return gq @ wq.T, xq.T @ gq, None


def matmul(x, w, operands=None):
    """``x @ w`` in f32; with ``operands`` 'fp8' or 'tf32' every operand
    of the forward and backward products is rounded to that type first
    (the precision control)."""
    if operands is None:
        return x @ w
    return _Rounded.apply(x, w, {'fp8': fp8, 'tf32': tf32}[operands])


# ------ encoding and MLPs ------

def posenc(x, n_freqs):
    """[x, sin(2^0 x), cos(2^0 x), sin(2^1 x), ...] over the last dim."""
    feats = [x]
    for j in range(n_freqs):
        xf = float(2.0 ** j) * x
        feats += [torch.sin(xf), torch.cos(xf)]
    return torch.cat(feats, dim=-1)


def posenc_dims(in_dims, n_freqs):
    return in_dims * (1 + 2 * n_freqs)


ACTS = {None: lambda x: x, 'relu': torch.relu, 'sigmoid': torch.sigmoid,
        'softplus': lambda x: torch.logaddexp(x, torch.zeros_like(x))}


def mlp_shapes(in_dim, widths, skip_at=()):
    """[(fan_in, fan_out)] of a skip-MLP: after layer i in ``skip_at`` the
    input is concatenated onto that layer's activation."""
    shapes, din = [], in_dim
    for i, w in enumerate(widths):
        shapes.append((din, w))
        din = w + (in_dim if i in skip_at else 0)
    return shapes


def mlp_out_dim(in_dim, widths, skip_at=()):
    return widths[-1] + (in_dim if len(widths) - 1 in skip_at else 0)


def mlp_tree(in_dim, widths, skip_at=()):
    """The parameter layout of one MLP: [{'w': (din, dout), 'b': (dout,)}],
    as (shape, init) leaves; Keras' Dense defaults (glorot-uniform
    kernels, zero biases)."""
    return [{'w': ((din, dout), 'glorot'), 'b': ((dout,), 'zeros')}
            for din, dout in mlp_shapes(in_dim, widths, skip_at)]


def apply_mlp(layers, x, acts, skip_at=(), operands=None):
    """A skip-MLP over ``x``: ``acts`` one activation a layer or one for
    all; ``operands='fp8'`` rounds each product's operands to fp8."""
    if acts is None or isinstance(acts, str):
        acts = [acts] * len(layers)
    y = x
    for i, (layer, act) in enumerate(zip(layers, acts)):
        y = ACTS[act](matmul(y, layer['w'], operands) + layer['b'])
        if i in skip_at:
            y = torch.cat((y, x), dim=-1)
    return y


# ------ safe math ------

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
        return grad * (-1.0 / (torch.sqrt(1.0 - x_clip ** 2 + EPS) + EPS))


def normalize(x, dim):
    """``x * rsqrt(max(sum(x^2), eps))`` over ``dim``."""
    sq = torch.sum(torch.square(x), dim=dim, keepdim=True)
    return x * torch.rsqrt(torch.clamp(sq, min=EPS))


def exclusive_cumprod(x):
    """out[..., i] = prod_{j<i} (x[..., j] + eps), out[..., 0] = 1."""
    cp = torch.cumprod(x + EPS, dim=-1)
    return torch.cat([torch.ones_like(cp[..., :1]), cp[..., :-1]], dim=-1)


def linspace01(n, device):
    """i * f32(1 / (n - 1)), the last exactly 1 (as XLA's linspace)."""
    step = torch.full((), 1.0 / (n - 1), dtype=torch.float32, device=device)
    t = torch.arange(n, dtype=torch.float32, device=device) * step
    t[-1] = 1.0
    return t


# ------ geometry ------

def world2local(normal, eps=1e-6):
    """(N, 3) normals -> (N, 3, 3) rows [tangent, binormal, normal]."""
    normal = normalize(normal, 1)
    z = torch.tensor([0.0, 0.0, 1.0], device=normal.device) + eps
    t = normalize(torch.linalg.cross(normal, z.expand_as(normal), dim=1), 1)
    b = normalize(torch.linalg.cross(normal, t, dim=1), 1)
    return torch.stack((t, b, normal), dim=1)


def _rot_vec(v, axis, angle):
    cos_a = torch.cos(angle).reshape(-1, 1)
    sin_a = torch.sin(angle).reshape(-1, 1)
    axis = torch.tensor(axis, dtype=v.dtype, device=v.device).reshape(1, 3)
    dot = v @ axis.T
    return (v * cos_a + axis * dot * (1.0 - cos_a)
            + torch.linalg.cross(axis.expand_as(v), v, dim=1) * sin_a)


def dir2rusink(a, b):
    """Local light and view directions -> Rusinkiewicz (phi_d, theta_h,
    theta_d), phi_d in [0, pi)."""
    a, b = normalize(a, 1), normalize(b, 1)
    h = normalize((a + b) / 2.0, 1)
    theta_h = _SafeAcos.apply(h[:, 2])
    phi_h = _SafeAtan2.apply(h[:, 1], h[:, 0])
    diff = _rot_vec(_rot_vec(b, (0.0, 0.0, 1.0), -phi_h), (0.0, 1.0, 0.0),
                    -theta_h)
    theta_d = _SafeAcos.apply(diff[:, 2])
    phi_d = torch.remainder(_SafeAtan2.apply(diff[:, 1], diff[:, 0]),
                            math.pi)
    return torch.stack((phi_d, theta_h, theta_d), dim=1)


def light_sphere(h, w, radius=1e2):
    """World xyz (h*w, 3) of every pixel of an h x w equirectangular
    light map and its solid angle (h*w,), the angles summing to 4 pi."""
    lat_step, lng_step = np.pi / (h + 2), 2 * np.pi / (w + 2)
    lats = np.linspace(np.pi / 2 - lat_step, -np.pi / 2 + lat_step, h)
    lngs = np.linspace(np.pi - lng_step, -np.pi + lng_step, w)
    lngs, lats = np.meshgrid(lngs, lats)
    xyz = np.dstack((radius * np.cos(lats) * np.cos(lngs),
                     radius * np.cos(lats) * np.sin(lngs),
                     radius * np.sin(lats)))
    sin_colat = np.sin(np.pi / 2 - lats)
    areas = 4 * np.pi * sin_colat / np.sum(sin_colat)
    return xyz.reshape(-1, 3), areas.reshape(-1)


def linear2srgb(x):
    x = torch.clamp(x, 0.0, 1.0)
    nonlin = 1.055 * torch.pow(torch.clamp(x, min=1e-12), 1.0 / 2.4) - 0.055
    return torch.where(x <= 0.0031308, x * 12.92, nonlin)


# ------ NeRF sampling and compositing ------

def stratified_z(near, far, n_samples, n_rays, device, t_rand=None):
    """Depths evenly spaced in [near, far], each moved within its stratum
    by ``t_rand`` where given."""
    t = linspace01(n_samples, device)
    z = (near * (1.0 - t) + far * t).expand(n_rays, n_samples)
    if t_rand is not None:
        mid = 0.5 * (z[:, 1:] + z[:, :-1])
        upper = torch.cat([mid, z[:, -1:]], dim=-1)
        lower = torch.cat([z[:, :1], mid], dim=-1)
        z = lower + (upper - lower) * t_rand
    return z


def importance_z(z, weights, n_fine, u=None, eps=1e-5):
    """The sorted union of ``z`` and ``n_fine`` depths drawn by inverse
    transform from the weights of the bins between ``z``'s midpoints: at
    ``u`` where given, else evenly spaced in the CDF."""
    val = 0.5 * (z[:, 1:] + z[:, :-1])
    w = weights[..., 1:-1]
    cdf = torch.cumsum(w / (torch.sum(w, dim=-1, keepdim=True) + eps), dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[:, :1]), cdf], dim=-1)
    n_rays, n_bins1 = cdf.shape
    if u is None:
        u = linspace01(n_fine, cdf.device).expand(n_rays, n_fine)
    u = u.contiguous()
    ind = torch.searchsorted(cdf.contiguous(), u, right=True)
    below = torch.clamp(ind - 1, min=0)
    above = torch.clamp(ind, max=n_bins1 - 1)
    n_val = val.shape[-1]
    cdf_b, cdf_a = torch.gather(cdf, 1, below), torch.gather(cdf, 1, above)
    val_b = torch.gather(val, 1, torch.clamp(below, max=n_val - 1))
    val_a = torch.gather(val, 1, torch.clamp(above, max=n_val - 1))
    denom = cdf_a - cdf_b
    denom = torch.where(denom < eps, torch.ones_like(denom), denom)
    fine = (val_b + (u - cdf_b) / denom * (val_a - val_b)).detach()
    return torch.sort(torch.cat((z, fine), dim=-1), dim=-1).values


def composite_weights(sigma, z, rayd, inf=1e10):
    """alpha_i prod_{j<i} (1 - alpha_j), alpha_i = 1 - exp(-relu(sigma_i)
    dist_i)."""
    dist = z[:, 1:] - z[:, :-1]
    dist = torch.cat([dist, torch.full_like(dist[:, :1], inf)], dim=-1)
    dist = dist * torch.linalg.norm(rayd[:, None, :], dim=-1)
    density = 1.0 - torch.exp(-torch.relu(sigma) * dist)
    return density * exclusive_cumprod(1.0 - density)


# ------ the optimizer ------

B1, B2 = 0.9, 0.999  # Adam's decay rates, TF's defaults


def adam_amsgrad(params, grads, state, lr_t, b1=B1, b2=B2, eps=1e-7):
    """TF's Adam(amsgrad) step on lists of leaves: eps on the biased
    sqrt(vhat), the bias corrections in ``lr_t``; returns the new
    parameters and state ``(m, v, vhat)``."""
    m, v, vh = state
    m = [b1 * a + (1 - b1) * g for a, g in zip(m, grads)]
    v = [b2 * a + (1 - b2) * g * g for a, g in zip(v, grads)]
    vh = [torch.maximum(a, c) for a, c in zip(vh, v)]
    params = [p - lr_t * a / (torch.sqrt(c) + eps)
              for p, a, c in zip(params, m, vh)]
    return params, (m, v, vh)


def adam_lr(lr, decay_steps, decay_rate, count, b1=B1, b2=B2):
    """lr * decay_rate^(count / decay_steps) * sqrt(1 - b2^t) / (1 - b1^t)
    at t = count + 1, in f32 as the optimizer's."""
    c = torch.tensor(float(count), dtype=torch.float32)
    t = c + 1
    sched = lr if count <= 0 else lr * torch.pow(
        torch.tensor(decay_rate, dtype=torch.float32), c / decay_steps)
    return float(sched * torch.sqrt(1.0 - torch.pow(
        torch.tensor(b2), t)) / (1.0 - torch.pow(torch.tensor(b1), t)))
