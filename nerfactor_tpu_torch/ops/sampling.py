"""NeRF ray sampling and volume-rendering accumulation (counterpart of
nerfactor_tpu/ops/sampling.py).

Each random draw comes from an explicit ``torch.Generator`` or is passed
in as a tensor, so a test can feed the JAX package's draws to both.
"""

import torch

from nerfactor_tpu_torch.ops.math import (
    inv_transform_sample, linspace01, safe_cumprod)


def gen_z(near, far, n_samples, n_rays, lin_in_disp=False, perturb=False,
          generator=None, t_rand=None, device=None):
    """Stratified depths along rays: (n_rays, n_samples). With
    ``perturb``, each depth moves uniformly within its stratum by
    ``t_rand`` (n_rays, n_samples) in [0, 1), or by a draw from
    ``generator``."""
    t = linspace01(n_samples, device=device)
    if lin_in_disp:
        z = 1.0 / (1.0 / near * (1.0 - t) + 1.0 / far * t)
    else:
        z = near * (1.0 - t) + far * t
    z = z.expand(n_rays, n_samples)
    if perturb:
        if t_rand is None:
            if generator is None:
                raise ValueError("Perturbed sampling needs a generator or "
                                 "draws t_rand")
            t_rand = torch.rand(z.shape, generator=generator, device=device)
        mid = 0.5 * (z[:, 1:] + z[:, :-1])
        upper = torch.cat([mid, z[:, -1:]], dim=-1)
        lower = torch.cat([z[:, :1], mid], dim=-1)
        z = lower + (upper - lower) * t_rand
    return z


def gen_z_fine(z_coarse, weights, n_samples_fine, perturb=False,
               generator=None, u=None):
    """Importance-resamples depths from the coarse weights; returns the
    sorted union of coarse and fine depths (n_rays, n_coarse + n_fine).
    No gradient flows into the resampled depths."""
    mid = 0.5 * (z_coarse[:, 1:] + z_coarse[:, :-1])
    z_fine = inv_transform_sample(
        mid, weights[..., 1:-1], n_samples_fine, det=not perturb, u=u,
        generator=generator).detach()
    return torch.sort(torch.cat((z_coarse, z_fine), dim=-1), dim=-1).values


def accumulate_sigma(sigma, z, rayd, noise_std=0.0, generator=None,
                     noise=None, inf=1e10):
    """sigma (n_rays, n_samples) -> compositing weights (same shape):
    weights[i] = alpha_i * prod_{j<i}(1 - alpha_j),
    alpha_i = 1 - exp(-relu(sigma_i + noise_std * noise_i) * dist_i),
    ``noise`` standard normal (given, or drawn from ``generator``)."""
    dist = z[:, 1:] - z[:, :-1]
    dist = torch.cat([dist, torch.full_like(dist[:, :1], inf)], dim=-1)
    dist = dist * torch.linalg.norm(rayd[:, None, :], dim=-1)
    if noise_std > 0:
        if noise is None:
            if generator is None:
                raise ValueError("Sigma noise needs a generator or draws")
            noise = torch.randn(sigma.shape, generator=generator,
                                device=sigma.device)
        sigma = sigma + noise * noise_std
    density = 1.0 - torch.exp(-torch.relu(sigma) * dist)
    return density * safe_cumprod(1.0 - density)


def accumulate(rgb_sig, z, weights, white_bg, eps=1e-10):
    """Composites per-sample raw (rgb, sigma) (n_rays, n_samples, 4) into
    per-ray outputs: {'rgb' (n_rays, 3), 'occu', 'depth', 'disp'
    (n_rays,)}. rgb passes through a sigmoid here; sigma was consumed
    into ``weights`` (:func:`accumulate_sigma`)."""
    rgb = torch.sigmoid(rgb_sig[:, :, :3])
    occu = torch.sum(weights, dim=-1)
    rgb = torch.sum(weights[:, :, None] * rgb, dim=-2)
    depth = torch.sum(weights * z, dim=-1)
    disp = 1.0 / torch.clamp(depth, min=eps)
    bg = 1.0 if white_bg else 0.0
    rgb = rgb * occu[:, None] + bg * (1.0 - occu[:, None])
    return {'rgb': rgb, 'occu': occu, 'depth': depth, 'disp': disp}
