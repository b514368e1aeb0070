"""Differentiable GGX microfacet BRDF (Walter et al., EGSR '07); the
counterpart of nerfactor_tpu/ops/microfacet.py.

Plain tensor math on the port's ``safe_l2_normalize`` and
``divide_no_nan`` (D at the reference's brdf/microfacet/microfacet.py:93,
G at :75, Schlick's Fresnel at :106). The JAX package runs its dot
products at ``Precision.HIGHEST``; here each is summed in float64 and
rounded to f32 once (no TF32 anywhere).
"""

import math

import torch

from nerfactor_tpu_torch.ops.math import safe_l2_normalize, divide_no_nan


def _dot(a, b):
    """Dot product over the last dim, summed in float64 and rounded once:
    at grazing views the lobe divides by v.n and l.n, so their rounding
    is what its gradients carry."""
    return torch.sum(a.double() * b.double(), dim=-1).to(a.dtype)


def microfacet_spec(pts2l, pts2c, normal, rough=None, default_rough=0.3,
                    f0=0.91):
    """Achromatic GGX specular lobe F*G*D / (4 |l.n| |v.n|).

    The full microfacet BRDF is ``albedo/pi + spec[..., None]``: keeping
    the (N, L) factor apart lets the joint model's render contract it
    against the lights as a matmul (models/nerfactor.py ``render``).

    Args:
      pts2l: (N, L, 3) surface-to-light directions.
      pts2c: (N, 3) surface-to-camera directions.
      normal: (N, 3).
      rough: (N, 1) or None (``default_rough`` everywhere).

    Returns:
      (N, L) specular BRDF values.
    """
    n = pts2c.shape[0]
    if rough is None:
        rough = default_rough * torch.ones((n, 1), dtype=pts2c.dtype,
                                           device=pts2c.device)
    pts2l = safe_l2_normalize(pts2l, dim=2)
    pts2c = safe_l2_normalize(pts2c, dim=1)
    normal = safe_l2_normalize(normal, dim=1)
    # Half vectors
    h = safe_l2_normalize(pts2l + pts2c[:, None, :], dim=2)
    f = _fresnel_schlick(pts2l, h, f0)  # (N, L)
    alpha = rough ** 2
    d = _distribution_ggx(h, normal, alpha)  # (N, L)
    g = _geometry_ggx(pts2c, h, normal, alpha)  # (N, L)
    l_dot_n = _dot(pts2l, normal[:, None, :])  # (N, L)
    v_dot_n = _dot(pts2c, normal)  # (N,)
    denom = 4 * torch.abs(l_dot_n) * torch.abs(v_dot_n)[:, None]
    return divide_no_nan(f * g * d, denom)


def microfacet_brdf(pts2l, pts2c, normal, albedo=None, rough=None,
                    default_rough=0.3, lambert_only=False, f0=0.91):
    """The GGX microfacet BRDF in world coordinates.

    Args:
      pts2l: (N, L, 3) surface-to-light directions.
      pts2c: (N, 3) surface-to-camera directions.
      normal: (N, 3).
      albedo: (N, 3) or None (1 everywhere).
      rough: (N, 1) or None (``default_rough`` everywhere).

    Returns:
      (N, L, 3) BRDF values.
    """
    n, n_lights = pts2c.shape[0], pts2l.shape[1]
    if albedo is None:
        albedo = torch.ones((n, 3), dtype=pts2c.dtype, device=pts2c.device)
    brdf_diffuse = (albedo / math.pi)[:, None, :].expand(n, n_lights, 3)
    if lambert_only:
        return brdf_diffuse
    spec = microfacet_spec(pts2l, pts2c, normal, rough=rough,
                           default_rough=default_rough, f0=f0)
    return spec[:, :, None] + brdf_diffuse


def _geometry_ggx(v, m, n, alpha):
    """GGX geometric attenuation G(v, m)."""
    cos_theta_v = _dot(n, v)  # (N,)
    cos_theta = _dot(m, v[:, None, :])  # (N, L)
    div = divide_no_nan(cos_theta, cos_theta_v[:, None])
    chi = (div > 0).to(v.dtype)
    cos_theta_v_sq = torch.clamp(torch.square(cos_theta_v), 0.0, 1.0)
    tan_theta_v_sq = torch.clamp(
        divide_no_nan(1.0 - cos_theta_v_sq, cos_theta_v_sq), min=0.0)
    denom = 1 + torch.sqrt(1 + alpha ** 2 * tan_theta_v_sq[:, None])
    return divide_no_nan(chi * 2, denom)


def _distribution_ggx(m, n, alpha):
    """GGX normal distribution D(m)."""
    cos_theta_m = _dot(m, n[:, None, :])  # (N, L)
    chi = (cos_theta_m > 0).to(m.dtype)
    cos_theta_m_sq = torch.square(cos_theta_m)
    tan_theta_m_sq = divide_no_nan(1.0 - cos_theta_m_sq, cos_theta_m_sq)
    denom = math.pi * torch.square(cos_theta_m_sq) * torch.square(
        alpha ** 2 + tan_theta_m_sq)
    return divide_no_nan(alpha ** 2 * chi, denom)


def _fresnel_schlick(l, m, f0):
    cos_theta = _dot(l, m)
    return f0 + (1 - f0) * (1 - cos_theta) ** 5
