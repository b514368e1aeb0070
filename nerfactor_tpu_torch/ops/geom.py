"""Local shading frames, Rusinkiewicz coordinates and slerp (counterpart
of nerfactor_tpu/ops/geom.py; reference nerfactor/util/geom.py:100-192)."""

import functools
import math

import torch

from nerfactor_tpu_torch.ops import math as mathops


@functools.lru_cache(maxsize=None)
def _axis(axis, dtype, device):
    """The unit ``axis`` as a (1, 3) tensor on ``device``, made once (a
    train step copies nothing from the host)."""
    return torch.tensor(axis, dtype=dtype, device=device).reshape(1, 3)


def gen_world2local(normal, eps=1e-6):
    """(N, 3) normals (not necessarily unit) -> (N, 3, 3) rotations whose
    rows are [tangent, binormal, normal]: world vectors into local frames
    where the normal is +Z."""
    normal = mathops.safe_l2_normalize(normal, dim=1)
    # Fixed up-ish axis, perturbed off colinearity with e.g. (0, 0, 1)
    z = (_axis((0.0, 0.0, 1.0), normal.dtype, normal.device)
         + eps).expand_as(normal)
    t = mathops.safe_l2_normalize(torch.linalg.cross(normal, z, dim=1),
                                  dim=1)
    b = mathops.safe_l2_normalize(torch.linalg.cross(normal, t, dim=1),
                                  dim=1)
    return torch.stack((t, b, normal), dim=1)


def _rot_vec(vector, axis, angle):
    """Rodrigues rotation of ``vector`` (N, 3) around the unit ``axis`` by
    per-row ``angle`` (N,)."""
    cos_ang = torch.cos(angle).reshape(-1, 1)
    sin_ang = torch.sin(angle).reshape(-1, 1)
    axis = _axis(axis, vector.dtype, vector.device)
    dot = vector @ axis.T  # (N, 1)
    return (vector * cos_ang
            + axis * dot * (1.0 - cos_ang)
            + torch.linalg.cross(axis.expand_as(vector), vector, dim=1)
            * sin_ang)


def dir2rusink(a, b):
    """(N, 3) light and view directions in the local frame -> (N, 3)
    Rusinkiewicz coordinates (phi_d, theta_h, theta_d), phi_d in [0, pi).

    ``torch.remainder`` is the floored modulo of ``jnp.mod`` (fmod, then
    shifted by pi where negative); ``torch.fmod`` would truncate."""
    a = mathops.safe_l2_normalize(a, dim=1)
    b = mathops.safe_l2_normalize(b, dim=1)
    h = mathops.safe_l2_normalize((a + b) / 2.0, dim=1)
    theta_h = mathops.safe_acos(h[:, 2])
    phi_h = mathops.safe_atan2(h[:, 1], h[:, 0])
    diff = _rot_vec(_rot_vec(b, (0.0, 0.0, 1.0), -phi_h),
                    (0.0, 1.0, 0.0), -theta_h)
    # When a == b, diff lies along +h: theta_d = 0 and phi_d is undefined;
    # safe_atan2 keeps the backward pass finite there
    theta_d = mathops.safe_acos(diff[:, 2])
    phi_d = torch.remainder(mathops.safe_atan2(diff[:, 1], diff[:, 0]),
                            math.pi)
    return torch.stack((phi_d, theta_h, theta_d), dim=1)


def slerp(p0, p1, t):
    """Spherical linear interpolation between two unit latent codes, 2D
    with one singleton dimension each (reference util/geom.py:100-116)."""
    if not p0.dim() == p1.dim() == 2:
        raise ValueError("Vectors must be 2D")
    if p0.shape[0] == 1:
        cos_omega = p0 @ p1.T
    elif p0.shape[1] == 1:
        cos_omega = p0.T @ p1
    else:
        raise ValueError("Vectors should have one singleton dimension")
    omega = mathops.safe_acos(cos_omega)
    z0 = p0 * torch.sin((1 - t) * omega) / torch.sin(omega)
    z1 = p1 * torch.sin(t * omega) / torch.sin(omega)
    return z0 + z1
