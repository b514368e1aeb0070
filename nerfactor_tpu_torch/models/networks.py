"""Skip-MLPs and GLO latent codes (counterpart of
nerfactor_tpu/models/networks.py).

Parameters are plain trees: an MLP is a list of {'w': (din, dout),
'b': (dout,)} tensor dicts, applied as ``x @ w + b`` -- the JAX layout,
so weights cross between the packages unchanged. Initialization follows
Keras Dense defaults (glorot-uniform kernels, zero biases), drawn from a
``torch.Generator``.
"""

import math

import torch

from nerfactor_tpu_torch.ops import geom
from nerfactor_tpu_torch.ops.math import safe_l2_normalize

ACTS = {
    None: lambda x: x,
    'none': lambda x: x,
    'relu': torch.relu,
    'sigmoid': torch.sigmoid,
    'softplus': lambda x: torch.logaddexp(x, torch.zeros_like(x)),
    'tanh': torch.tanh,
}


def glorot_uniform(generator, shape):
    fan_in, fan_out = shape[0], shape[1]
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    return (torch.rand(shape, generator=generator) * 2.0 - 1.0) * limit


def init_mlp(generator, in_dim, widths, skip_at=None):
    """Dense stack with optional input-skip concat: after layer i in
    ``skip_at`` the ORIGINAL input is concatenated onto that layer's
    activation (reference networks/mlp.py:39-50), so the next layer's
    fan-in grows by ``in_dim``."""
    skip_at = set(skip_at or ())
    params, din = [], in_dim
    for i, w in enumerate(widths):
        params.append({'w': glorot_uniform(generator, (din, w)),
                       'b': torch.zeros(w)})
        din = w + (in_dim if i in skip_at else 0)
    return params


def apply_mlp(params, x, acts=None, skip_at=None, compute_dtype=None):
    """Applies a skip-MLP; ``acts`` is one activation name per layer, or
    one name for all. ``compute_dtype`` (e.g. bf16) casts the input, the
    weights and each layer's pre-activation, the products accumulating in
    f32, and the output comes back as f32 (the JAX package's semantics)."""
    if acts is None or isinstance(acts, str):
        acts = [acts] * len(params)
    skip_at = set(skip_at or ())
    if compute_dtype is not None:
        x = x.to(compute_dtype)
    y = x
    for i, (layer, act) in enumerate(zip(params, acts)):
        w, b = layer['w'], layer['b']
        if compute_dtype is None:
            y = y @ w + b
        else:
            y = (torch.matmul(y.float(), w.to(compute_dtype).float())
                 + b.to(compute_dtype)).to(compute_dtype)
        y = ACTS[act](y)
        if i in skip_at:
            y = torch.cat((y, x), dim=-1)
    return y.float() if compute_dtype is not None else y


class MLPSpec:
    """Static description of one named MLP: shapes and activations."""

    def __init__(self, in_dim, widths, acts=None, skip_at=None):
        self.in_dim = in_dim
        self.widths = list(widths)
        self.acts = acts
        self.skip_at = list(skip_at) if skip_at else None

    def init(self, generator):
        return init_mlp(generator, self.in_dim, self.widths, self.skip_at)

    def apply(self, params, x, compute_dtype=None):
        return apply_mlp(params, x, self.acts, self.skip_at,
                         compute_dtype=compute_dtype)

    @property
    def out_dim(self):
        """Output dim, including the input concat if the last layer is a
        skip layer."""
        out = self.widths[-1]
        if self.skip_at and (len(self.widths) - 1) in self.skip_at:
            out += self.in_dim
        return out


def init_latent_code(generator, n_iden, dim, mean=0.0, std=1.0):
    """GLO latent table (reference networks/layers.py:24-44)."""
    return mean + std * torch.randn((n_iden, dim), generator=generator)


def latent_code_z(z_table, normalize=False):
    if normalize:
        return safe_l2_normalize(z_table, dim=1)
    return z_table


def latent_code_lookup(z_table, ind, normalize=False):
    return latent_code_z(z_table, normalize)[ind]


def latent_code_interp(z_table, w1, i1, w2, i2, normalize=False):
    """lerp (or slerp on the unit sphere) between two identities."""
    z = latent_code_z(z_table, normalize)
    z1, z2 = z[i1][None, :], z[i2][None, :]
    if normalize:
        if abs(w1 + w2 - 1.0) >= 1e-6:
            raise ValueError(
                "When latent codes are normalized, weights must sum to 1")
        return geom.slerp(z1, z2, w2)
    return w1 * z1 + w2 * z2
