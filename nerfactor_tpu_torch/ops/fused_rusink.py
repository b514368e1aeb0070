"""The frozen BRDF chain on in-kernel Rusinkiewicz coordinates
(counterpart of nerfactor_tpu/ops/pallas_rusink.py).

The joint model evaluates ``chain([z | dir2rusink(ldir, vdir)])`` at
rays x lights scale. :func:`apply_rusink_chain` runs it:

  * on CUDA tensors through kernel K2-fwd (``csrc/fused_rusink.cu``),
    which computes the transform per row inside the chain kernel; under
    autograd the backward is kernel K2-bwd, which returns the input
    cotangents (dz, dldir, dvdir) only: the chain's weights are frozen;
  * on CPU tensors through :func:`reference`, the plain composition
    ``dir2rusink`` + ``chain_reference`` under ordinary autograd.
"""

import ctypes

import torch

from nerfactor_tpu_torch.ops import fused_mlp as fm
from nerfactor_tpu_torch.ops import geom as geomops


def reference(plan, z, ldir, vdir, params, compute_dtype=None):
    """Plain version: the exact unfused program (dir2rusink + chain)."""
    x = torch.cat((z, geomops.dir2rusink(ldir, vdir)), dim=1)
    return fm.chain_reference(plan, x, params, compute_dtype=compute_dtype)


def _inputs(plan, z, ldir, vdir):
    """The kernels' row inputs; ``plan`` must embed [(z_dim, 0), (3, f)]
    and have no skip after its last layer."""
    z_dim = fm.raw_dim(plan) - 3
    if plan.embed_parts[-1][0] != 3 or z_dim < 1 or fm.last_skip(plan):
        raise ValueError("Plan must end in a 3-d rusink part and skip after "
                         "no last layer: %s" % (plan,))
    return [('z', z, z_dim), ('ldir', ldir, 3), ('vdir', vdir, 3)]


def rusink_kernel(plan, z, ldir, vdir, params, compute_dtype=None):
    """Launches K2-fwd: (N, z_dim), (N, 3), (N, 3) CUDA f32 -> (N, out) f32.
    Counts its launches in ``rusink_kernel.launches``."""
    y = fm.launch('nfk_rusink_chain_fwd', plan, _inputs(plan, z, ldir, vdir),
                  params, compute_dtype)
    if y is None:
        return z.new_empty((0, plan.widths[-1]))
    rusink_kernel.launches += 1
    return y


rusink_kernel.launches = 0


def rusink_kernel_bwd(plan, z, ldir, vdir, dy, params, compute_dtype=None):
    """Launches K2-bwd: the input cotangents (dz, dldir, dvdir), f32, of
    :func:`rusink_kernel` for the output cotangent ``dy`` (N, out). Counts
    its launches in ``rusink_kernel_bwd.launches``."""
    (z, ldir, vdir, dy), desc, bf16, w_flat, b_flat = fm.prepare(
        plan, _inputs(plan, z, ldir, vdir) + [('dy', dy, plan.widths[-1])],
        params, compute_dtype)
    dz, dl, dv = (torch.empty_like(t) for t in (z, ldir, vdir))
    if z.shape[0]:
        fm.run('nfk_rusink_chain_bwd', z.device, ctypes.addressof(desc), bf16,
               z.data_ptr(), ldir.data_ptr(), vdir.data_ptr(), dy.data_ptr(),
               w_flat.data_ptr(), b_flat.data_ptr(), dz.data_ptr(),
               dl.data_ptr(), dv.data_ptr(), z.shape[0])
        rusink_kernel_bwd.launches += 1
    return dz, dl, dv


rusink_kernel_bwd.launches = 0


class RusinkFunction(torch.autograd.Function):
    """K2-fwd with K2-bwd as its backward (the JAX package's ``_fused``
    custom VJP): input cotangents from the kernel, zero weight cotangents
    (the BRDF prior is frozen)."""

    @staticmethod
    def forward(ctx, plan, compute_dtype, z, ldir, vdir, *flat):
        ctx.save_for_backward(z, ldir, vdir, *flat)
        ctx.plan, ctx.compute_dtype = plan, compute_dtype
        return rusink_kernel(plan, z, ldir, vdir,
                             list(zip(flat[0::2], flat[1::2])), compute_dtype)

    @staticmethod
    def backward(ctx, dy):
        z, ldir, vdir, *flat = ctx.saved_tensors
        grads = rusink_kernel_bwd(ctx.plan, z, ldir, vdir, dy,
                                  list(zip(flat[0::2], flat[1::2])),
                                  ctx.compute_dtype)
        return (None, None) + fm.grads_or_zeros(
            ctx, 2, list(grads) + [None] * len(flat),
            [z, ldir, vdir] + list(flat))


def apply_rusink_chain(plan, z, ldir, vdir, params, force_reference=False,
                       compute_dtype=None):
    """(N, z), (N, 3), (N, 3) -> (N, out): the frozen BRDF chain on
    Rusinkiewicz coordinates. A CPU tensor (or ``force_reference``) takes
    the plain version; a CUDA tensor the kernels."""
    params = [(w, b) for w, b in params]
    if force_reference or z.device.type == 'cpu':
        return reference(plan, z, ldir, vdir, params,
                         compute_dtype=compute_dtype)
    flat = [t for pair in params for t in pair]
    if fm.needs_autograd([z, ldir, vdir] + flat):
        return RusinkFunction.apply(plan, compute_dtype, z, ldir, vdir, *flat)
    return rusink_kernel(plan, z, ldir, vdir, params,
                         compute_dtype=compute_dtype)
