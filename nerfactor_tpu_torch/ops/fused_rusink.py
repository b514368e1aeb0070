"""The frozen BRDF chain on in-kernel Rusinkiewicz coordinates
(counterpart of nerfactor_tpu/ops/pallas_rusink.py).

The joint model evaluates ``chain([z | dir2rusink(ldir, vdir)])`` at
rays x lights scale. :func:`apply_rusink_chain` runs it:

  * on CUDA tensors through kernel K2-fwd (``csrc/fused_rusink.cu``),
    which computes the transform per row inside the chain kernel; under
    autograd the backward is kernel K2-bwd, which returns the input
    cotangents (dz, dldir, dvdir) only: the chain's weights are frozen.
    In bf16 on the plans :func:`rusink_on_tensor_cores` takes (the shipped
    BRDF chain), both run on the tensor cores; every other call runs the
    CUDA-core kernels;
  * on CPU tensors through :func:`reference`, the plain composition
    ``dir2rusink`` + ``chain_reference`` under ordinary autograd.
"""

import ctypes
import functools

import torch

from nerfactor_tpu_torch.ops import fused_mlp as fm
from nerfactor_tpu_torch.ops import geom as geomops
from nerfactor_tpu_torch.ops import kernel_lib


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


@functools.lru_cache(maxsize=None)
def _tc_runs(plan, device):
    """Whether the library's tensor-core K2 kernels run ``plan`` as
    :func:`fused_mlp.mma_plan`'s (``nfk_rusink_chain_tc_runs``): a head of
    at most 8 columns with no skip after it or into it, every hidden act
    ReLU, and a backward block that fits the card's shared memory. Kept
    per plan and device, as ``fused_mlp._tc_runs``."""
    desc, runs = fm.make_desc(fm.mma_plan(plan)), ctypes.c_int(0)
    fm.run('nfk_rusink_chain_tc_runs', device, ctypes.addressof(desc),
           ctypes.byref(runs), stream=False)
    return runs.value != 0


def rusink_on_tensor_cores(plan, compute_dtype, device):
    """Whether K2-fwd and K2-bwd launches on ``device`` run the tensor-core
    kernels (``nfk_rusink_chain_fwd_tc``, ``nfk_rusink_chain_bwd_tc``):
    bf16 operands and a plan the library says they run (:func:`_tc_runs`).
    Every other launch (f32, any other plan) runs the CUDA-core kernels."""
    if fm.kernel_dtype(compute_dtype) != torch.bfloat16:
        return False
    return _tc_runs(plan, device)


def _tc_prepare(plan, inputs, params):
    """:func:`fused_mlp.prepare` for the tensor-core kernels, over the
    weights padded to :func:`fused_mlp.mma_plan`'s widths where they
    differ; also returns the padded params and the kernel's plan."""
    kplan = fm.mma_plan(plan)
    if kplan != plan:
        params = fm.pad_params(plan, params)
    tensors, desc, _, w_flat, b_flat = fm.prepare(kplan, inputs, params,
                                                  torch.bfloat16)
    return tensors, desc, w_flat, b_flat, params, kplan


def _rusink_fwd(plan, z, ldir, vdir, params, compute_dtype, tc):
    """Launches K2-fwd: the tensor-core kernel with ``tc`` (bf16), else the
    CUDA-core one. Returns the (N, out) f32 output, the transposed hidden
    weights the tensor-core kernel read (else None) and whether a kernel
    ran."""
    inputs = _inputs(plan, z, ldir, vdir)
    if not tc:
        y = fm.launch('nfk_rusink_chain_fwd', plan, inputs, params,
                      compute_dtype)
        if y is None:
            return z.new_empty((0, plan.widths[-1])), None, False
        return y, None, True
    (z, ldir, vdir), desc, w_flat, b_flat, params, kplan = _tc_prepare(
        plan, inputs, params)
    wt = fm.transposed_weights(kplan, w_flat, desc)
    n = z.shape[0]
    y = torch.empty((n, plan.widths[-1]), dtype=torch.float32,
                    device=z.device)
    if n:
        fm.run('nfk_rusink_chain_fwd_tc', z.device, ctypes.addressof(desc),
               z.data_ptr(), ldir.data_ptr(), vdir.data_ptr(),
               w_flat.data_ptr(), wt.data_ptr(), b_flat.data_ptr(),
               y.data_ptr(), n)
    return y, wt, n > 0


def _rusink_kernel(plan, z, ldir, vdir, params, compute_dtype):
    """K2-fwd as :func:`rusink_kernel` launches it; returns (y, the
    transposed hidden weights the tensor-core kernel read, else None)."""
    tc = rusink_on_tensor_cores(plan, compute_dtype, z.device)
    y, wt, ran = _rusink_fwd(plan, z, ldir, vdir, params, compute_dtype, tc)
    rusink_kernel.launches += ran
    rusink_kernel.tc_launches += int(ran and tc)
    return y, wt


def rusink_kernel(plan, z, ldir, vdir, params, compute_dtype=None):
    """Launches K2-fwd: (N, z_dim), (N, 3), (N, 3) CUDA f32 -> (N, out) f32.
    In bf16 on the plans :func:`rusink_on_tensor_cores` takes, that is
    ``rusink_chain_fwd_tc_kernel`` on the tensor cores; every other call
    runs the CUDA-core ``rusink_chain_fwd_kernel``. Counts its launches in
    ``rusink_kernel.launches``, those of the tensor-core kernel also in
    ``rusink_kernel.tc_launches``."""
    return _rusink_kernel(plan, z, ldir, vdir, params, compute_dtype)[0]


kernel_lib.launch_counters(rusink_kernel, 'launches', 'tc_launches')


def rusink_kernel_cuda_core(plan, z, ldir, vdir, params, compute_dtype=None):
    """The CUDA-core K2-fwd (``rusink_chain_fwd_kernel``) in either
    precision: what :func:`rusink_kernel` runs off the tensor cores, and in
    bf16 the kernel the tensor-core one is held against. Counts no
    launch."""
    return _rusink_fwd(plan, z, ldir, vdir, params, compute_dtype, False)[0]


def _rusink_bwd(plan, z, ldir, vdir, dy, params, compute_dtype, tc, wt=None):
    """Launches K2-bwd for the output cotangent ``dy`` (N, out): the
    tensor-core kernel with ``tc`` (over ``wt``, packed here when None),
    else the CUDA-core one. Returns (dz, dldir, dvdir), f32, and whether a
    kernel ran."""
    inputs = _inputs(plan, z, ldir, vdir) + [('dy', dy, plan.widths[-1])]
    if tc:
        (z, ldir, vdir, dy), desc, w_flat, b_flat, params, kplan = \
            _tc_prepare(plan, inputs, params)
        if wt is None:
            wt = fm.transposed_weights(kplan, w_flat, desc)
        entry, flags, weights = 'nfk_rusink_chain_bwd_tc', (), (w_flat, wt)
    else:
        (z, ldir, vdir, dy), desc, bf16, w_flat, b_flat = fm.prepare(
            plan, inputs, params, compute_dtype)
        entry, flags, weights = 'nfk_rusink_chain_bwd', (bf16,), (w_flat,)
    dz, dl, dv = (torch.empty_like(t) for t in (z, ldir, vdir))
    n = z.shape[0]
    if n:
        fm.run(entry, z.device, ctypes.addressof(desc), *flags,
               *[t.data_ptr() for t in (z, ldir, vdir, dy) + weights
                 + (b_flat, dz, dl, dv)], n)
    return (dz, dl, dv), n > 0


def rusink_kernel_bwd(plan, z, ldir, vdir, dy, params, compute_dtype=None,
                      wt=None):
    """Launches K2-bwd: the input cotangents (dz, dldir, dvdir), f32, of
    :func:`rusink_kernel` for the output cotangent ``dy`` (N, out). In bf16
    on the plans :func:`rusink_on_tensor_cores` takes, that is
    ``rusink_chain_bwd_tc_kernel`` on the tensor cores (over ``wt``, the
    transposed hidden weights K2-fwd's tensor-core kernel read for these
    params, which it then does not pack again); every other call runs the
    CUDA-core ``rusink_chain_bwd_kernel``. Counts its launches in
    ``rusink_kernel_bwd.launches``, those of the tensor-core kernel also in
    ``rusink_kernel_bwd.tc_launches``."""
    tc = rusink_on_tensor_cores(plan, compute_dtype, z.device)
    grads, ran = _rusink_bwd(plan, z, ldir, vdir, dy, params, compute_dtype,
                             tc, wt)
    rusink_kernel_bwd.launches += ran
    rusink_kernel_bwd.tc_launches += int(ran and tc)
    return grads


kernel_lib.launch_counters(rusink_kernel_bwd, 'launches', 'tc_launches')


def rusink_kernel_bwd_cuda_core(plan, z, ldir, vdir, dy, params,
                                compute_dtype=None):
    """The CUDA-core K2-bwd (``rusink_chain_bwd_kernel``) in either
    precision: what :func:`rusink_kernel_bwd` runs off the tensor cores,
    and in bf16 the kernel the tensor-core one is held against. Counts no
    launch."""
    return _rusink_bwd(plan, z, ldir, vdir, dy, params, compute_dtype,
                       False)[0]


class RusinkFunction(torch.autograd.Function):
    """K2-fwd with K2-bwd as its backward (the JAX package's ``_fused``
    custom VJP): input cotangents from the kernel, zero weight cotangents
    (the BRDF prior is frozen). K2-fwd's tensor-core kernel hands the
    transposed weights it packed to the tensor-core K2-bwd (``ctx.wt``),
    so a step packs them once."""

    @staticmethod
    def forward(ctx, plan, compute_dtype, z, ldir, vdir, *flat):
        ctx.save_for_backward(z, ldir, vdir, *flat)
        ctx.plan, ctx.compute_dtype = plan, compute_dtype
        y, ctx.wt = _rusink_kernel(plan, z, ldir, vdir,
                                   list(zip(flat[0::2], flat[1::2])),
                                   compute_dtype)
        return y

    @staticmethod
    def backward(ctx, dy):
        z, ldir, vdir, *flat = ctx.saved_tensors
        grads = rusink_kernel_bwd(ctx.plan, z, ldir, vdir, dy,
                                  list(zip(flat[0::2], flat[1::2])),
                                  ctx.compute_dtype, wt=ctx.wt)
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
