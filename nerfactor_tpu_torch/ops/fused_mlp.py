"""Fused positional-encoding -> skip-MLP -> head chains (counterpart of
nerfactor_tpu/ops/pallas_mlp.py).

Every hot path of NeRFactor is a small MLP (width 128, depth 4) evaluated
over rays x 512 lights. :func:`apply_chain` runs one such chain:

  * on a CUDA tensor it launches kernel K1-fwd (``csrc/fused_mlp.cu``),
    which keeps the embedding and all hidden activations on the chip;
    under autograd the backward is kernel K1-bwd, which recomputes the
    forward and returns the input and/or weight cotangents;
  * on a CPU tensor it runs :func:`chain_reference`, the plain PyTorch
    version of the same math under ordinary autograd (the oracle the
    tests and ``chip_smoke.py`` hold the kernels against).

Semantics mirror the JAX package: the embedding of each part is
``[x, sin(f0 x), cos(f0 x), ...]``; after layer i in ``skip_at`` the
embedding is concatenated onto the activation (the next layer sees
``[h, e]``); weights keep the JAX layout, ``w`` (din, dout) applied as
``x @ w``.
"""

import ctypes
from collections import namedtuple

import torch

from nerfactor_tpu_torch.ops import encoding
from nerfactor_tpu_torch.ops import kernel_lib

# Static description of one fused chain (same fields as the JAX Plan).
#   embed_parts: tuple of (raw_dim, n_freqs); n_freqs=0 -> passthrough.
#   widths: layer output widths (hidden layers + head).
#   acts: activation name per layer ('relu' | 'sigmoid' | 'softplus' | None).
#   skip_at: layer indices i such that AFTER layer i the embedded input is
#            concatenated onto the activation.
Plan = namedtuple('Plan', 'embed_parts widths acts skip_at')


def make_plan(embed_parts, widths, acts, skip_at):
    return Plan(tuple(tuple(p) for p in embed_parts), tuple(widths),
                tuple(acts), tuple(sorted(skip_at or ())))


def plan_from_specs(embed_parts, mlp_spec, out_spec):
    """Plan from a hidden MLPSpec + head MLPSpec pair."""
    widths = tuple(mlp_spec.widths) + tuple(out_spec.widths)
    acts = tuple([mlp_spec.acts] * len(mlp_spec.widths)
                 + [out_spec.acts] * len(out_spec.widths))
    return make_plan(embed_parts, widths, acts, mlp_spec.skip_at or ())


def params_from_tree(params_mlp, params_out):
    """Flattens networks.init_mlp param lists into (w, b) pairs."""
    return [(l['w'], l['b']) for l in list(params_mlp) + list(params_out)]


def embed_dim(plan):
    return sum(encoding.embed_dims(d, f) if f else d
               for d, f in plan.embed_parts)


def raw_dim(plan):
    return sum(d for d, _ in plan.embed_parts)


def layer_in_dims(plan):
    """Fan-in of each layer, accounting for skip concats."""
    e = embed_dim(plan)
    dims, prev = [], e
    for i, w in enumerate(plan.widths):
        dims.append(prev)
        prev = w + (e if i in plan.skip_at else 0)
    return dims


def out_dim(plan):
    last = len(plan.widths) - 1
    return plan.widths[-1] + (embed_dim(plan) if last in plan.skip_at
                              else 0)


# ------ plain PyTorch version ------

def _embed(plan, x):
    parts, col = [], 0
    for d, f in plan.embed_parts:
        parts.append(encoding.posenc(x[:, col:col + d], f))
        col += d
    return torch.cat(parts, dim=1)


def _act(name, pre):
    if name is None or name == 'none':
        return pre
    if name == 'relu':
        return torch.relu(pre)
    if name == 'sigmoid':
        return torch.sigmoid(pre)
    if name == 'softplus':
        return torch.logaddexp(pre, torch.zeros_like(pre))
    raise NotImplementedError(name)


def _dot(a, b):
    """a @ b with f32 accumulation whatever the operand type."""
    return torch.matmul(a.float(), b.float())


def chain_reference(plan, x, params, compute_dtype=None):
    """Plain PyTorch chain, the math of the JAX package's
    ``chain_reference``: ``compute_dtype`` (e.g. bf16) casts the
    embedding, weights and pre-activations; products accumulate in f32;
    the output is f32."""
    e = _embed(plan, x)
    if compute_dtype is not None:
        e = e.to(compute_dtype)
    h = e
    for i, ((w, b), act) in enumerate(zip(params, plan.acts)):
        if compute_dtype is not None:
            w = w.to(compute_dtype)
            b = b.to(compute_dtype)
        if i > 0 and (i - 1) in plan.skip_at:
            hw = h.shape[1]
            pre = _dot(h, w[:hw]) + _dot(e, w[hw:]) + b
        else:
            pre = _dot(h, w) + b
        if compute_dtype is not None:
            pre = pre.to(compute_dtype)
        h = _act(act, pre)
    last = len(plan.widths) - 1
    y = torch.cat([h, e], dim=1) if last in plan.skip_at else h
    return y.float()


# ------ kernels K1-fwd and K1-bwd ------

MAX_LAYERS, MAX_PARTS = 16, 4  # csrc/chain_mlp.cuh kMaxLayers, kMaxParts
ACT_CODES = {None: 0, 'none': 0, 'relu': 1, 'sigmoid': 2, 'softplus': 3}


class ChainDesc(ctypes.Structure):
    """csrc/chain_mlp.cuh ``nfk::ChainDesc``, field for field."""
    _fields_ = [
        ('n_layers', ctypes.c_int),
        ('widths', ctypes.c_int * MAX_LAYERS),
        ('acts', ctypes.c_int * MAX_LAYERS),
        ('skip_after', ctypes.c_int * MAX_LAYERS),
        ('n_parts', ctypes.c_int),
        ('part_dim', ctypes.c_int * MAX_PARTS),
        ('part_freqs', ctypes.c_int * MAX_PARTS),
        ('raw_dim', ctypes.c_int),
        ('embed_dim', ctypes.c_int),
        ('max_width', ctypes.c_int),
        ('w_off', ctypes.c_longlong * MAX_LAYERS),
        ('b_off', ctypes.c_longlong * MAX_LAYERS),
    ]


def kernel_supports(plan):
    """Whether K1-fwd takes this plan: at most 16 layers and 4 embedding
    parts, and no skip after the head (no shipped chain has one)."""
    return (len(plan.widths) <= MAX_LAYERS
            and len(plan.embed_parts) <= MAX_PARTS
            and (len(plan.widths) - 1) not in plan.skip_at)


def make_desc(plan):
    """The kernel's description of ``plan``; weight offsets follow the
    packing of :func:`pack_params`."""
    if not kernel_supports(plan):
        raise NotImplementedError(
            "Chain plan not supported by the CUDA kernel: %s" % (plan,))
    d = ChainDesc()
    n = len(plan.widths)
    d.n_layers = n
    dims = layer_in_dims(plan)
    w_off = b_off = 0
    for i, w in enumerate(plan.widths):
        d.widths[i] = w
        d.acts[i] = ACT_CODES[plan.acts[i]]
        d.skip_after[i] = int(i in plan.skip_at)
        d.w_off[i], d.b_off[i] = w_off, b_off
        w_off += dims[i] * w
        b_off += w
    d.n_parts = len(plan.embed_parts)
    for p, (dim, f) in enumerate(plan.embed_parts):
        d.part_dim[p], d.part_freqs[p] = dim, f
    d.raw_dim = raw_dim(plan)
    d.embed_dim = embed_dim(plan)
    d.max_width = max(plan.widths[:-1] or plan.widths)
    return d


def pack_params(plan, params, dtype):
    """All layers' weights flattened into one ``dtype`` buffer and all
    biases into one f32 buffer, in layer order (JAX row order kept)."""
    dims = layer_in_dims(plan)
    for i, (w, b) in enumerate(params):
        if tuple(w.shape) != (dims[i], plan.widths[i]) \
                or tuple(b.shape) != (plan.widths[i],):
            raise ValueError("Layer %d params %s, %s do not fit the plan"
                             % (i, tuple(w.shape), tuple(b.shape)))
    w_flat = torch.cat([w.reshape(-1) for w, _ in params]).to(dtype)
    b_flat = torch.cat([b.reshape(-1) for _, b in params]).float()
    return w_flat.contiguous(), b_flat.contiguous()


def kernel_dtype(compute_dtype):
    """Operand type of the kernel for a chain's ``compute_dtype``: None
    or float32 -> true f32; bfloat16 -> bf16 operands, f32 accumulation."""
    if compute_dtype is None or compute_dtype == torch.float32:
        return torch.float32
    if compute_dtype == torch.bfloat16:
        return torch.bfloat16
    raise ValueError("Unsupported compute_dtype: %r" % (compute_dtype,))


def run(entry, device, *args, stream=True):
    """Calls the C function ``entry`` of the kernel library with ``args``
    (and ``device``'s current stream last); raises on its error code."""
    with torch.cuda.device(device):  # the launchers use the current device
        if stream:
            args += (torch.cuda.current_stream(device).cuda_stream,)
        code = getattr(kernel_lib.load(), entry)(*args)
    kernel_lib.check(code, entry)


def check_inputs(inputs):
    """Checks ``inputs``, a list of (name, tensor, n_cols) that must be
    CUDA f32 (N, n_cols) with one N; returns the tensors, contiguous."""
    tensors = []
    for name, t, cols in inputs:
        if not t.is_cuda or t.dtype != torch.float32 or t.dim() != 2 \
                or t.shape[1] != cols or t.shape[0] != inputs[0][1].shape[0]:
            raise ValueError("%s must be a CUDA float32 (N, %d) tensor, got "
                             "%s %s %s" % (name, cols, t.device, t.dtype,
                                           tuple(t.shape)))
        tensors.append(t.contiguous())
    return tensors


def prepare(plan, inputs, params, compute_dtype):
    """Checks ``inputs`` (see :func:`check_inputs`) and packs ``params``
    for ``plan``. Returns (contiguous tensors, desc, bf16 flag, packed w,
    packed b)."""
    tensors = check_inputs(inputs)
    desc = make_desc(plan)
    kdt = kernel_dtype(compute_dtype)
    w_flat, b_flat = pack_params(plan, params, kdt)
    if w_flat.device != tensors[0].device:
        raise ValueError("params must lie on %s" % tensors[0].device)
    return tensors, desc, int(kdt == torch.bfloat16), w_flat, b_flat


def _ptr(t):
    return None if t is None else t.data_ptr()


def launch(entry, plan, inputs, params, compute_dtype):
    """Calls the forward launcher ``entry`` for ``plan`` on ``inputs`` (see
    :func:`prepare`); returns the (N, out) f32 output, or None for N == 0,
    where nothing is launched."""
    tensors, desc, bf16, w_flat, b_flat = prepare(plan, inputs, params,
                                                  compute_dtype)
    device, n = tensors[0].device, tensors[0].shape[0]
    if n == 0:
        return None
    y = torch.empty((n, plan.widths[-1]), dtype=torch.float32, device=device)
    run(entry, device, ctypes.addressof(desc), bf16,
        *[t.data_ptr() for t in tensors], w_flat.data_ptr(), b_flat.data_ptr(),
        y.data_ptr(), n)
    return y


def chain_kernel(plan, x, params, compute_dtype=None):
    """Launches K1-fwd on ``x`` (N, raw_dim) CUDA f32; returns (N, out) f32.
    Counts its launches in ``chain_kernel.launches``."""
    y = launch('nfk_chain_fwd', plan, [('x', x, raw_dim(plan))], params,
               compute_dtype)
    if y is None:
        return x.new_empty((0, plan.widths[-1]))
    chain_kernel.launches += 1
    return y


chain_kernel.launches = 0


def unpack_grads(plan, dwb):
    """Splits a packed f32 (all weights | all biases) buffer into the
    per-layer [(dW (din, dout), db (dout,))] of ``plan``."""
    dims = layer_in_dims(plan)
    w_off, b_off = 0, sum(d * w for d, w in zip(dims, plan.widths))
    out = []
    for d, w in zip(dims, plan.widths):
        out.append((dwb[w_off:w_off + d * w].view(d, w), dwb[b_off:b_off + w]))
        w_off += d * w
        b_off += w
    return out


def chain_kernel_bwd(plan, x, dy, params, compute_dtype=None, needs_dx=True,
                     needs_dw=True):
    """Launches K1-bwd: the cotangents of :func:`chain_kernel` for the
    output cotangent ``dy`` (N, out). Returns (dx (N, raw_dim) or None,
    [(dW, db)] or None), f32, as ``needs_dx`` / ``needs_dw`` ask. dW/db
    are bit-identical for the same inputs on the same card. Counts its
    launches in ``chain_kernel_bwd.launches``."""
    if not (needs_dx or needs_dw):
        raise ValueError("K1-bwd launched with nothing to compute")
    (x, dy), desc, bf16, w_flat, b_flat = prepare(
        plan, [('x', x, raw_dim(plan)), ('dy', dy, plan.widths[-1])], params,
        compute_dtype)
    device, n = x.device, x.shape[0]
    dx = torch.empty_like(x) if needs_dx else None
    dwb = part = None
    slices = ctypes.c_int(0)
    if needs_dw:
        dwb = torch.zeros(w_flat.numel() + b_flat.numel(), dtype=torch.float32,
                          device=device)
        if n:
            run('nfk_chain_bwd_slices', device, ctypes.addressof(desc), bf16,
                int(needs_dx), n, ctypes.byref(slices), stream=False)
            part = torch.empty(slices.value * dwb.numel(), dtype=torch.float32,
                               device=device)
    if n:
        run('nfk_chain_bwd', device, ctypes.addressof(desc), bf16,
            int(needs_dx), int(needs_dw), x.data_ptr(), dy.data_ptr(),
            w_flat.data_ptr(), b_flat.data_ptr(), _ptr(dx), _ptr(part),
            _ptr(dwb), slices.value, n)
        chain_kernel_bwd.launches += 1
    return dx, (unpack_grads(plan, dwb) if needs_dw else None)


chain_kernel_bwd.launches = 0


def grads_or_zeros(ctx, first, grads, inputs):
    """Autograd's cotangents for ``inputs`` (the Function's arguments
    from position ``first``): each of ``grads`` where given, zeros where
    the kernel was told not to compute it, None where autograd needs
    none."""
    return tuple(
        None if not ctx.needs_input_grad[first + i]
        else (g if g is not None else torch.zeros_like(t))
        for i, (g, t) in enumerate(zip(grads, inputs)))


class ChainFunction(torch.autograd.Function):
    """K1-fwd with K1-bwd as its backward (the JAX package's
    ``_fused_chain_impl`` custom VJP): ``needs_dx`` / ``needs_dw`` select
    the cotangents K1-bwd computes; the others come back as zeros, and
    with both False no backward kernel is launched."""

    @staticmethod
    def forward(ctx, plan, compute_dtype, needs_dx, needs_dw, x, *flat):
        ctx.save_for_backward(x, *flat)
        ctx.plan, ctx.compute_dtype = plan, compute_dtype
        ctx.needs = (needs_dx, needs_dw)
        return chain_kernel(plan, x, list(zip(flat[0::2], flat[1::2])),
                            compute_dtype)

    @staticmethod
    def backward(ctx, dy):
        x, *flat = ctx.saved_tensors
        needs_dx, needs_dw = ctx.needs
        dx, dparams = None, None
        if needs_dx or needs_dw:
            dx, dparams = chain_kernel_bwd(
                ctx.plan, x, dy, list(zip(flat[0::2], flat[1::2])),
                ctx.compute_dtype, needs_dx=needs_dx, needs_dw=needs_dw)
        dflat = [g for pair in dparams for g in pair] if dparams \
            else [None] * len(flat)
        return (None, None, None, None) + grads_or_zeros(
            ctx, 4, [dx] + dflat, [x] + list(flat))


def needs_autograd(tensors):
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def apply_chain(plan, x, params, force_reference=False, compute_dtype=None,
                needs_dx=True, needs_dw=True):
    """Runs the embed -> MLP -> head chain on ``x`` (N, raw_dim).

    ``params`` is the list of (w, b) over all layers (hidden + head);
    ``compute_dtype`` is None (true f32) or torch.bfloat16 (bf16
    operands, f32 accumulation). ``force_reference`` (the JAX package's
    ``fused_mlp = False``) runs the plain version on any device. Otherwise
    a CPU tensor takes the plain version and a CUDA tensor the kernel.

    ``needs_dx`` / ``needs_dw`` have the JAX meaning for the kernel's
    backward: pass ``needs_dx=False`` when ``x`` is data, and
    ``needs_dw=False`` when the weights are frozen; K1-bwd then skips that
    branch and returns zeros for it. The plain version ignores them.
    """
    params = [(w, b) for w, b in params]
    if force_reference or x.device.type == 'cpu':
        return chain_reference(plan, x, params, compute_dtype=compute_dtype)
    flat = [t for pair in params for t in pair]
    if needs_autograd([x] + flat):
        return ChainFunction.apply(plan, compute_dtype, needs_dx, needs_dw, x,
                                   *flat)
    return chain_kernel(plan, x, params, compute_dtype=compute_dtype)
