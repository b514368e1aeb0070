"""Fused positional-encoding -> skip-MLP -> head chains (counterpart of
nerfactor_tpu/ops/pallas_mlp.py).

Every hot path of NeRFactor is a small MLP (width 128, depth 4) evaluated
over rays x 512 lights. :func:`apply_chain` runs one such chain:

  * on a CUDA tensor it launches kernel K1-fwd (``csrc/fused_mlp.cu``),
    which keeps the embedding and all hidden activations on the chip (on
    the tensor cores where :func:`fwd_on_tensor_cores` says so: bf16, or
    f32 as split TF32 on K1's route where no CUDA-core backward
    recomputes it); under autograd the backward is
    kernel K1-bwd, which recomputes the forward and returns the input
    and/or weight cotangents (f32 with dx alone or dW alone on the tensor
    cores, split TF32, where :func:`bwd_on_tensor_cores` says so); the
    tensor-core kernels read the hidden weights transposed, which
    :func:`transposed_weights` packs on the card in one launch;
  * on a CPU tensor it runs :func:`chain_reference`, the plain PyTorch
    version of the same math under ordinary autograd (the oracle the
    tests and ``chip_smoke.py`` hold the kernels against).

The kernel has the JAX package's two routes, chosen by ``transposed`` of
:func:`_fused_chain` (None reads :data:`TRANSPOSED_BOUNDARY`). On the TPU
the names are about the layout of the kernel's operands in HBM; on the
card both routes read row-major (N, raw) rows and write row-major output:

  * ``transposed=True`` (the default): K1-fwd / K1-bwd, whose backward
    recomputes sin/cos;
  * ``transposed=False``: the stash route, K1r-fwd / K1r-bwd. Its
    embedding forms cos t as sin(t + pi/2) with the phase added in f32
    (:func:`trig_stash`, the TPU kernel's sin(x @ A + P)); under autograd
    K1r-fwd writes those trig columns, at the kernel's operand type, to a
    (N, trig_dim) stash in the column order of :func:`trig_perm`, and
    K1r-bwd reads them instead of recomputing sin/cos. K1r-bwd always
    computes dW/db, as the TPU route does. The same rules as K1's send
    K1r to the tensor cores (K1's tile with the stash route's embedding)
    or keep it on the CUDA cores. Its plain version is
    :func:`chain_reference_stash`; at 2^9 x the pi/2 add rounds, so it
    parts from :func:`chain_reference` by up to ~3e-5 in f32.

A plan with a skip after its last layer (output ``[head | embedding]``)
takes K1w-fwd / K1w-bwd on either route, as the JAX package sends such
plans to its ``_pallas_forward`` / ``_pallas_backward``. The same rules
as K1's send K1w to the tensor cores (K1's tile, the embedding then
written out; K1-bwd's phase 1 and dW pass and, for dx, a dx pass over
phase 1's scratch) or keep it on the CUDA cores. Unlike that TPU route,
which reads the global ``networks.MATMUL_DTYPE`` and so ignores a
per-call bf16 ``compute_dtype``, K1w takes ``compute_dtype`` as every
other route does (the semantics of :func:`chain_reference`).

Semantics mirror the JAX package: the embedding of each part is
``[x, sin(f0 x), cos(f0 x), ...]``; after layer i in ``skip_at`` the
embedding is concatenated onto the activation (the next layer sees
``[h, e]``); weights keep the JAX layout, ``w`` (din, dout) applied as
``x @ w``.
"""

import ctypes
import functools
import math
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


def last_skip(plan):
    """Whether the plan skips after its last layer: its output is then
    ``[head | embedding]``."""
    return (len(plan.widths) - 1) in plan.skip_at


def out_dim(plan):
    return plan.widths[-1] + (embed_dim(plan) if last_skip(plan) else 0)


# Selects the kernel route of _fused_chain when its ``transposed`` is None
# (see the module docstring): True runs K1, False the stash route K1r.
TRANSPOSED_BOUNDARY = True


def trig_dim(plan):
    """Width of a stash row: every part's sin and cos columns."""
    return sum(2 * d * f for d, f in plan.embed_parts)


def trig_perm(plan):
    """Columns of the reference embedding regrouped as [all trig columns
    (per part: the sines octave-major, then the cosines), then all raw-x
    columns]. The stash's columns are the first trig_dim(plan) of them."""
    xs, trigs = [], []
    base = 0
    for d, f in plan.embed_parts:
        xs.extend(range(base, base + d))
        for trig in range(2):
            for j in range(f):
                start = base + d + j * 2 * d + trig * d
                trigs.extend(range(start, start + d))
        base += d + 2 * d * f
    return trigs + xs


# float32(pi / 2), the phase of a cos column
HALF_PI = float(torch.tensor(math.pi / 2, dtype=torch.float32))


def _trig_mats(plan):
    """Per stash column: its raw input column, octave frequency 2^j and
    phase (0 for a sine, float32(pi/2) for a cosine). These are the one
    nonzero of each column of the TPU kernel's constant A and its phase
    row P (the JAX package's ``_trig_mats``)."""
    cols, freqs, phases = [], [], []
    row0 = 0
    for d, f in plan.embed_parts:
        for trig in range(2):
            for j in range(f):
                for k in range(d):
                    cols.append(row0 + k)
                    freqs.append(2.0 ** j)
                    phases.append(HALF_PI if trig else 0.0)
        row0 += d
    return cols, freqs, phases


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


def trig_stash(plan, x):
    """Plain version of the stash route's trig columns: sin(2^j x +
    phase), phase 0 or pi/2, in f32; (N, trig_dim) in the stash's column
    order. 2^j x is exact and the phase add rounds in f32, as the TPU
    kernel's sin(x @ A + P): at 2^9 x a cos column parts from cos() by up
    to ~3e-5."""
    cols, freqs, phases = _trig_mats(plan)
    freqs = torch.tensor(freqs, dtype=torch.float32, device=x.device)
    phases = torch.tensor(phases, dtype=torch.float32, device=x.device)
    return torch.sin(x[:, cols] * freqs + phases)


def _embed_from_stash(plan, x, stash):
    """The embedding in the reference order, its trig columns from
    ``stash`` (the stash route's form)."""
    inv = sorted(range(embed_dim(plan)), key=trig_perm(plan).__getitem__)
    return torch.cat([stash, x], dim=1)[:, inv]


def chain_reference(plan, x, params, compute_dtype=None):
    """Plain PyTorch chain, the math of the JAX package's
    ``chain_reference``: ``compute_dtype`` (e.g. bf16) casts the
    embedding, weights and pre-activations; products accumulate in f32;
    the output is f32."""
    return _chain_on(plan, _embed(plan, x), params, compute_dtype)


def chain_reference_stash(plan, x, params, compute_dtype=None):
    """Plain version of the stash route (K1r): :func:`chain_reference`
    on the embedding whose trig columns are :func:`trig_stash`'s."""
    e = _embed_from_stash(plan, x, trig_stash(plan, x))
    return _chain_on(plan, e, params, compute_dtype)


def _chain_on(plan, e, params, compute_dtype):
    """The layers of :func:`chain_reference` over the embedding ``e``."""
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
    y = torch.cat([h, e], dim=1) if last_skip(plan) else h
    return y.float()


# ------ the chain kernels: K1, the stash route K1r, last-skip K1w ------

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
    """Whether the chain kernels take this plan: at most 16 layers and 4
    embedding parts (a skip after the last layer runs as K1w)."""
    return (len(plan.widths) <= MAX_LAYERS
            and len(plan.embed_parts) <= MAX_PARTS)


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
        code = kernel_lib.entry(entry)(*args)
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
    y = torch.empty((n, out_dim(plan)), dtype=torch.float32, device=device)
    run(entry, device, ctypes.addressof(desc), bf16,
        *[t.data_ptr() for t in tensors], w_flat.data_ptr(), b_flat.data_ptr(),
        y.data_ptr(), n)
    return y


def _check_route(plan, kernel, for_last_skip):
    """Raises unless ``kernel`` is the one for ``plan``'s kind: K1w for a
    plan with a skip after its last layer, K1 or K1r otherwise."""
    if last_skip(plan) != for_last_skip:
        raise ValueError("%s takes plans %s a skip after the last layer, got "
                         "%s" % (kernel, 'with' if for_last_skip else
                                 'without', plan))


def _chain_fwd(plan, x, params, compute_dtype, tc, stash_route=False,
               with_stash=False):
    """Launches K1-fwd, K1r-fwd with ``stash_route`` or, for a last-skip
    plan, K1w-fwd on ``x`` (N, raw_dim) CUDA f32: with ``tc`` the
    tensor-core kernel (bf16: ``nfk_chain_fwd_tc``,
    ``nfk_chain_stash_fwd_tc``, ``nfk_chain_last_skip_fwd_tc``; f32, which
    the rule gives K1's route alone: :func:`_chain_fwd_f32_tc`) over the
    weights padded to :func:`mma_plan`'s widths where they differ, else
    the CUDA-core ``nfk_chain_fwd``. Returns the (N, out_dim) f32 output,
    the (N, trig_dim) stash at the operand type (``with_stash`` on the
    stash route, else None), the transposed hidden weights the tensor-core
    kernel read (else None) and whether a kernel ran (not for N == 0)."""
    if tc and kernel_dtype(compute_dtype) == torch.float32:
        y, wt, ran = _chain_fwd_f32_tc(plan, x, params)
        return y, None, wt, ran
    kplan = mma_plan(plan) if tc else plan
    if kplan != plan:
        params = pad_params(plan, params)
    (x,), desc, bf16, w_flat, b_flat = prepare(
        kplan, [('x', x, raw_dim(plan))], params, compute_dtype)
    n = x.shape[0]
    y = torch.empty((n, out_dim(plan)), dtype=torch.float32, device=x.device)
    stash = None
    if stash_route and with_stash and trig_dim(plan):
        stash = torch.empty((n, trig_dim(plan)),
                            dtype=kernel_dtype(compute_dtype), device=x.device)
    wt = transposed_weights(kplan, w_flat, desc) if tc else None
    if n and tc:
        args = (x.data_ptr(), w_flat.data_ptr(), wt.data_ptr(),
                b_flat.data_ptr(), y.data_ptr())
        if stash_route:
            run('nfk_chain_stash_fwd_tc', x.device, ctypes.addressof(desc),
                *args, _ptr(stash), n)
        else:
            entry = 'nfk_chain_last_skip_fwd_tc' if last_skip(plan) \
                else 'nfk_chain_fwd_tc'
            run(entry, x.device, ctypes.addressof(desc), *args, n)
    elif n:
        run('nfk_chain_fwd', x.device, ctypes.addressof(desc), bf16,
            int(stash_route), x.data_ptr(), w_flat.data_ptr(),
            b_flat.data_ptr(), y.data_ptr(), _ptr(stash), n)
    return y, stash, wt, n > 0


def _chain_fwd_f32_tc(plan, x, params, terms=3):
    """Launches ``nfk_chain_fwd_tc_f32``, f32 K1-fwd on the tensor cores
    (``terms`` TF32 products: 3, or the control's 1), over the weights
    padded to :func:`mma_plan`'s widths where they differ. Returns (the
    (N, out_dim) f32 output, the f32 transposed hidden weights it read,
    whether a kernel ran)."""
    kplan = mma_plan(plan)
    if kplan != plan:
        params = pad_params(plan, params)
    (x,), desc, _, w_flat, b_flat = prepare(
        kplan, [('x', x, raw_dim(plan))], params, None)
    n = x.shape[0]
    y = torch.empty((n, out_dim(plan)), dtype=torch.float32, device=x.device)
    wt = transposed_weights(kplan, w_flat, desc)
    if n:
        run('nfk_chain_fwd_tc_f32', x.device, ctypes.addressof(desc),
            x.data_ptr(), w_flat.data_ptr(), wt.data_ptr(), b_flat.data_ptr(),
            y.data_ptr(), terms, n)
    return y, wt, n > 0


def _chain_kernel(plan, x, params, compute_dtype, backward=None):
    """K1-fwd: the tensor-core kernel where :func:`fwd_on_tensor_cores`
    says so (``backward`` as it takes it), else the CUDA-core one. Returns
    (y, the transposed hidden weights the tensor-core kernel read, else
    None); counts the launch as :func:`chain_kernel` says."""
    _check_route(plan, 'K1-fwd', False)
    check_inputs([('x', x, raw_dim(plan))])  # before the rule asks the card
    tc = fwd_on_tensor_cores(plan, compute_dtype, x.device, backward=backward,
                             rows=x.shape[0])
    y, _, wt, ran = _chain_fwd(plan, x, params, compute_dtype, tc)
    f32 = kernel_dtype(compute_dtype) == torch.float32
    chain_kernel.launches += ran
    chain_kernel.tc_launches += int(ran and tc and not f32)
    chain_kernel.f32_tc_launches += int(ran and tc and f32)
    return y, wt


def chain_kernel(plan, x, params, compute_dtype=None):
    """Launches K1-fwd on ``x`` (N, raw_dim) CUDA f32; returns (N, out) f32.
    On the plans :func:`fwd_on_tensor_cores` takes, that is
    ``chain_fwd_tc_kernel`` on the tensor cores in bf16 and
    ``chain_fwd_f32_tc_kernel`` (split TF32) in f32; every other call runs
    the CUDA-core ``chain_fwd_kernel``. Counts its launches in
    ``chain_kernel.launches``, those of the bf16 tensor-core kernel also in
    ``chain_kernel.tc_launches``, those of the f32 one in
    ``chain_kernel.f32_tc_launches``."""
    return _chain_kernel(plan, x, params, compute_dtype)[0]


kernel_lib.launch_counters(chain_kernel, 'launches', 'tc_launches',
                           'f32_tc_launches')


def chain_kernel_cuda_core(plan, x, params, compute_dtype=None):
    """The CUDA-core K1-fwd (``chain_fwd_kernel``) on any plan without a
    last skip, in either precision: what :func:`chain_kernel` runs off the
    tensor cores, and the kernel the tensor-core ones are held against.
    Counts no launch."""
    _check_route(plan, 'K1-fwd', False)
    return _chain_fwd(plan, x, params, compute_dtype, False)[0]


def chain_kernel_f32_tc(plan, x, params, terms=3):
    """The f32 tensor-core K1-fwd (``chain_fwd_f32_tc_kernel``) with
    ``terms`` TF32 products: 3, what :func:`chain_kernel` runs in f32 on
    the plans :func:`fwd_on_tensor_cores` takes; 1, plain TF32, the control
    that f32's limits must catch. Raises on a plan the kernel does not
    take. Counts no launch."""
    _check_route(plan, 'K1-fwd', False)
    if not _f32_tc_runs(plan, x.device, dx=False):
        raise ValueError("the f32 tensor-core K1-fwd does not take %s"
                         % (plan,))
    return _chain_fwd_f32_tc(plan, x, params, terms)[0]


def _chain_kernel_stash(plan, x, params, compute_dtype, with_stash):
    """K1r-fwd as :func:`chain_kernel_stash` launches it; returns (y, the
    stash or None, the transposed hidden weights the tensor-core kernel
    read, else None)."""
    _check_route(plan, 'K1r-fwd', False)
    tc = fwd_on_tensor_cores(plan, compute_dtype, x.device, stash_route=True)
    y, stash, wt, ran = _chain_fwd(plan, x, params, compute_dtype, tc,
                                   stash_route=True, with_stash=with_stash)
    chain_kernel_stash.launches += ran
    chain_kernel_stash.tc_launches += int(ran and tc)
    return y, stash, wt


def chain_kernel_stash(plan, x, params, compute_dtype=None, with_stash=False):
    """Launches K1r-fwd, the stash route's forward, on ``x`` (N, raw_dim)
    CUDA f32. Returns ((N, out) f32, the (N, trig_dim) stash at the
    kernel's operand type with ``with_stash``, else None). In bf16 on the
    plans :func:`fwd_on_tensor_cores` takes, that is
    ``chain_stash_fwd_tc_kernel`` on the tensor cores; every other call
    runs the CUDA-core ``chain_fwd_kernel``. The two write the same stash,
    bit for bit. Counts its launches in ``chain_kernel_stash.launches``,
    those of the tensor-core kernel also in
    ``chain_kernel_stash.tc_launches``."""
    return _chain_kernel_stash(plan, x, params, compute_dtype, with_stash)[:2]


kernel_lib.launch_counters(chain_kernel_stash, 'launches', 'tc_launches')


def chain_kernel_stash_cuda_core(plan, x, params, compute_dtype=None,
                                 with_stash=False):
    """The CUDA-core K1r-fwd (``chain_fwd_kernel``'s stash route) in either
    precision: what :func:`chain_kernel_stash` runs off the tensor cores,
    and in bf16 the kernel the tensor-core one is held against. Returns
    (y, stash or None); counts no launch."""
    _check_route(plan, 'K1r-fwd', False)
    return _chain_fwd(plan, x, params, compute_dtype, False, stash_route=True,
                      with_stash=with_stash)[:2]


def _chain_kernel_last_skip(plan, x, params, compute_dtype):
    """K1w-fwd as :func:`chain_kernel_last_skip` launches it; returns (y,
    the transposed hidden weights the tensor-core kernel read, else
    None)."""
    _check_route(plan, 'K1w-fwd', True)
    tc = fwd_on_tensor_cores(plan, compute_dtype, x.device)
    y, _, wt, ran = _chain_fwd(plan, x, params, compute_dtype, tc)
    chain_kernel_last_skip.launches += ran
    chain_kernel_last_skip.tc_launches += int(ran and tc)
    return y, wt


def chain_kernel_last_skip(plan, x, params, compute_dtype=None):
    """Launches K1w-fwd on ``x`` (N, raw_dim) CUDA f32 for a plan with a
    skip after its last layer; returns (N, widths[-1] + embed_dim) f32,
    ``[head | embedding]``, the embedding's columns at the operand type's
    values. In bf16 on the plans :func:`fwd_on_tensor_cores` takes, that
    is ``chain_last_skip_fwd_tc_kernel`` on the tensor cores; every other
    call runs the CUDA-core ``chain_fwd_kernel``. Counts its launches in
    ``chain_kernel_last_skip.launches``, those of the tensor-core kernel
    also in ``chain_kernel_last_skip.tc_launches``."""
    return _chain_kernel_last_skip(plan, x, params, compute_dtype)[0]


kernel_lib.launch_counters(chain_kernel_last_skip, 'launches',
                           'tc_launches')


def chain_kernel_last_skip_cuda_core(plan, x, params, compute_dtype=None):
    """The CUDA-core K1w-fwd (``chain_fwd_kernel``'s last-skip mode) in
    either precision: what :func:`chain_kernel_last_skip` runs off the
    tensor cores, and in bf16 the kernel the tensor-core one is held
    against. Counts no launch."""
    _check_route(plan, 'K1w-fwd', True)
    return _chain_fwd(plan, x, params, compute_dtype, False)[0]


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


# ------ the bf16 backwards' scratch and dW pass (K1-bwd and K3-bwd) ------

TILE_ROWS = 64  # csrc tc::kTcRows: rows of a phase-1 tile and a scratch tile
MAX_DENSE = MAX_LAYERS + 2  # csrc kMaxDense
MAX_DW_CHUNKS = 8  # csrc kMaxDwChunks: row chunks of the dW pass


def round16(k):
    return -(-k // 16) * 16


class DenseLayer(ctypes.Structure):
    """csrc/mma_bf16.cuh ``DenseLayer``: a dense layer's input columns
    [seg1, seg1 + k1) and [seg2, seg2 + k2) of a scratch row, its d_pre
    columns from ``dpre``, its width ``n`` and its dW's offset in the
    packed dW."""
    _fields_ = [('seg1', ctypes.c_int), ('k1', ctypes.c_int),
                ('seg2', ctypes.c_int), ('k2', ctypes.c_int),
                ('dpre', ctypes.c_int), ('n', ctypes.c_int),
                ('w_off', ctypes.c_longlong)]


class DwTable(ctypes.Structure):
    """csrc/mma_bf16.cuh ``DwTable``: the dense layers of a scratch of
    ``total`` bf16 columns (row pairs of ``total`` 32-bit words) and
    ``n_dense``, the floats of their packed dW."""
    _fields_ = [('n_layers', ctypes.c_int), ('total', ctypes.c_int),
                ('n_dense', ctypes.c_longlong),
                ('layers', DenseLayer * MAX_DENSE)]

    def dense(self):
        return self.layers[:self.n_layers]


def dw_table(entry, desc, device):
    """The dense layers of a bf16 backward's scratch as the library lays
    them out (``entry``: ``nfk_chain_dw_table`` or ``nfk_nerf_dw_table``
    for ``desc``): (:class:`DwTable`, the dW pass's tile)."""
    tab, tile = DwTable(), ctypes.c_int(0)
    run(entry, device, ctypes.addressof(desc), ctypes.byref(tab),
        ctypes.byref(tile), stream=False)
    return tab, tile.value


@functools.lru_cache(maxsize=None)
def chain_dw_table(plan, device):
    """The hidden layers of the tensor-core K1-bwd's scratch as the
    library lays them out (``nfk_chain_dw_table``): the embedding
    zero-padded to 16 columns, the posts that feed a later hidden layer,
    every hidden layer's rounded d_pre. Returns (:class:`DwTable`, the dW
    pass's tile). Kept per plan and device: the library's answer depends
    on nothing else, and the kernels' wrappers ask it at every launch."""
    return dw_table('nfk_chain_dw_table', make_desc(plan), device)


def pack_transposed(ws, tab, dtype=torch.bfloat16):
    """The dense layers' weights ``ws`` (each (k1 + k2, n)) transposed for
    the tensor-core kernels' forward products, at ``dtype`` (bf16, or f32
    for K1's f32 kernels): per layer of ``tab`` W^T, (n, round16(k1) +
    round16(k2)), each K segment zero-padded to a multiple of 16, one after
    another. Each segment is copied (and rounded to ``dtype``) straight
    into the one buffer. The plain version of ``nfk_pack_transposed``
    (:func:`pack_transposed_kernel`), which the chain wrappers launch on
    CUDA tensors, and what they run on the CPU; of
    ``nfk_pack_transposed_table`` too, which the field's K3 wrappers
    (``fused_nerf.transposed_weights``) launch."""
    widths = [round16(l.k1) + round16(l.k2) for l in tab.dense()]
    out = ws[0].new_zeros(sum(l.n * k for l, k in zip(tab.dense(), widths)),
                          dtype=dtype)
    off = 0
    for w, l, k in zip(ws, tab.dense(), widths):
        t = out[off:off + l.n * k].view(l.n, k)
        t[:, :l.k1] = w[:l.k1].t()
        if l.k2:
            t[:, round16(l.k1):round16(l.k1) + l.k2] = w[l.k1:].t()
        off += l.n * k
    return out


def scratch_values(tab, n):
    """bf16 values of a scratch of ``n`` rows (whole 64-row tiles)."""
    return -(-n // TILE_ROWS) * TILE_ROWS * tab.total


def dw_pass(tab, tile, scratch, n):
    """Launches the dW pass alone (``nfk_dw_pass``) over a bf16 scratch of
    ``n`` rows laid out as ``tab`` says, and sums its chunks: the dense
    dW, f32, packed as the dense weights. For tests of the pass; it counts
    no launch."""
    if scratch.dtype != torch.bfloat16 or not scratch.is_contiguous() \
            or scratch.numel() != scratch_values(tab, n):
        raise ValueError("the scratch must hold %d contiguous bf16 values, "
                         "got %s %s" % (scratch_values(tab, n), scratch.dtype,
                                        tuple(scratch.shape)))
    dw = torch.zeros(tab.n_dense, dtype=torch.float32, device=scratch.device)
    part = torch.empty(MAX_DW_CHUNKS * tab.n_dense, dtype=torch.float32,
                       device=scratch.device)
    if n:
        run('nfk_dw_pass', scratch.device, ctypes.addressof(tab), tile,
            scratch.data_ptr(), part.data_ptr(), dw.data_ptr(), n)
    return dw


def dw_reference(tab, scratch, n, dtype=torch.float64):
    """Plain version of the dW pass: every dense layer's X^T D from the
    scratch of ``n`` rows laid out as ``tab`` says, in ``dtype``, packed as
    the dense weights. The sums run over whole 64-row tiles (phase 1 writes
    a zero d_pre for rows past n)."""
    tiles = -(-n // TILE_ROWS)
    s = scratch.to(dtype).view(tiles, TILE_ROWS // 2, tab.total, 2) \
        .transpose(2, 3).reshape(tiles * TILE_ROWS, tab.total)
    out = []
    for l in tab.dense():
        x = torch.cat([s[:, l.seg1:l.seg1 + l.k1], s[:, l.seg2:l.seg2 + l.k2]],
                      dim=1)
        out.append((x.t() @ s[:, l.dpre:l.dpre + l.n]).reshape(-1))
    return torch.cat(out)


# ------ bf16 K1-fwd and K1-bwd with dW only, on the tensor cores ------

@functools.lru_cache(maxsize=None)
def _tc_runs(plan, device, bwd):
    """Whether the library's tensor-core forward (``bwd`` False) or
    backward runs ``plan`` as :func:`mma_plan`'s (``nfk_chain_tc_runs``):
    a head of at most 8 columns after at least one hidden layer, with no
    skip into it, and blocks that fit the card's shared memory. Kept per
    plan and device, as :func:`chain_dw_table`."""
    desc, runs = make_desc(mma_plan(plan)), ctypes.c_int(0)
    run('nfk_chain_tc_runs', device, ctypes.addressof(desc), int(bwd),
        ctypes.byref(runs), stream=False)
    return runs.value != 0


@functools.lru_cache(maxsize=None)
def _f32_tc_runs(plan, device, dx, dw=False):
    """Whether the library's f32 tensor-core K1-fwd (``dx`` and ``dw``
    False), K1-bwd with dx only (``dx``) or K1-bwd with dW only (``dw``)
    runs ``plan`` as :func:`mma_plan`'s (``nfk_chain_f32_tc_runs``): no
    skip after the head, a head of at most 8 columns after at least one
    hidden layer, with no skip into it, f32 blocks that fit the card's
    shared memory and, for the backwards, every hidden act ReLU. Kept per
    plan and device, as :func:`_tc_runs`."""
    desc, runs = make_desc(mma_plan(plan)), ctypes.c_int(0)
    run('nfk_chain_f32_tc_runs', device, ctypes.addressof(desc),
        2 if dw else int(dx), ctypes.byref(runs), stream=False)
    return runs.value != 0


# Rows from which an f32 K1-fwd with no backward to follow runs split TF32
# on the tensor cores. On an H100 (chip_smoke.py f32_fwd_by_rows, the
# transposed weights packed on the card) a launch on a 128 x 4 head is
# host-bound up to ~8,192 rows either way: split TF32 0.158-0.165 ms
# against the CUDA cores' 0.142-0.161, though its device time is 0.048
# ms against 0.126-0.133; from 16,384 rows it is faster (0.156 against
# 0.169), from 32,768 clearly (0.198 against 0.331). On NeRF's 256 x 8
# sigma chain split TF32 is faster at every size
F32_TC_MIN_ROWS = 16384

# Rows up to which f32 K1-bwd with dW runs split TF32 on the tensor cores.
# Split TF32 rounds each pre-activation otherwise than f32 does, so the
# more rows, the likelier a ReLU whose pre-activation lies within rounding
# of 0 gates the other way, and one such gate moves its layer's dW/db, and
# every layer's below, by that unit's whole contribution. On an H100
# (chip_smoke.py f32_dw_by_rows, the lvis chain's weights) the design
# reads within 1e-6 of float64 up to 8,192 rows; from 16,384 rows one
# gate of 8.4 million flips and the first two layers' dW/db read up to
# 5e-4 from float64 (the plain f32 version 5e-7), past DW_TOL_F32, though
# within 7e-7 under the design's own gates. Past this limit the backward,
# and so its forward, stay on the CUDA cores, which need no scratch either
# (phase 1's f32 scratch of every hidden layer's input and d_pre takes
# ~3.8 KB a row at 128 x 4: 7.9 MB at a training step's 2,048 rows)
F32_DW_TC_MAX_ROWS = 8192


def fwd_on_tensor_cores(plan, compute_dtype, device, stash_route=False,
                        backward=None, rows=None):
    """Whether a K1-fwd, K1r-fwd (``stash_route``) or K1w-fwd launch on
    ``device`` runs a tensor-core kernel: in bf16, a plan the library says
    it runs (:func:`_tc_runs`; ``nfk_chain_fwd_tc``,
    ``nfk_chain_stash_fwd_tc``, ``nfk_chain_last_skip_fwd_tc``); in f32,
    K1's route (not the stash route, no skip after the head) and a plan
    the f32 kernel runs (:func:`_f32_tc_runs`; ``nfk_chain_fwd_tc_f32``);
    then a forward that autograd will differentiate (``backward``, the
    (needs_dx, needs_dw) of its backward) takes it with a backward that
    :func:`bwd_on_tensor_cores` sends to the tensor cores too (dx alone,
    or dW alone up to :data:`F32_DW_TC_MAX_ROWS` ``rows``; every hidden act
    ReLU), whatever its size: such a backward recomputes the forward with
    the forward's own tile code, so both gate each ReLU alike, where a
    CUDA-core backward recomputes it on the CUDA cores, and the forward
    then stays there too. A forward alone (``backward`` None or neither)
    takes it from :data:`F32_TC_MIN_ROWS` ``rows`` (None: the plan alone).
    Every other launch (f32 K1r and K1w, f32 with dx and dW, a small f32
    forward alone, any other plan) runs the CUDA-core
    ``chain_fwd_kernel``."""
    if kernel_dtype(compute_dtype) == torch.float32:
        if backward is not None and any(backward):
            if not bwd_on_tensor_cores(plan, compute_dtype, *backward,
                                       device, rows=rows):
                return False
        elif rows is not None and rows < F32_TC_MIN_ROWS:
            return False
        return not stash_route and not last_skip(plan) \
            and _f32_tc_runs(plan, device, dx=False)
    return _tc_runs(plan, device, bwd=False)


def bwd_on_tensor_cores(plan, compute_dtype, needs_dx, needs_dw, device,
                        stash_route=False, rows=None):
    """Whether a K1-bwd, K1r-bwd (``stash_route``) or K1w-bwd launch on
    ``device`` runs a tensor-core design. In bf16 (phase 1 and the dW
    pass, ``nfk_chain_bwd_tc``, ``nfk_chain_stash_bwd_tc``; for a
    last-skip plan phase 1, the dW pass and the dx pass,
    ``nfk_chain_last_skip_bwd_tc``): a plan that the library says phase 1
    runs (:func:`_tc_runs`), and dW without dx or, for a last-skip plan,
    dx or dW or both. In f32, split TF32, on K1's route (not the stash
    route, no skip after the head) and a plan the f32 kernels run
    (:func:`_f32_tc_runs`: every hidden act ReLU): dx without dW
    (``nfk_chain_bwd_dx_tc_f32``, one kernel), or dW without dx over at
    most :data:`F32_DW_TC_MAX_ROWS` ``rows`` (None: the plan alone;
    ``nfk_chain_bwd_dw_tc_f32``: phase 1 and the dW pass). Every other
    launch (f32 with dx and dW, f32 dW past that size, f32 K1r and K1w,
    bf16 dx on K1 or K1r, any other plan) runs the CUDA-core
    ``chain_bwd_kernel``."""
    if kernel_dtype(compute_dtype) == torch.float32:
        if needs_dx == needs_dw or stash_route or last_skip(plan):
            return False
        if needs_dw and rows is not None and rows > F32_DW_TC_MAX_ROWS:
            return False
        return _f32_tc_runs(plan, device, dx=needs_dx, dw=needs_dw)
    if not (needs_dx or needs_dw) or (needs_dx and not last_skip(plan)):
        return False
    return _tc_runs(plan, device, bwd=True)


def mma_plan(plan):
    """The plan the tensor-core K1-bwd runs ``plan`` as: its products step
    K by 16 (mma.sync m16n8k16), so the hidden widths are rounded up to
    multiples of 16 (the head keeps its width)."""
    return plan._replace(widths=tuple(round16(w) for w in plan.widths[:-1])
                         + plan.widths[-1:])


def _hidden_rows(plan, i):
    """Rows of layer i's W that read the previous hidden layer (the
    embedding's for layer 0)."""
    return plan.widths[i - 1] if i else embed_dim(plan)


def pad_params(plan, params):
    """``params`` zero-padded to :func:`mma_plan`'s widths: a padded unit
    has zero weights in and out, so it changes no output and no dW/db of a
    real unit (:func:`unpad_grads` drops its own)."""
    kplan, out = mma_plan(plan), []
    for i, (w, b) in enumerate(params):
        k, k16 = _hidden_rows(plan, i), _hidden_rows(kplan, i)
        n, n16 = plan.widths[i], kplan.widths[i]
        pw = w.new_zeros(k16 + w.shape[0] - k, n16)
        pw[:k, :n] = w[:k]
        pw[k16:, :n] = w[k:]
        pb = b.new_zeros(n16)
        pb[:n] = b
        out.append((pw, pb))
    return out


def unpad_grads(plan, grads):
    """The real units' [(dW, db)] out of :func:`mma_plan`'s."""
    kplan = mma_plan(plan)
    return [(torch.cat([dw[:k, :n], dw[k16:, :n]]), db[:n])
            for (dw, db), k, k16, n in zip(
                grads, [_hidden_rows(plan, i) for i in range(len(grads))],
                [_hidden_rows(kplan, i) for i in range(len(grads))],
                plan.widths)]


def hidden_weights(kplan, w_flat):
    """The hidden layers' W, each (din, dout), as views of the packed
    weights ``w_flat`` of ``kplan`` (:func:`pack_params`' layout)."""
    out, off = [], 0
    for din, dout in list(zip(layer_in_dims(kplan), kplan.widths))[:-1]:
        out.append(w_flat[off:off + din * dout].view(din, dout))
        off += din * dout
    return out


@functools.lru_cache(maxsize=None)
def _wt_numel(kplan, device):
    """Values of :func:`pack_transposed`'s buffer for ``kplan``."""
    tab, _ = chain_dw_table(kplan, device)
    return sum(l.n * (round16(l.k1) + round16(l.k2)) for l in tab.dense())


def pack_transposed_kernel(kplan, w_flat, desc=None):
    """Launches ``nfk_pack_transposed`` (``csrc/pack_transposed.cu``): the
    hidden layers' W^T of the packed weights ``w_flat`` (bf16 or f32) of
    ``kplan`` (an :func:`mma_plan`; ``desc`` its :func:`make_desc` where
    the caller has it) in one launch, the bits :func:`pack_transposed`
    gives. Counts its launches in ``pack_transposed_kernel.launches``."""
    wt = torch.empty(_wt_numel(kplan, w_flat.device), dtype=w_flat.dtype,
                     device=w_flat.device)
    if desc is None:
        desc = make_desc(kplan)
    run('nfk_pack_transposed', w_flat.device, ctypes.addressof(desc),
        int(w_flat.dtype == torch.bfloat16), w_flat.data_ptr(), wt.data_ptr())
    pack_transposed_kernel.launches += 1
    return wt


kernel_lib.launch_counters(pack_transposed_kernel, 'launches')


def transposed_weights(kplan, w_flat, desc=None):
    """The hidden layers' weights transposed for the tensor-core kernels of
    ``kplan`` (an :func:`mma_plan`; ``desc`` as
    :func:`pack_transposed_kernel` takes it), at the type of its packed
    weights ``w_flat``: on a CUDA tensor one launch of the packing kernel
    (:func:`pack_transposed_kernel`), on a CPU tensor its plain version
    :func:`pack_transposed`, the same bits."""
    if w_flat.is_cuda:
        return pack_transposed_kernel(kplan, w_flat, desc)
    tab, _ = chain_dw_table(kplan, w_flat.device)
    return pack_transposed(hidden_weights(kplan, w_flat), tab, w_flat.dtype)


def tc_bwd_sizes(plan, n, device):
    """What one tensor-core K1-bwd launch over ``n`` rows needs, as the
    library sizes it (``nfk_chain_bwd_tc_sizes``): bf16 values of the
    scratch and of the transposed weights, phase 1's slices and the dW
    pass's row chunks."""
    desc = make_desc(plan)
    scratch, wt = ctypes.c_longlong(0), ctypes.c_longlong(0)
    slices, chunks = ctypes.c_int(0), ctypes.c_int(0)
    run('nfk_chain_bwd_tc_sizes', device, ctypes.addressof(desc), n,
        ctypes.byref(scratch), ctypes.byref(wt), ctypes.byref(slices),
        ctypes.byref(chunks), stream=False)
    return {'scratch': scratch.value, 'wt': wt.value, 'slices': slices.value,
            'chunks': chunks.value}


def _chain_bwd_tc(plan, x, dy, params, wt=None, stash_route=False,
                  stash=None, needs_dx=False, needs_dw=True):
    """Launches ``nfk_chain_bwd_tc``, with ``stash_route``
    ``nfk_chain_stash_bwd_tc`` over ``stash`` (phase 1, the dW pass, their
    sums) or, for a last-skip plan, ``nfk_chain_last_skip_bwd_tc`` (phase
    1, then the dW pass with ``needs_dw`` and the dx pass with
    ``needs_dx``) over the weights padded to :func:`mma_plan`'s widths
    where they differ, and their transposes ``wt`` (packed here when
    None). Returns (dx or None, [(dW, db)] of ``plan`` or None), f32."""
    kplan = mma_plan(plan)
    if kplan != plan:
        params = pad_params(plan, params)
    (x, dy), desc, _, w_flat, b_flat = prepare(
        kplan, [('x', x, raw_dim(plan)), ('dy', dy, out_dim(plan))], params,
        torch.bfloat16)
    device, n = x.device, x.shape[0]
    size = tc_bwd_sizes(kplan, n, device)
    tab, _ = chain_dw_table(kplan, device)
    if wt is None:
        wt = transposed_weights(kplan, w_flat, desc)
    if wt.numel() != size['wt']:
        raise RuntimeError("transposed weights: %d values, the kernel reads "
                           "%d" % (wt.numel(), size['wt']))
    dwb = torch.zeros(w_flat.numel() + b_flat.numel(), dtype=torch.float32,
                      device=device) if needs_dw else None
    dx = torch.empty_like(x) if needs_dx else None
    part = torch.empty(size['slices'] * (w_flat.numel() + b_flat.numel()
                                         - tab.n_dense)
                       + size['chunks'] * tab.n_dense, dtype=torch.float32,
                       device=device)
    scratch = torch.empty(size['scratch'], dtype=torch.bfloat16, device=device)
    if n:
        args = (w_flat.data_ptr(), wt.data_ptr(), b_flat.data_ptr(),
                scratch.data_ptr(), part.data_ptr(), _ptr(dwb))
        if last_skip(plan):
            run('nfk_chain_last_skip_bwd_tc', device, ctypes.addressof(desc),
                x.data_ptr(), dy.data_ptr(), *args, _ptr(dx), size['slices'],
                size['chunks'], n)
        else:
            entry, stash_arg = ('nfk_chain_stash_bwd_tc', (_ptr(stash),)) \
                if stash_route else ('nfk_chain_bwd_tc', ())
            run(entry, device, ctypes.addressof(desc), x.data_ptr(),
                dy.data_ptr(), *stash_arg, *args, size['slices'],
                size['chunks'], n)
    if not needs_dw:
        return dx, None
    grads = unpack_grads(kplan, dwb)
    return dx, grads if kplan == plan else unpad_grads(plan, grads)


def tc_matmul_f32(a, b, terms=3):
    """The f32 tensor-core building block alone (``nfk_tc_matmul_f32``): a
    (M, K) @ b (N, K)^T in f32 with ``terms`` TF32 products (3: split
    TF32; 1: plain TF32), through the split, fragments and pipeline of the
    f32 K1 kernels. For tests; it counts no launch."""
    m, k = a.shape
    n = b.shape[0]
    bt = b.new_zeros(n, round16(k), dtype=torch.float32)
    bt[:, :k] = b
    a, = check_inputs([('a', a, k)])
    bt, = check_inputs([('b', bt, round16(k))])
    c = torch.empty(m, n, dtype=torch.float32, device=a.device)
    run('nfk_tc_matmul_f32', a.device, a.data_ptr(), bt.data_ptr(),
        c.data_ptr(), m, n, k, terms)
    return c


def _chain_bwd_dx_tc_f32(plan, x, dy, params, wt=None, terms=3):
    """Launches ``nfk_chain_bwd_dx_tc_f32``, f32 K1-bwd with dx only on
    the tensor cores (``terms`` TF32 products: 3, or the control's 1), over
    the weights padded to :func:`mma_plan`'s widths where they differ and
    their f32 transposes ``wt`` (packed here when None). Returns dx (N,
    raw_dim) f32."""
    kplan = mma_plan(plan)
    if kplan != plan:
        params = pad_params(plan, params)
    (x, dy), desc, _, w_flat, b_flat = prepare(
        kplan, [('x', x, raw_dim(plan)), ('dy', dy, out_dim(plan))], params,
        None)
    if wt is None:
        wt = transposed_weights(kplan, w_flat, desc)
    if wt.dtype != torch.float32:
        raise ValueError("the f32 tensor-core K1-bwd reads f32 transposed "
                         "weights, got %s" % wt.dtype)
    dx = torch.empty_like(x)
    if x.shape[0]:
        run('nfk_chain_bwd_dx_tc_f32', x.device, ctypes.addressof(desc),
            x.data_ptr(), dy.data_ptr(), w_flat.data_ptr(), wt.data_ptr(),
            b_flat.data_ptr(), dx.data_ptr(), terms, x.shape[0])
    return dx


@functools.lru_cache(maxsize=64)
def tc_bwd_f32_sizes(plan, n, device):
    """What one f32 tensor-core K1-bwd with dW launch over ``n`` rows
    needs, as the library sizes it (``nfk_chain_bwd_dw_tc_f32_sizes``):
    floats of the scratch and of ``part``, phase 1's slices and the dW
    pass's row chunks. Kept per plan, rows and device (a training step's
    heads ask it at every launch with the same rows)."""
    desc = make_desc(plan)
    scratch, part = ctypes.c_longlong(0), ctypes.c_longlong(0)
    slices, chunks = ctypes.c_int(0), ctypes.c_int(0)
    run('nfk_chain_bwd_dw_tc_f32_sizes', device, ctypes.addressof(desc), n,
        ctypes.byref(scratch), ctypes.byref(part), ctypes.byref(slices),
        ctypes.byref(chunks), stream=False)
    return {'scratch': scratch.value, 'part': part.value,
            'slices': slices.value, 'chunks': chunks.value}


def _chain_bwd_dw_tc_f32(plan, x, dy, params, wt=None, terms=3,
                         scratch=None):
    """Launches ``nfk_chain_bwd_dw_tc_f32``, f32 K1-bwd with dW only on
    the tensor cores (``terms`` TF32 products: 3, or the control's 1):
    phase 1 and the dW pass, over the weights padded to
    :func:`mma_plan`'s widths where they differ and their f32 transposes
    ``wt`` (packed here when None). ``scratch``: a list that receives
    phase 1's scratch (kernel tests read its posts). Returns [(dW, db)] of
    ``plan``, f32."""
    kplan = mma_plan(plan)
    if kplan != plan:
        params = pad_params(plan, params)
    (x, dy), desc, _, w_flat, b_flat = prepare(
        kplan, [('x', x, raw_dim(plan)), ('dy', dy, out_dim(plan))], params,
        None)
    device, n = x.device, x.shape[0]
    if wt is None:
        wt = transposed_weights(kplan, w_flat, desc)
    if wt.dtype != torch.float32:
        raise ValueError("the f32 tensor-core K1-bwd reads f32 transposed "
                         "weights, got %s" % wt.dtype)
    size = tc_bwd_f32_sizes(kplan, n, device)
    # The launch writes every value: the dW pass's tiles, phase 1's slices
    alloc = torch.empty if n else torch.zeros
    dwb = alloc(w_flat.numel() + b_flat.numel(), dtype=torch.float32,
                device=device)
    st = torch.empty(size['scratch'], dtype=torch.float32, device=device)
    part = torch.empty(size['part'], dtype=torch.float32, device=device)
    if n:
        run('nfk_chain_bwd_dw_tc_f32', device, ctypes.addressof(desc),
            x.data_ptr(), dy.data_ptr(), w_flat.data_ptr(), wt.data_ptr(),
            b_flat.data_ptr(), st.data_ptr(), part.data_ptr(), dwb.data_ptr(),
            terms, size['slices'], size['chunks'], n)
    if scratch is not None:
        scratch.append(st)
    grads = unpack_grads(kplan, dwb)
    return grads if kplan == plan else unpad_grads(plan, grads)


def _chain_bwd(plan, x, dy, params, compute_dtype, needs_dx, needs_dw, tc,
               stash_route=False, stash=None, wt=None):
    """Launches K1-bwd, K1r-bwd over ``stash`` with ``stash_route`` or,
    for a last-skip plan, K1w-bwd, for the output cotangent ``dy`` (N,
    out_dim): with ``tc`` the tensor-core design (over ``wt``, see
    :func:`chain_kernel_bwd`; in f32 K1-bwd with dx only or dW only),
    else nfk_chain_bwd. Returns (dx or None, [(dW, db)] or None, whether a
    kernel ran)."""
    if not (needs_dx or needs_dw):
        raise ValueError("K1-bwd launched with nothing to compute")
    if stash_route and trig_dim(plan):
        want = (x.shape[0], trig_dim(plan))
        if stash is None or stash.device != x.device \
                or stash.dtype != kernel_dtype(compute_dtype) \
                or tuple(stash.shape) != want:
            raise ValueError("The stash must be a %s %s %s tensor" % (
                x.device, kernel_dtype(compute_dtype), want))
        stash = stash.contiguous()
    if tc and kernel_dtype(compute_dtype) == torch.float32:
        if needs_dw:
            return None, _chain_bwd_dw_tc_f32(plan, x, dy, params, wt), \
                x.shape[0] > 0
        return _chain_bwd_dx_tc_f32(plan, x, dy, params, wt), None, \
            x.shape[0] > 0
    if tc:
        return (*_chain_bwd_tc(plan, x, dy, params, wt, stash_route, stash,
                               needs_dx, needs_dw), x.shape[0] > 0)
    (x, dy), desc, bf16, w_flat, b_flat = prepare(
        plan, [('x', x, raw_dim(plan)), ('dy', dy, out_dim(plan))], params,
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
            int(stash_route), int(needs_dx), int(needs_dw), x.data_ptr(),
            dy.data_ptr(), _ptr(stash), w_flat.data_ptr(), b_flat.data_ptr(),
            _ptr(dx), _ptr(part), _ptr(dwb), slices.value, n)
    return dx, (unpack_grads(plan, dwb) if needs_dw else None), n > 0


def chain_kernel_bwd(plan, x, dy, params, compute_dtype=None, needs_dx=True,
                     needs_dw=True, wt=None):
    """Launches K1-bwd: the cotangents of :func:`chain_kernel` for the
    output cotangent ``dy`` (N, out). Returns (dx (N, raw_dim) or None,
    [(dW, db)] or None), f32, as ``needs_dx`` / ``needs_dw`` ask. dW/db
    are bit-identical for the same inputs on the same card. ``wt``: the
    transposed hidden weights that K1-fwd's tensor-core kernel read for
    these params, which the tensor-core backward then does not pack again.
    On the calls :func:`bwd_on_tensor_cores` takes, bf16 runs phase 1 and
    the dW pass, f32 with dx alone ``chain_dx_f32_tc_kernel`` and f32
    with dW alone ``chain_bwd_f32_tc_kernel`` and ``dw_f32_kernel`` (split
    TF32); every other call the CUDA-core ``chain_bwd_kernel``. Counts its
    launches in ``chain_kernel_bwd.launches``, those of the bf16
    tensor-core design also in ``chain_kernel_bwd.tc_launches``, those of
    the f32 dx-only kernel in ``chain_kernel_bwd.dx_tc_launches``, those
    of the f32 dW-only design in ``chain_kernel_bwd.dw_tc_f32_launches``,
    and those that compute dW/db (a tensor-core design's dW pass, or the
    CUDA-core kernel's dW slices) in ``chain_kernel_bwd.dw_launches``."""
    _check_route(plan, 'K1-bwd', False)
    if needs_dx or needs_dw:  # before the rule asks the card
        check_inputs([('x', x, raw_dim(plan)), ('dy', dy, out_dim(plan))])
    tc = bwd_on_tensor_cores(plan, compute_dtype, needs_dx, needs_dw,
                             x.device, rows=x.shape[0])
    dx, grads, ran = _chain_bwd(plan, x, dy, params, compute_dtype, needs_dx,
                                needs_dw, tc, wt=wt)
    f32 = kernel_dtype(compute_dtype) == torch.float32
    chain_kernel_bwd.launches += ran
    chain_kernel_bwd.tc_launches += int(ran and tc and not f32)
    chain_kernel_bwd.dx_tc_launches += int(ran and tc and f32 and needs_dx)
    chain_kernel_bwd.dw_tc_f32_launches += int(ran and tc and f32
                                               and needs_dw)
    chain_kernel_bwd.dw_launches += int(ran and needs_dw)
    return dx, grads


kernel_lib.launch_counters(chain_kernel_bwd, 'launches', 'tc_launches',
                           'dx_tc_launches', 'dw_launches',
                           'dw_tc_f32_launches')


def chain_kernel_bwd_cuda_core(plan, x, dy, params, compute_dtype=None,
                               needs_dx=True, needs_dw=True):
    """The CUDA-core K1-bwd (``chain_bwd_kernel``) in either precision:
    what :func:`chain_kernel_bwd` runs off the tensor cores, and the kernel
    the f32 tensor-core designs (dx only, dW only) are held against.
    Counts no launch."""
    _check_route(plan, 'K1-bwd', False)
    return _chain_bwd(plan, x, dy, params, compute_dtype, needs_dx, needs_dw,
                      False)[:2]


def chain_kernel_bwd_dx_f32_tc(plan, x, dy, params, terms=3):
    """The f32 tensor-core K1-bwd with dx only (``chain_dx_f32_tc_kernel``)
    with ``terms`` TF32 products: 3, what :func:`chain_kernel_bwd` runs on
    the calls :func:`bwd_on_tensor_cores` takes; 1, plain TF32, the
    control. Returns dx. Raises on a plan the kernel does not take. Counts
    no launch."""
    _check_route(plan, 'K1-bwd', False)
    if not _f32_tc_runs(plan, x.device, dx=True):
        raise ValueError("the f32 tensor-core K1-bwd does not take %s"
                         % (plan,))
    return _chain_bwd_dx_tc_f32(plan, x, dy, params, terms=terms)


def chain_kernel_bwd_dw_f32_tc(plan, x, dy, params, terms=3, scratch=None):
    """The f32 tensor-core K1-bwd with dW only (``chain_bwd_f32_tc_kernel``
    and ``dw_f32_kernel``) with ``terms`` TF32 products: 3, what
    :func:`chain_kernel_bwd` runs on the calls :func:`bwd_on_tensor_cores`
    takes; 1, plain TF32, the control. Returns [(dW, db)]; ``scratch`` as
    :func:`_chain_bwd_dw_tc_f32` takes it. Raises on a plan the design
    does not take. Counts no launch."""
    _check_route(plan, 'K1-bwd', False)
    if not _f32_tc_runs(plan, x.device, dx=False, dw=True):
        raise ValueError("the f32 tensor-core K1-bwd with dW does not take "
                         "%s" % (plan,))
    return _chain_bwd_dw_tc_f32(plan, x, dy, params, terms=terms,
                                scratch=scratch)


def chain_kernel_stash_bwd(plan, x, dy, stash, params, compute_dtype=None,
                           needs_dx=True, wt=None):
    """Launches K1r-bwd: the cotangents of :func:`chain_kernel_stash` for
    ``dy`` (N, out), reading the trig columns from ``stash`` (K1r-fwd's,
    None for a plan without trig columns). Returns (dx or None, [(dW,
    db)]): dW/db always, as the TPU route computes them whatever the
    caller declared. In bf16 without dx on the plans
    :func:`bwd_on_tensor_cores` takes, that is the tensor-core design
    (``chain_stash_bwd_tc_kernel`` and the dW pass, over ``wt`` as
    :func:`chain_kernel_bwd`'s); every other call runs the CUDA-core
    ``chain_bwd_kernel``. Counts its launches in
    ``chain_kernel_stash_bwd.launches``, those of the tensor-core design
    also in ``chain_kernel_stash_bwd.tc_launches``."""
    _check_route(plan, 'K1r-bwd', False)
    tc = bwd_on_tensor_cores(plan, compute_dtype, needs_dx, True, x.device,
                             stash_route=True)
    dx, grads, ran = _chain_bwd(plan, x, dy, params, compute_dtype, needs_dx,
                                True, tc, stash_route=True, stash=stash,
                                wt=wt)
    chain_kernel_stash_bwd.launches += ran
    chain_kernel_stash_bwd.tc_launches += int(ran and tc)
    return dx, grads


kernel_lib.launch_counters(chain_kernel_stash_bwd, 'launches',
                           'tc_launches')


def chain_kernel_stash_bwd_cuda_core(plan, x, dy, stash, params,
                                     compute_dtype=None, needs_dx=True):
    """The CUDA-core K1r-bwd (``chain_bwd_kernel``'s stash route) in
    either precision, with or without dx: what
    :func:`chain_kernel_stash_bwd` runs off the tensor cores, and in bf16
    the kernel the tensor-core design is held against. Counts no
    launch."""
    _check_route(plan, 'K1r-bwd', False)
    return _chain_bwd(plan, x, dy, params, compute_dtype, needs_dx, True,
                      False, stash_route=True, stash=stash)[:2]


def chain_kernel_last_skip_bwd(plan, x, dy, params, compute_dtype=None,
                               needs_dx=True, needs_dw=True, wt=None):
    """Launches K1w-bwd: the cotangents of :func:`chain_kernel_last_skip`
    for ``dy`` (N, widths[-1] + embed_dim), as ``needs_dx`` / ``needs_dw``
    ask; dy's trailing columns reach dx through the embedding. In bf16 on
    the plans :func:`bwd_on_tensor_cores` takes, that is the tensor-core
    design (``chain_last_skip_bwd_tc_kernel``, then the dW pass with
    ``needs_dw`` and the dx pass ``chain_dx_pass_kernel`` with
    ``needs_dx``, over ``wt`` as :func:`chain_kernel_bwd`'s); every other
    call runs the CUDA-core ``chain_bwd_kernel``. dW/db are bit-identical
    for the same inputs on the same card. Counts its launches in
    ``chain_kernel_last_skip_bwd.launches``, those of the tensor-core
    design also in ``chain_kernel_last_skip_bwd.tc_launches``."""
    _check_route(plan, 'K1w-bwd', True)
    tc = bwd_on_tensor_cores(plan, compute_dtype, needs_dx, needs_dw,
                             x.device)
    dx, grads, ran = _chain_bwd(plan, x, dy, params, compute_dtype, needs_dx,
                                needs_dw, tc, wt=wt)
    chain_kernel_last_skip_bwd.launches += ran
    chain_kernel_last_skip_bwd.tc_launches += int(ran and tc)
    return dx, grads


kernel_lib.launch_counters(chain_kernel_last_skip_bwd, 'launches',
                           'tc_launches')


def chain_kernel_last_skip_bwd_cuda_core(plan, x, dy, params,
                                         compute_dtype=None, needs_dx=True,
                                         needs_dw=True):
    """The CUDA-core K1w-bwd (``chain_bwd_kernel``'s last-skip mode) in
    either precision: what :func:`chain_kernel_last_skip_bwd` runs off the
    tensor cores, and in bf16 the kernel the tensor-core design is held
    against. Counts no launch."""
    _check_route(plan, 'K1w-bwd', True)
    return _chain_bwd(plan, x, dy, params, compute_dtype, needs_dx, needs_dw,
                      False)[:2]


def grads_or_zeros(ctx, first, grads, inputs):
    """Autograd's cotangents for ``inputs`` (the Function's arguments
    from position ``first``): each of ``grads`` where given, zeros where
    the kernel was told not to compute it, None where autograd needs
    none."""
    return tuple(
        None if not ctx.needs_input_grad[first + i]
        else (g if g is not None else torch.zeros_like(t))
        for i, (g, t) in enumerate(zip(grads, inputs)))


def _pairs(flat):
    return list(zip(flat[0::2], flat[1::2]))


def _forward(plan, x, params, compute_dtype, stash_route, with_stash=False,
             backward=None):
    """The route's forward kernel: K1r with ``stash_route``, K1w for a
    last-skip plan, else K1 (``backward``, the (needs_dx, needs_dw) of the
    backward to follow, as :func:`fwd_on_tensor_cores` takes it). Returns
    (y, the K1r stash with ``with_stash``, else None, the transposed
    weights the tensor-core kernel read, else None)."""
    if stash_route:
        return _chain_kernel_stash(plan, x, params, compute_dtype,
                                   with_stash)
    if last_skip(plan):
        y, wt = _chain_kernel_last_skip(plan, x, params, compute_dtype)
    else:
        y, wt = _chain_kernel(plan, x, params, compute_dtype, backward)
    return y, None, wt


class ChainFunction(torch.autograd.Function):
    """The chain kernels' forward with their backward (the JAX package's
    ``_fused_chain_impl`` custom VJP): K1, K1r (``stash_route``, whose
    forward saves the stash for its backward) or, for a last-skip plan,
    K1w. ``needs_dx`` / ``needs_dw`` select the cotangents the backward
    computes (K1r computes dW/db in any case); the others come back as
    zeros, and with both False no backward kernel is launched. The
    tensor-core forwards hand the transposed weights they packed to the
    tensor-core backwards, so a step packs them once."""

    @staticmethod
    def forward(ctx, plan, compute_dtype, needs_dx, needs_dw, stash_route, x,
                *flat):
        y, stash, ctx.wt = _forward(plan, x, _pairs(flat), compute_dtype,
                                    stash_route, with_stash=True,
                                    backward=(needs_dx, needs_dw))
        ctx.save_for_backward(x, stash, *flat)
        ctx.plan, ctx.compute_dtype = plan, compute_dtype
        ctx.needs, ctx.stash_route = (needs_dx, needs_dw), stash_route
        return y

    @staticmethod
    def backward(ctx, dy):
        x, stash, *flat = ctx.saved_tensors
        needs_dx, needs_dw = ctx.needs
        plan, cd, params = ctx.plan, ctx.compute_dtype, _pairs(flat)
        dx, dparams = None, None
        if ctx.stash_route and (needs_dx or needs_dw):
            dx, dparams = chain_kernel_stash_bwd(plan, x, dy, stash, params, cd,
                                                 needs_dx=needs_dx, wt=ctx.wt)
        elif needs_dx or needs_dw:
            bwd = chain_kernel_last_skip_bwd if last_skip(plan) \
                else chain_kernel_bwd
            dx, dparams = bwd(plan, x, dy, params, cd, needs_dx=needs_dx,
                              needs_dw=needs_dw, wt=ctx.wt)
        dflat = [g for pair in dparams for g in pair] if dparams \
            else [None] * len(flat)
        return (None,) * 5 + grads_or_zeros(ctx, 5, [dx] + dflat,
                                            [x] + list(flat))


def needs_autograd(tensors):
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _fused_chain(plan, x, params, needs_dx=True, needs_dw=True,
                 transposed=None, compute_dtype=None):
    """The chain through its kernels, on the route ``transposed`` selects
    (None reads :data:`TRANSPOSED_BOUNDARY`; see the module docstring);
    a plan with a skip after its last layer takes K1w on either route. A
    CUDA tensor launches the route's kernels or raises; a CPU tensor takes
    the route's plain version (:func:`chain_reference_stash` for the stash
    route). ``needs_dx`` / ``needs_dw`` as in :func:`apply_chain`."""
    if transposed is None:
        transposed = TRANSPOSED_BOUNDARY
    stash_route = not transposed and not last_skip(plan)
    params = [(w, b) for w, b in params]
    if x.device.type == 'cpu':
        ref = chain_reference_stash if stash_route else chain_reference
        return ref(plan, x, params, compute_dtype=compute_dtype)
    flat = [t for pair in params for t in pair]
    if needs_autograd([x] + flat):
        return ChainFunction.apply(plan, compute_dtype, needs_dx, needs_dw,
                                   stash_route, x, *flat)
    return _forward(plan, x, params, compute_dtype, stash_route)[0]


def apply_chain(plan, x, params, force_reference=False, compute_dtype=None,
                needs_dx=True, needs_dw=True):
    """Runs the embed -> MLP -> head chain on ``x`` (N, raw_dim).

    ``params`` is the list of (w, b) over all layers (hidden + head);
    ``compute_dtype`` is None (true f32) or torch.bfloat16 (bf16
    operands, f32 accumulation), on every route. ``force_reference`` (the
    JAX package's ``fused_mlp = False``) runs the plain version on any
    device. Otherwise a CPU tensor takes the plain version and a CUDA
    tensor the kernels of :func:`_fused_chain`.

    ``needs_dx`` / ``needs_dw`` have the JAX meaning for the kernel's
    backward: pass ``needs_dx=False`` when ``x`` is data, and
    ``needs_dw=False`` when the weights are frozen; the backward then
    skips that branch and returns zeros for it (the stash route computes
    dW/db all the same). The plain version ignores them.
    """
    params = [(w, b) for w, b in params]
    # As the JAX apply_chain off the TPU: chain_reference on either route
    if force_reference or x.device.type == 'cpu':
        return chain_reference(plan, x, params, compute_dtype=compute_dtype)
    return _fused_chain(plan, x, params, needs_dx=needs_dx, needs_dw=needs_dw,
                        compute_dtype=compute_dtype)
