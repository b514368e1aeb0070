"""The branched NeRF field (counterpart of nerfactor_tpu/ops/pallas_nerf.py).

The NeRF MLP is not a straight chain: the trunk over posenc(xyz) (8 x 256
ReLU with the input skip after layer 4 in nerf.ini) forks into a 1-wide
sigma head and a linear bottleneck, and the rgb branch reads [bottleneck |
posenc(view)] through a ReLU layer and a 3-wide head:

    trunk(embed(pts))  --> sigma_out -> sigma           (1)
                      \\-> bottleneck -> [ . | embed(views) ]
                            -> rgb_mlp -> rgb           (3)

:func:`apply_nerf` evaluates it:

  * on CUDA tensors through kernel K3-fwd (``csrc/fused_nerf.cu``; in bf16
    on the tensor cores); under autograd the backward is kernel K3-bwd,
    which recomputes the forward and returns the weight cotangents only:
    points and view directions are data (the JAX package's
    ``_nerf_fused_bwd``);
  * on CPU tensors (or with ``force_reference``, the JAX package's
    ``fused_mlp = False``) through :func:`nerf_reference`, the plain
    version, under ordinary autograd.

``params`` is (trunk, sigma, bottleneck, rgb), each a list of (w, b) in the
JAX layout (w (din, dout), applied as x @ w); rgb layer 0's rows are the
bottleneck's, then posenc(view)'s in [x, sin f0 x, cos f0 x, ...] order.
"""

import ctypes
import functools
from collections import namedtuple

import torch

from nerfactor_tpu_torch.ops import encoding
from nerfactor_tpu_torch.ops import fused_mlp as fm
from nerfactor_tpu_torch.ops import kernel_lib

# Static description (the JAX NerfPlan's fields). trunk_plan is a
# fused_mlp.Plan over the points' embedding, with no head; n_freqs_view the
# view posenc octaves (0 = raw view directions); rgb_acts the rgb layers'.
NerfPlan = namedtuple('NerfPlan',
                      'trunk_plan n_freqs_view rgb_widths rgb_acts')

MAX_HEAD_OUT = 8  # csrc/fused_nerf.cu kMaxHeadOut


def make_nerf_plan(n_freqs_xyz, n_freqs_view, width, depth, skip_at, act,
                   rgb_widths, rgb_acts):
    trunk = fm.make_plan([(3, n_freqs_xyz)], (width,) * depth,
                         (act,) * depth, (skip_at,))
    return NerfPlan(trunk, n_freqs_view, tuple(rgb_widths), tuple(rgb_acts))


def view_dim(nplan):
    return encoding.embed_dims(3, nplan.n_freqs_view)


def nerf_reference(nplan, pts, views, params, compute_dtype=None):
    """Plain version, the JAX package's ``nerf_reference``: the trunk
    through ``chain_reference`` with ``compute_dtype``, then the heads in
    f32 over the trunk's f32 output. Returns (rgb (N, 3), sigma (N, 1))."""
    trunk, sigma_p, bott_p, rgb_p = params
    ev = encoding.posenc(views, nplan.n_freqs_view)
    feat = fm.chain_reference(nplan.trunk_plan, pts, trunk,
                              compute_dtype=compute_dtype)
    (ws, bs), = sigma_p
    (wb, bb), = bott_p
    sigma = feat @ ws + bs
    h = torch.cat([feat @ wb + bb, ev], dim=1)
    for (w, b), act in zip(rgb_p, nplan.rgb_acts):
        h = fm._act(act, h @ w + b)
    return h, sigma


# ------ kernels K3-fwd and K3-bwd ------

class NerfDesc(ctypes.Structure):
    """csrc/fused_nerf.cu ``nfk::NerfDesc``, field for field."""
    _fields_ = [
        ('trunk', fm.ChainDesc),
        ('view', fm.ChainDesc),
        ('rgb_hidden', ctypes.c_int),
        ('rgb_out', ctypes.c_int),
        ('rgb_acts', ctypes.c_int * 2),
    ] + [(name, ctypes.c_longlong) for name in (
        'bott_w', 'rgb0_w', 'sigma_w', 'sigma_b', 'bott_b', 'rgb0_b',
        'rgb1_w', 'rgb1_b', 'n_dense', 'n_aux')]


def kernel_supports(nplan):
    """Whether K3 takes this plan: one trunk width, a trunk K1 takes with
    no skip after its last layer, two rgb layers, the first no wider than
    the trunk and the head at most 8 wide."""
    tp = nplan.trunk_plan
    return (fm.kernel_supports(tp) and not fm.last_skip(tp)
            and len(set(tp.widths)) == 1
            and len(nplan.rgb_widths) == 2
            and nplan.rgb_widths[0] <= tp.widths[0]
            and nplan.rgb_widths[1] <= MAX_HEAD_OUT)


def layout(nplan):
    """Offsets of the packed parameters: dense weights (trunk layers,
    bottleneck, rgb layer 0) in one buffer of the operand type; the
    heads' weights and every bias in one f32 ``aux`` buffer."""
    tp = nplan.trunk_plan
    width, (hr, n_out) = tp.widths[-1], nplan.rgb_widths
    dims = fm.layer_in_dims(tp)
    off = {'bott_w': sum(d * w for d, w in zip(dims, tp.widths))}
    off['rgb0_w'] = off['bott_w'] + width * width
    off['n_dense'] = off['rgb0_w'] + (width + view_dim(nplan)) * hr
    off['sigma_w'] = sum(tp.widths)
    off['sigma_b'] = off['sigma_w'] + width
    off['bott_b'] = off['sigma_b'] + 1
    off['rgb0_b'] = off['bott_b'] + width
    off['rgb1_w'] = off['rgb0_b'] + hr
    off['rgb1_b'] = off['rgb1_w'] + hr * n_out
    off['n_aux'] = off['rgb1_b'] + n_out
    return off


def make_desc(nplan):
    if not kernel_supports(nplan):
        raise NotImplementedError(
            "NeRF plan not supported by the CUDA kernel: %s" % (nplan,))
    d = NerfDesc()
    d.trunk = fm.make_desc(nplan.trunk_plan)
    d.view.n_parts = 1
    d.view.part_dim[0], d.view.part_freqs[0] = 3, nplan.n_freqs_view
    d.view.raw_dim, d.view.embed_dim = 3, view_dim(nplan)
    d.rgb_hidden, d.rgb_out = nplan.rgb_widths
    for i, act in enumerate(nplan.rgb_acts):
        d.rgb_acts[i] = fm.ACT_CODES[act]
    for name, value in layout(nplan).items():
        setattr(d, name, value)
    return d


def pack_params(nplan, params, dtype):
    """(dense weights at ``dtype``, aux f32): see :func:`layout`."""
    trunk, sigma_p, bott_p, rgb_p = params
    tp = nplan.trunk_plan
    width, ev = tp.widths[-1], view_dim(nplan)
    want = [(din, w) for din, w in zip(fm.layer_in_dims(tp), tp.widths)] \
        + [(width, 1), (width, width), (width + ev, nplan.rgb_widths[0]),
           (nplan.rgb_widths[0], nplan.rgb_widths[1])]
    got = list(trunk) + list(sigma_p) + list(bott_p) + list(rgb_p)
    for (w, b), shape in zip(got, want):
        if tuple(w.shape) != shape or tuple(b.shape) != shape[1:]:
            raise ValueError("NeRF params %s, %s do not fit the plan (%s)"
                             % (tuple(w.shape), tuple(b.shape), shape))
    (ws, bs), = sigma_p
    (wb, bb), = bott_p
    (w0, b0), (w1, b1) = rgb_p
    dense = torch.cat([w.reshape(-1) for w, _ in trunk]
                      + [wb.reshape(-1), w0.reshape(-1)]).to(dtype)
    aux = torch.cat([b for _, b in trunk]
                    + [ws.reshape(-1), bs, bb, b0, w1.reshape(-1), b1]).float()
    return dense.contiguous(), aux.contiguous()


def unpack_grads(nplan, dwb):
    """The packed f32 [dense | aux] cotangents -> (trunk, sigma,
    bottleneck, rgb) lists of (dW, db), shaped as the params."""
    tp = nplan.trunk_plan
    off = layout(nplan)
    width, (hr, n_out) = tp.widths[-1], nplan.rgb_widths
    dense, aux = dwb[:off['n_dense']], dwb[off['n_dense']:]
    trunk, w_off, b_off = [], 0, 0
    for din, w in zip(fm.layer_in_dims(tp), tp.widths):
        trunk.append((dense[w_off:w_off + din * w].view(din, w),
                      aux[b_off:b_off + w]))
        w_off += din * w
        b_off += w

    def a(name, n):
        return aux[off[name]:off[name] + n]
    sigma = [(a('sigma_w', width).view(width, 1), a('sigma_b', 1))]
    bott = [(dense[off['bott_w']:off['rgb0_w']].view(width, width),
             a('bott_b', width))]
    rgb = [(dense[off['rgb0_w']:].view(width + view_dim(nplan), hr),
            a('rgb0_b', hr)),
           (a('rgb1_w', hr * n_out).view(hr, n_out), a('rgb1_b', n_out))]
    return trunk, sigma, bott, rgb


def _prepare(nplan, params, compute_dtype, device):
    desc = make_desc(nplan)
    kdt = fm.kernel_dtype(compute_dtype)
    dense, aux = pack_params(nplan, params, kdt)
    if dense.device != device:
        raise ValueError("params must lie on %s" % device)
    return desc, int(kdt == torch.bfloat16), dense, aux


def _nerf_fwd(nplan, pts, views, params, compute_dtype):
    """Launches K3-fwd on ``pts``, ``views`` (N, 3) CUDA f32: in bf16 the
    tensor-core kernel (``nfk_nerf_fwd_tc``) over the weights padded to
    :func:`mma_plan`'s widths where they differ and their transposes, in
    f32 the CUDA-core one (``nfk_nerf_fwd``). Returns (rgb, sigma, the
    transposes or None, whether a kernel ran)."""
    if fm.kernel_dtype(compute_dtype) != torch.bfloat16:
        rgb, sigma, ran = _nerf_fwd_cuda_core(nplan, pts, views, params,
                                              compute_dtype)
        return rgb, sigma, None, ran
    kplan, params = _mma_params(nplan, params)
    pts, views = fm.check_inputs([('pts', pts, 3), ('views', views, 3)])
    desc, _, dense, aux = _prepare(kplan, params, compute_dtype, pts.device)
    wt = transposed_weights(kplan, dense)
    n = pts.shape[0]
    rgb = pts.new_empty((n, nplan.rgb_widths[-1]))
    sigma = pts.new_empty((n, 1))
    if n:
        fm.run('nfk_nerf_fwd_tc', pts.device, ctypes.addressof(desc),
               pts.data_ptr(), views.data_ptr(), wt.data_ptr(),
               aux.data_ptr(), rgb.data_ptr(), sigma.data_ptr(), n)
    return rgb, sigma, wt, n > 0


def _nerf_fwd_cuda_core(nplan, pts, views, params, compute_dtype):
    """Launches ``nfk_nerf_fwd`` (the CUDA-core nerf_fwd_kernel); returns
    (rgb, sigma, whether a kernel ran)."""
    pts, views = fm.check_inputs([('pts', pts, 3), ('views', views, 3)])
    desc, bf16, dense, aux = _prepare(nplan, params, compute_dtype,
                                      pts.device)
    n = pts.shape[0]
    rgb = pts.new_empty((n, nplan.rgb_widths[-1]))
    sigma = pts.new_empty((n, 1))
    if n:
        fm.run('nfk_nerf_fwd', pts.device, ctypes.addressof(desc), bf16,
               pts.data_ptr(), views.data_ptr(), dense.data_ptr(),
               aux.data_ptr(), rgb.data_ptr(), sigma.data_ptr(), n)
    return rgb, sigma, n > 0


def _counted_fwd(nplan, pts, views, params, compute_dtype):
    """:func:`_nerf_fwd`, its launch counted as :func:`nerf_kernel` says;
    returns (rgb, sigma, the transposed weights or None)."""
    rgb, sigma, wt, ran = _nerf_fwd(nplan, pts, views, params, compute_dtype)
    nerf_kernel.launches += ran
    if wt is not None:
        nerf_kernel.tc_launches += ran
    return rgb, sigma, wt


def nerf_kernel(nplan, pts, views, params, compute_dtype=None):
    """Launches K3-fwd on ``pts``, ``views`` (N, 3) CUDA f32; returns
    (rgb (N, 3), sigma (N, 1)) f32. In bf16 that is ``nerf_fwd_tc_kernel``
    on the tensor cores, in f32 the CUDA-core ``nerf_fwd_kernel``. Counts
    its launches in ``nerf_kernel.launches``, those of the tensor-core
    kernel also in ``nerf_kernel.tc_launches``."""
    return _counted_fwd(nplan, pts, views, params, compute_dtype)[:2]


kernel_lib.launch_counters(nerf_kernel, 'launches', 'tc_launches')


def nerf_kernel_cuda_core(nplan, pts, views, params, compute_dtype=None):
    """The CUDA-core K3-fwd (``nerf_fwd_kernel``) in either precision: what
    :func:`nerf_kernel` runs in f32, and in bf16 the kernel the
    tensor-core one is held against. Counts no launch."""
    return _nerf_fwd_cuda_core(nplan, pts, views, params, compute_dtype)[:2]


# ------ K3-bwd ------

@functools.lru_cache(maxsize=None)
def dw_table(nplan, device):
    """The dense layers (trunk layers, bottleneck, rgb layer 0) of the bf16
    backward's scratch as the library lays them out
    (``nfk_nerf_dw_table``): every dense layer's inputs (the embeddings
    zero-padded to 16 columns), then every dense layer's rounded d_pre.
    Returns (fused_mlp.DwTable, the dW pass's tile)."""
    return fm.dw_table('nfk_nerf_dw_table', make_desc(nplan), device)


def transposed_weights(kplan, dense):
    """The dense layers' weights transposed for the tensor-core kernels of
    ``kplan`` (an :func:`mma_plan`), laid out over :func:`dw_table`'s
    layers, from ``dense``, the packed dense weights (:func:`pack_params`,
    bf16) on the card: one launch of the packing kernel
    (``nfk_pack_transposed_table``, ``csrc/pack_transposed.cu``), the bits
    of ``fused_mlp.pack_transposed``, its plain version (see
    :func:`transposed_weights_plain`). Counts its launches in
    ``transposed_weights.launches``."""
    tab = dw_table(kplan, dense.device)[0]
    wt = torch.empty(sum(l.n * (fm.round16(l.k1) + fm.round16(l.k2))
                         for l in tab.dense()),
                     dtype=dense.dtype, device=dense.device)
    fm.run('nfk_pack_transposed_table', dense.device, ctypes.addressof(tab),
           int(dense.dtype == torch.bfloat16), dense.data_ptr(),
           wt.data_ptr())
    transposed_weights.launches += 1
    return wt


kernel_lib.launch_counters(transposed_weights, 'launches')


def transposed_weights_plain(kplan, params, device, dtype=torch.bfloat16):
    """The plain version of :func:`transposed_weights`: the dense layers'
    weights of (trunk, sigma, bottleneck, rgb) ``params`` through
    ``fused_mlp.pack_transposed``, one torch copy a weight segment."""
    trunk, _, bott_p, rgb_p = params
    dense = [w for w, _ in trunk] + [bott_p[0][0], rgb_p[0][0]]
    return fm.pack_transposed(dense, dw_table(kplan, device)[0], dtype)


def check_tensor(name, t, dtype, numel):
    """Raises unless ``t`` is a contiguous CUDA tensor of ``dtype`` with
    ``numel`` elements."""
    if not t.is_cuda or t.dtype != dtype or t.numel() != numel \
            or not t.is_contiguous():
        raise ValueError("%s must be a contiguous CUDA %s tensor of %d "
                         "elements, got %s %s %s" % (
                             name, dtype, numel, t.device, t.dtype,
                             tuple(t.shape)))


def bwd_sizes(nplan, n, compute_dtype, device):
    """What one K3-bwd launch over ``n`` rows needs, as the library sizes
    it (``nfk_nerf_bwd_sizes``): bf16 values of the scratch and of the
    transposed weights, the slices of phase 1 (or of the f32 kernel) and
    the dW pass's row chunks."""
    desc = make_desc(nplan)
    bf16 = int(fm.kernel_dtype(compute_dtype) == torch.bfloat16)
    scratch, wt = ctypes.c_longlong(0), ctypes.c_longlong(0)
    slices, chunks = ctypes.c_int(0), ctypes.c_int(0)
    fm.run('nfk_nerf_bwd_sizes', device, ctypes.addressof(desc), bf16, n,
           ctypes.byref(scratch), ctypes.byref(wt), ctypes.byref(slices),
           ctypes.byref(chunks), stream=False)
    return {'scratch': scratch.value, 'wt': wt.value,
            'slices': slices.value, 'chunks': chunks.value}


def bwd_buffers(nplan, n, compute_dtype, device):
    """The buffers of one K3-bwd launch (:func:`bwd_sizes`): f32 slices of
    the dW/db sums (``part``), the bf16 scratch and the packed f32 result
    ``dwb``."""
    size = bwd_sizes(nplan, n, compute_dtype, device)
    off = layout(nplan)
    bf16 = fm.kernel_dtype(compute_dtype) == torch.bfloat16
    stride = off['n_aux'] + (0 if bf16 else off['n_dense'])
    return {'part': torch.empty(size['slices'] * stride + size['chunks']
                                * off['n_dense'], dtype=torch.float32,
                                device=device),
            'scratch': torch.empty(size['scratch'], dtype=torch.bfloat16,
                                   device=device),
            'dwb': torch.zeros(off['n_dense'] + off['n_aux'],
                               dtype=torch.float32, device=device),
            'slices': size['slices'], 'chunks': size['chunks'],
            'wt_numel': size['wt']}


def _mma_params(nplan, params):
    """(:func:`mma_plan`, ``params`` padded to it where it differs)."""
    kplan = mma_plan(nplan)
    return (nplan, params) if kplan == nplan \
        else (kplan, pad_params(nplan, params))


def mma_plan(nplan):
    """The plan bf16 K3-bwd runs ``nplan`` as: its products step K by 16
    (mma.sync m16n8k16), so the trunk and rgb hidden widths are rounded up
    to multiples of 16."""
    tp = nplan.trunk_plan
    return nplan._replace(
        trunk_plan=tp._replace(widths=tuple(fm.round16(w) for w in tp.widths)),
        rgb_widths=(fm.round16(nplan.rgb_widths[0]),) + nplan.rgb_widths[1:])


def _leaf_dims(nplan):
    """Per leaf of :func:`flatten`'s order: (rows of the hidden layer a
    weight reads first, columns); (None, columns) for a bias."""
    tp = nplan.trunk_plan
    w, (hr, n_out) = tp.widths[0], nplan.rgb_widths
    dims = []
    for i in range(len(tp.widths)):
        dims += [(w if i else 0, w), (None, w)]
    return dims + [(w, 1), (None, 1), (w, w), (None, w), (w, hr), (None, hr),
                   (hr, n_out), (None, n_out)]


def pad_params(nplan, params):
    """``params`` zero-padded to :func:`mma_plan`'s widths: each padded
    unit has zero weights in and out, so it changes no output and no dW/db
    of a real unit (:func:`unpad_grads` drops its own)."""
    flat = []
    for t, (k, n), (k16, n16) in zip(flatten(params), _leaf_dims(nplan),
                                     _leaf_dims(mma_plan(nplan))):
        if k is None:
            out = t.new_zeros(n16)
            out[:n] = t
        else:
            out = t.new_zeros(k16 + t.shape[0] - k, n16)
            out[:k, :n] = t[:k]
            out[k16:, :n] = t[k:]
        flat.append(out)
    return unflatten(nplan, flat)


def unpad_grads(nplan, grads):
    """The real units' dW/db out of :func:`mma_plan`'s (trunk, sigma,
    bottleneck, rgb) cotangents."""
    flat = []
    for g, (k, n), (k16, _) in zip(flatten(grads), _leaf_dims(nplan),
                                   _leaf_dims(mma_plan(nplan))):
        flat.append(g[:n] if k is None
                    else torch.cat([g[:k, :n], g[k16:, :n]]))
    return unflatten(nplan, flat)


def nerf_kernel_bwd(nplan, pts, views, drgb, dsigma, params,
                    compute_dtype=None, wt=None):
    """Launches K3-bwd: the weight cotangents of :func:`nerf_kernel` for
    the output cotangents ``drgb`` (N, 3) and ``dsigma`` (N, 1), as
    (trunk, sigma, bottleneck, rgb) lists of (dW, db), f32. In bf16 that is
    phase 1, the dW pass and their sums on the tensor cores, over the
    weights padded to :func:`mma_plan`'s widths where they differ and
    their transposes ``wt`` (the ones K3-fwd's tensor-core kernel read for
    these params, else packed here); in f32 the CUDA-core kernel. They are
    bit-identical for the same inputs on the same card. Counts its
    launches in ``nerf_kernel_bwd.launches``."""
    kplan = nplan
    if fm.kernel_dtype(compute_dtype) == torch.bfloat16:
        kplan, params = _mma_params(nplan, params)
    pts, views, drgb, dsigma = fm.check_inputs([
        ('pts', pts, 3), ('views', views, 3),
        ('drgb', drgb, kplan.rgb_widths[-1]), ('dsigma', dsigma, 1)])
    desc, bf16, dense, aux = _prepare(kplan, params, compute_dtype,
                                      pts.device)
    n = pts.shape[0]
    bufs = bwd_buffers(kplan, n, compute_dtype, pts.device)
    if not bf16:
        wt = None
    elif wt is None:
        wt = transposed_weights(kplan, dense)
    if bf16 and wt.numel() != bufs['wt_numel']:
        raise RuntimeError("transposed weights: %d values, the kernel reads "
                           "%d" % (wt.numel(), bufs['wt_numel']))
    if n:
        fm.run('nfk_nerf_bwd', pts.device, ctypes.addressof(desc), bf16,
               pts.data_ptr(), views.data_ptr(), drgb.data_ptr(),
               dsigma.data_ptr(), dense.data_ptr(),
               wt.data_ptr() if bf16 else None, aux.data_ptr(),
               bufs['scratch'].data_ptr(), bufs['part'].data_ptr(),
               bufs['dwb'].data_ptr(), bufs['slices'], bufs['chunks'], n)
        nerf_kernel_bwd.launches += 1
    grads = unpack_grads(kplan, bufs['dwb'])
    return grads if kplan is nplan else unpad_grads(nplan, grads)


kernel_lib.launch_counters(nerf_kernel_bwd, 'launches')


def tc_matmul(a, b):
    """The tensor-core building block alone (``nfk_tc_matmul``): a (M, K)
    @ b (N, K)^T in f32 from bf16 operands, through the fragment loaders
    and pipeline of K3-bwd. For tests; it counts no launch."""
    m, k = a.shape
    n = b.shape[0]
    a = a.to(torch.bfloat16).contiguous()
    bt = b.new_zeros(n, fm.round16(k), dtype=torch.bfloat16)
    bt[:, :k] = b
    check_tensor('a', a, torch.bfloat16, m * k)
    check_tensor('b', bt, torch.bfloat16, n * fm.round16(k))
    c = torch.empty(m, n, dtype=torch.float32, device=a.device)
    fm.run('nfk_tc_matmul', a.device, a.data_ptr(), bt.data_ptr(),
           c.data_ptr(), m, n, k)
    return c


def tc_matmul_reference(a, b):
    """Plain version of :func:`tc_matmul`, in float64 from the same bf16
    values."""
    return a.to(torch.bfloat16).double() @ b.to(torch.bfloat16).double().t()


def flatten(params):
    """(trunk, sigma, bottleneck, rgb) -> [w, b, w, b, ...]."""
    return [t for group in params for pair in group for t in pair]


def unflatten(nplan, flat):
    pairs = list(zip(flat[0::2], flat[1::2]))
    depth = len(nplan.trunk_plan.widths)
    return (pairs[:depth], pairs[depth:depth + 1],
            pairs[depth + 1:depth + 2], pairs[depth + 2:])


class NerfFunction(torch.autograd.Function):
    """K3-fwd with K3-bwd as its backward (the JAX package's
    ``_nerf_fused`` custom VJP): weight cotangents from the kernel; the
    points and view directions are data and get zeros. In bf16 the
    forward hands the transposed weights it packed to the backward, so a
    step packs them once."""

    @staticmethod
    def forward(ctx, nplan, compute_dtype, pts, views, *flat):
        ctx.save_for_backward(pts, views, *flat)
        ctx.nplan, ctx.compute_dtype = nplan, compute_dtype
        rgb, sigma, ctx.wt = _counted_fwd(nplan, pts, views,
                                          unflatten(nplan, flat),
                                          compute_dtype)
        return rgb, sigma

    @staticmethod
    def backward(ctx, drgb, dsigma):
        pts, views, *flat = ctx.saved_tensors
        grads = nerf_kernel_bwd(ctx.nplan, pts, views, drgb, dsigma,
                                unflatten(ctx.nplan, flat), ctx.compute_dtype,
                                wt=ctx.wt)
        return (None, None) + fm.grads_or_zeros(
            ctx, 2, [None, None] + flatten(grads), [pts, views] + list(flat))


def apply_nerf(nplan, pts, views, params, force_reference=False,
               compute_dtype=None):
    """(N, 3), (N, 3) -> (rgb (N, 3), sigma (N, 1)).

    ``params`` = (trunk, sigma, bottleneck, rgb) lists of (w, b);
    ``compute_dtype`` is None (true f32) or torch.bfloat16 (bf16 operands,
    f32 accumulation, f32 heads). A CPU tensor (or ``force_reference``)
    takes the plain version; a CUDA tensor the kernels.
    """
    params = tuple([(w, b) for w, b in group] for group in params)
    if force_reference or pts.device.type == 'cpu':
        return nerf_reference(nplan, pts, views, params,
                              compute_dtype=compute_dtype)
    flat = flatten(params)
    if fm.needs_autograd([pts, views] + flat):
        return NerfFunction.apply(nplan, compute_dtype, pts, views, *flat)
    return nerf_kernel(nplan, pts, views, params, compute_dtype=compute_dtype)
