"""The branched NeRF field (counterpart of nerfactor_tpu/ops/pallas_nerf.py).

The NeRF MLP is not a straight chain: the trunk over posenc(xyz) (8 x 256
ReLU with the input skip after layer 4 in nerf.ini) forks into a 1-wide
sigma head and a linear bottleneck, and the rgb branch reads [bottleneck |
posenc(view)] through a ReLU layer and a 3-wide head:

    trunk(embed(pts))  --> sigma_out -> sigma           (1)
                      \\-> bottleneck -> [ . | embed(views) ]
                            -> rgb_mlp -> rgb           (3)

:func:`apply_nerf` evaluates it:

  * on CUDA tensors through kernel K3-fwd (``csrc/fused_nerf.cu``); under
    autograd the backward is kernel K3-bwd, which recomputes the forward
    and returns the weight cotangents only: points and view directions
    are data (the JAX package's ``_nerf_fused_bwd``);
  * on CPU tensors (or with ``force_reference``, the JAX package's
    ``fused_mlp = False``) through :func:`nerf_reference`, the plain
    version, under ordinary autograd.

``params`` is (trunk, sigma, bottleneck, rgb), each a list of (w, b) in the
JAX layout (w (din, dout), applied as x @ w); rgb layer 0's rows are the
bottleneck's, then posenc(view)'s in [x, sin f0 x, cos f0 x, ...] order.
"""

import ctypes
from collections import namedtuple

import torch

from nerfactor_tpu_torch.ops import encoding
from nerfactor_tpu_torch.ops import fused_mlp as fm

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


def nerf_kernel(nplan, pts, views, params, compute_dtype=None):
    """Launches K3-fwd on ``pts``, ``views`` (N, 3) CUDA f32; returns
    (rgb (N, 3), sigma (N, 1)) f32. Counts its launches in
    ``nerf_kernel.launches``."""
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
        nerf_kernel.launches += 1
    return rgb, sigma


nerf_kernel.launches = 0


def nerf_kernel_bwd(nplan, pts, views, drgb, dsigma, params,
                    compute_dtype=None):
    """Launches K3-bwd: the weight cotangents of :func:`nerf_kernel` for
    the output cotangents ``drgb`` (N, 3) and ``dsigma`` (N, 1), as
    (trunk, sigma, bottleneck, rgb) lists of (dW, db), f32. They are
    bit-identical for the same inputs on the same card. Counts its
    launches in ``nerf_kernel_bwd.launches``."""
    pts, views, drgb, dsigma = fm.check_inputs([
        ('pts', pts, 3), ('views', views, 3),
        ('drgb', drgb, nplan.rgb_widths[-1]), ('dsigma', dsigma, 1)])
    desc, bf16, dense, aux = _prepare(nplan, params, compute_dtype,
                                      pts.device)
    n = pts.shape[0]
    dwb = pts.new_zeros(dense.numel() + aux.numel())
    if n:
        slices = ctypes.c_int(0)
        fm.run('nfk_nerf_bwd_slices', pts.device, ctypes.addressof(desc),
               bf16, n, ctypes.byref(slices), stream=False)
        part = pts.new_empty(slices.value * dwb.numel())
        fm.run('nfk_nerf_bwd', pts.device, ctypes.addressof(desc), bf16,
               pts.data_ptr(), views.data_ptr(), drgb.data_ptr(),
               dsigma.data_ptr(), dense.data_ptr(), aux.data_ptr(),
               part.data_ptr(), dwb.data_ptr(), slices.value, n)
        nerf_kernel_bwd.launches += 1
    return unpack_grads(nplan, dwb)


nerf_kernel_bwd.launches = 0


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
    points and view directions are data and get zeros."""

    @staticmethod
    def forward(ctx, nplan, compute_dtype, pts, views, *flat):
        ctx.save_for_backward(pts, views, *flat)
        ctx.nplan, ctx.compute_dtype = nplan, compute_dtype
        return nerf_kernel(nplan, pts, views, unflatten(nplan, flat),
                           compute_dtype)

    @staticmethod
    def backward(ctx, drgb, dsigma):
        pts, views, *flat = ctx.saved_tensors
        grads = nerf_kernel_bwd(ctx.nplan, pts, views, drgb, dsigma,
                                unflatten(ctx.nplan, flat), ctx.compute_dtype)
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
