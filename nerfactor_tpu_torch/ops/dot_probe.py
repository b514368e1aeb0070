"""Chains of square bf16 products, the probe of the card's dependent
tensor-core pass rate (counterpart of the kernel in
tools/mosaic_dot_probe.py).

A pass multiplies every row of a (rows, width) operand by W_i^T, which is
the TPU probe's ``W_i @ y`` over its (width, cols) operand with rows in
place of columns. Three dependency structures at one pass count:

  * ``serial``: y <- bf16(y W_i^T), each pass on the previous one's output;
  * ``indep``: acc += y W_i^T in f32, no pass on another's output;
  * ``pair``: two serial half-chains, y1 on W_0, W_2, ... and y2 on W_1,
    W_3, ..., interleaved (dependency distance 2); out = y1 + y2 in f32;

with y = bf16(x), bf16 operands and f32 accumulation.
:func:`dot_chain` runs kernel P (``csrc/dot_probe.cu``: the warpgroup
product ``wgmma`` fed by TMA through an mbarrier ring) on a CUDA tensor
and :func:`dot_chain_reference`, the plain version, on a CPU tensor.
:func:`_dot_chain_mma` launches the ``mma.sync`` design it replaced
(``csrc/dot_probe_mma.cu``), kept as the control that the card tests and
``chip_smoke.py`` time beside it; :func:`wgmma_tile` runs the ``wgmma``
building blocks alone (``csrc/wgmma.cuh``).
"""

import ctypes

import torch

from nerfactor_tpu_torch.ops import kernel_lib

MODES = ('serial', 'indep', 'pair')
WIDTH = 128  # the kernel's operand width
CHUNK = 256  # rows a block covers at a time: a block's rows are a multiple
# Kernel P's plan (csrc/dot_probe.cu, nfk_dot_chain_plan): the weight
# matrices its ring holds, the matrices a ring stage holds, and the rows
# a block's consumer warpgroups hold at once
RING_MATS = 6
STAGE_MATS = {'serial': 1, 'indep': 1, 'pair': 2}
CHUNK_ROWS = {'serial': 256, 'indep': 256, 'pair': 128}
# Relative norm against the plain version: indep sums exact bf16 products
# in f32, so only the order differs; serial and pair round to bf16 after
# every pass, and a value that two f32 sums round to neighbouring bf16
# (2^-8 apart) carries on through the later passes
TOL = {'indep': 1e-5, 'serial': 1e-2, 'pair': 1e-2}


def ring_refill_depth(mode):
    """The least depth at which ``mode``'s chain refills every stage of
    kernel P's weight ring."""
    return RING_MATS + STAGE_MATS[mode]


def plan(mode):
    """Kernel P's plan for ``mode`` as the built library has it:
    (ring matrices, matrices a stage, rows a chunk)."""
    vals = [ctypes.c_int() for _ in range(3)]
    kernel_lib.check(kernel_lib.entry('nfk_dot_chain_plan')(
        MODES.index(mode), *[ctypes.byref(v) for v in vals]),
        'nfk_dot_chain_plan')
    return tuple(v.value for v in vals)


def check_depth(mode, depth):
    if mode not in MODES:
        raise ValueError("mode must be one of %s, got %r" % (MODES, mode))
    if depth < 1 or (mode == 'pair' and depth % 2):
        raise ValueError("%s needs a positive%s depth, got %d" % (
            mode, ' even' if mode == 'pair' else '', depth))


def dot_chain_reference(x, ws, mode):
    """Plain version: ``x`` (rows, width) f32 and ``ws`` (depth, width,
    width) through ``mode``'s chain as f32 products of the bf16 values,
    rounded to bf16 between serial passes; (rows, width) f32."""
    check_depth(mode, ws.shape[0])
    ws = ws.to(torch.bfloat16).float()
    y = x.to(torch.bfloat16)

    def dot(w, v):
        return torch.matmul(v.float(), w.t())

    if mode == 'serial':
        for w in ws:
            y = dot(w, y).to(torch.bfloat16)
        return y.float()
    if mode == 'indep':
        acc = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
        for w in ws:
            acc += dot(w, y)
        return acc
    y1 = y2 = y
    for i in range(0, ws.shape[0], 2):
        y1 = dot(ws[i], y1).to(torch.bfloat16)
        y2 = dot(ws[i + 1], y2).to(torch.bfloat16)
    return y1.float() + y2.float()


def check_operands(x, ws, mode, block):
    """Checks kernel P's operands (any device): ``x`` float32 (rows, 128),
    ``ws`` bfloat16 (depth, 128, 128) on x's device, ``block`` a positive
    multiple of 256; returns both contiguous."""
    check_depth(mode, ws.shape[0])
    if x.dtype != torch.float32 or x.dim() != 2 or x.shape[1] != WIDTH:
        raise ValueError("x must be a float32 (rows, %d) tensor, got %s "
                         "%s %s" % (WIDTH, x.device, x.dtype, tuple(x.shape)))
    if ws.device != x.device or ws.dtype != torch.bfloat16 \
            or tuple(ws.shape[1:]) != (WIDTH, WIDTH):
        raise ValueError("ws must be a %s bfloat16 (depth, %d, %d) tensor"
                         % (x.device, WIDTH, WIDTH))
    if block < CHUNK or block % CHUNK:
        raise ValueError("block must be a positive multiple of %d, got %d"
                         % (CHUNK, block))
    return x.contiguous(), ws.contiguous()


def _require_cuda(t, what):
    if not t.is_cuda:
        raise ValueError("%s needs CUDA tensors, got %s" % (what, t.device))


def _run(entry, device, *args):
    """Calls the library's ``entry`` with ``args`` and ``device``'s
    current stream; raises on its error code."""
    with torch.cuda.device(device):
        code = kernel_lib.entry(entry)(
            *args, torch.cuda.current_stream(device).cuda_stream)
    kernel_lib.check(code, entry)


def dot_chain_kernel(x, ws, mode, block=4096):
    """Launches kernel P: ``x`` (rows, 128) CUDA f32, ``ws`` (depth, 128,
    128) CUDA bf16 -> (rows, 128) f32. A CUDA block owns ``block`` rows (a
    multiple of 256). One call packs the weights into their swizzled
    layout and runs the chain (two launches on the card), and counts one
    in ``dot_chain_kernel.launches``."""
    _require_cuda(x, 'kernel P')
    x, ws = check_operands(x, ws, mode, block)
    out = torch.empty_like(x)
    if x.shape[0]:
        packed = torch.empty_like(ws)  # the swizzled weights
        _run('nfk_dot_chain', x.device, MODES.index(mode), x.data_ptr(),
             ws.data_ptr(), ws.shape[0], block, x.shape[0],
             packed.data_ptr(), out.data_ptr())
        dot_chain_kernel.launches += 1
    return out


kernel_lib.launch_counters(dot_chain_kernel, 'launches')


def _dot_chain_mma(x, ws, mode, block=4096):
    """The ``mma.sync`` design of kernel P (the control): the same chain
    and contract as :func:`dot_chain_kernel`, on the card only. Counts its
    launches in ``_dot_chain_mma.launches``."""
    _require_cuda(x, 'kernel P')
    x, ws = check_operands(x, ws, mode, block)
    out = torch.empty_like(x)
    if x.shape[0]:
        _run('nfk_dot_chain_mma', x.device, MODES.index(mode), x.data_ptr(),
             ws.data_ptr(), ws.shape[0], block, x.shape[0], out.data_ptr())
        _dot_chain_mma.launches += 1
    return out


kernel_lib.launch_counters(_dot_chain_mma, 'launches')

# Descriptor layout types of the wgmma building blocks (csrc/wgmma.cuh)
INTERLEAVE, SWIZZLE_128, SWIZZLE_64, SWIZZLE_32 = range(4)
SWIZZLE_ATOM = 1024  # the stride byte offset of a 128-byte-swizzled operand
TILE_ROWS = 64  # rows of one warpgroup product


def wgmma_tile(a, w, ss=False, layout=SWIZZLE_128, sbo=SWIZZLE_ATOM):
    """The ``wgmma`` building blocks alone: ``a`` (64, 128) @ ``w`` (128,
    128)^T in f32 from bf16 operands, eight k16 steps of
    m64n128k16 with B (and A when ``ss``) in 128-byte-swizzled shared
    memory, read through descriptors of ``layout`` and stride byte
    offset ``sbo`` (other values than the defaults misread the layout: the
    tests' controls). For tests; it counts no launch."""
    _require_cuda(a, 'wgmma_tile')
    a = a.to(torch.bfloat16).contiguous()
    w = w.to(torch.bfloat16).contiguous()
    if tuple(a.shape) != (TILE_ROWS, WIDTH) or tuple(w.shape) != (WIDTH,
                                                                 WIDTH):
        raise ValueError("wgmma_tile takes a (%d, %d) and w (%d, %d), got %s "
                         "and %s" % (TILE_ROWS, WIDTH, WIDTH, WIDTH,
                                     tuple(a.shape), tuple(w.shape)))
    d = torch.empty(TILE_ROWS, WIDTH, dtype=torch.float32, device=a.device)
    _run('nfk_wgmma_tile', a.device, a.data_ptr(), w.data_ptr(), int(ss),
         layout, sbo, d.data_ptr())
    return d


def wgmma_tile_reference(a, w):
    """Plain version of :func:`wgmma_tile`, in float64 from the same bf16
    values."""
    return a.to(torch.bfloat16).double() @ w.to(torch.bfloat16).double().t()


def dot_chain(x, ws, mode, block=4096):
    """``mode``'s chain: kernel P on a CUDA tensor, the plain version on a
    CPU tensor (any width there)."""
    if x.device.type == 'cpu':
        return dot_chain_reference(x, ws, mode)
    return dot_chain_kernel(x, ws, mode, block=block)
