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
:func:`dot_chain` runs kernel P (``csrc/dot_probe.cu``, tensor cores via
``mma.sync``) on a CUDA tensor and :func:`dot_chain_reference`, the plain
version, on a CPU tensor.
"""

import torch

from nerfactor_tpu_torch.ops import kernel_lib

MODES = ('serial', 'indep', 'pair')
WIDTH = 128  # the kernel's operand width
CHUNK = 256  # rows a block covers at a time: a block's rows are a multiple


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


def dot_chain_kernel(x, ws, mode, block=4096):
    """Launches kernel P: ``x`` (rows, 128) CUDA f32, ``ws`` (depth, 128,
    128) CUDA bf16 -> (rows, 128) f32. A CUDA block owns ``block`` rows (a
    multiple of 256). Counts its launches in
    ``dot_chain_kernel.launches``."""
    check_depth(mode, ws.shape[0])
    if not x.is_cuda or x.dtype != torch.float32 or x.dim() != 2 \
            or x.shape[1] != WIDTH:
        raise ValueError("x must be a CUDA float32 (rows, %d) tensor, got %s "
                         "%s %s" % (WIDTH, x.device, x.dtype, tuple(x.shape)))
    if ws.device != x.device or ws.dtype != torch.bfloat16 \
            or tuple(ws.shape[1:]) != (WIDTH, WIDTH):
        raise ValueError("ws must be a %s bfloat16 (depth, %d, %d) tensor"
                         % (x.device, WIDTH, WIDTH))
    if block < CHUNK or block % CHUNK:
        raise ValueError("block must be a positive multiple of %d, got %d"
                         % (CHUNK, block))
    x, ws = x.contiguous(), ws.contiguous()
    out = torch.empty_like(x)
    if x.shape[0]:
        with torch.cuda.device(x.device):
            code = kernel_lib.entry('nfk_dot_chain')(
                MODES.index(mode), x.data_ptr(), ws.data_ptr(), ws.shape[0],
                block, x.shape[0], out.data_ptr(),
                torch.cuda.current_stream(x.device).cuda_stream)
        kernel_lib.check(code, 'nfk_dot_chain')
        dot_chain_kernel.launches += 1
    return out


dot_chain_kernel.launches = 0


def dot_chain(x, ws, mode, block=4096):
    """``mode``'s chain: kernel P on a CUDA tensor, the plain version on a
    CPU tensor (any width there)."""
    if x.device.type == 'cpu':
        return dot_chain_reference(x, ws, mode)
    return dot_chain_kernel(x, ws, mode, block=block)
