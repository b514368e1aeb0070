"""Kernels (``ops/fused_mlp.py`` -> ``csrc/fused_mlp.cu``): K1-bwd on the
joint step's visibility chain (bf16 on the tensor cores: its first phase
and its dW pass), as a share of its roofline: the larger of its
operations over the bf16 peak and its bytes over the HBM bandwidth
(``counts/K1-bwd.py``), over its device time in the profiler window."""

from perfbench import card
from perfbench.harness import BF16_PEAK, HBM_BYTES_S

KERNELS = r'chain_bwd_tc_kernel|\bdw_kernel'


def read(ctx):
    t = ctx.trace
    if t is None:
        return None
    seconds, names = card.kernel_seconds(t, KERNELS)
    if not names:
        return None
    ls, rows, _, _ = ctx.counts('nerfactor_joint').chains(ctx.config)['lvis']
    ops, byt = ctx.counts('K1-bwd').cost(ls, rows, raw_in=6, out=1)
    bound, by = max((ops / BF16_PEAK, 'operations'),
                    (byt / HBM_BYTES_S, 'bytes'))
    steps = t['units']['steps']
    return {'value': 100.0 * bound * steps / seconds, 'bound_by': by,
            'power': t['power']}
