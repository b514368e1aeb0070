"""Kernels (``ops/fused_nerf.py`` -> ``csrc/fused_nerf.cu``): K3-bwd on
NeRF's coarse and fine samples (bf16 on the tensor cores: its first phase
and its dW pass), as a share of its roofline: the larger of its
operations over the bf16 peak and its bytes over the HBM bandwidth
(``counts/K3-bwd.py``), over its device time in the profiler window."""

from perfbench import card
from perfbench.harness import BF16_PEAK, HBM_BYTES_S

KERNELS = r'nerf_bwd_tc_kernel|\bdw_kernel'


def read(ctx):
    t = ctx.trace
    if t is None:
        return None
    seconds, names = card.kernel_seconds(t, KERNELS)
    if not names:
        return None
    k3 = ctx.counts('K3-bwd')
    v = ctx.config['values']
    ops = byt = 0
    for rows in ctx.counts('nerf').train_rows(v):
        o, b = k3.cost(v, rows)
        ops, byt = ops + o, byt + b
    bound, by = max((ops / BF16_PEAK, 'operations'),
                    (byt / HBM_BYTES_S, 'bytes'))
    steps = t['units']['steps']
    return {'value': 100.0 * bound * steps / seconds, 'bound_by': by,
            'power': t['power']}
