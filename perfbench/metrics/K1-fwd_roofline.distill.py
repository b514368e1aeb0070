"""Kernels (``ops/fused_mlp.py`` -> ``csrc/fused_mlp.cu``): K1-fwd on the
march's bf16 sigma chain (coarse and fine samples) over one call, as a
share of its roofline: the larger of its operations over the bf16 peak
and its bytes over the HBM bandwidth (``counts/K1-fwd.py``), over its
device time in the profiler window."""

from perfbench import card
from perfbench.harness import BF16_PEAK, HBM_BYTES_S

KERNELS = r'chain_fwd_tc_kernel'


def read(ctx):
    t = ctx.trace
    if t is None:
        return None
    seconds, names = card.kernel_seconds(t, KERNELS)
    if not names:
        return None
    nerf = ctx.counts('nerf')
    v, tr = ctx.config['values'], ctx.traffic
    rays = tr['points_a_call'] * 2 * tr['light_h'] ** 2 * t['units']['calls']
    ops, byt = ctx.counts('K1-fwd').cost(nerf.sigma_layers(v),
                                         rays * sum(nerf.march_rows(v)),
                                         raw_in=3, out=1)
    bound, by = max((ops / BF16_PEAK, 'operations'),
                    (byt / HBM_BYTES_S, 'bytes'))
    return {'value': 100.0 * bound / seconds, 'bound_by': by,
            'power': t['power']}
