"""Kernel K3-bwd (``ops/fused_nerf.py`` -> ``csrc/fused_nerf.cu``): the
NeRF field's backward (trunk, sigma head, bottleneck, view-dependent rgb
head) over ``rows`` samples, from the points, the view directions, the
outputs' cotangents and the weights, with the weights' gradients and
without the points' cotangents. The forward it recomputes is part of
the work the call needs."""

from perfbench.counts import chain


def field_layers(v):
    """The field's products as chain layers: the trunk, then the sigma
    head and the bottleneck over its output, then the rgb head over the
    bottleneck and the view embedding (whose cotangent is not needed)."""
    xyz = 3 * (1 + 2 * v['n_freqs_xyz'])
    view = 3 * (1 + 2 * v['n_freqs_view'])
    w, d = v['mlp_width'], v['enc_depth']
    trunk = chain.layers(xyz, [w] * d, {v['enc_skip_at']})
    return trunk + [(w, 1, w), (w, w, w), (w + view, w // 2, w),
                    (w // 2, 3, w // 2)]


def cost(v, rows, weight_bytes=2):
    ls = field_layers(v)
    ops = chain.fwd(ls, rows) + chain.dw(ls, rows) + chain.dx(ls, rows)
    byt = 4 * rows * (3 + 3 + 4) + (weight_bytes + 4) * chain.weights(ls)
    return ops, byt
