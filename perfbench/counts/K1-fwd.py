"""Kernel K1-fwd (``ops/fused_mlp.py`` -> ``csrc/fused_mlp.cu``): one
embed -> skip-MLP -> head chain's forward over ``rows`` rows."""

from perfbench.counts import chain


def cost(ls, rows, raw_in, out, weight_bytes=2):
    """(operations, bytes): the products; the raw input read and the
    output written once (f32), the weights once in the kernel's type."""
    return (chain.fwd(ls, rows),
            4 * rows * (raw_in + out) + weight_bytes * chain.weights(ls))
