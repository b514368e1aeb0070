"""Kernel K1-bwd (``ops/fused_mlp.py`` -> ``csrc/fused_mlp.cu``): one
chain's backward over ``rows`` rows from its raw input, the output's
cotangent and the weights. The activations are not among its inputs, so
the forward it recomputes is part of the work the call needs."""

from perfbench.counts import chain


def cost(ls, rows, raw_in, out, needs_dx=False, needs_dw=True,
         weight_bytes=2):
    """(operations, bytes): the recomputed forward, the weights'
    gradients (``needs_dw``) and the cotangents (of the input too with
    ``needs_dx``); the raw input and the output's cotangent read once,
    the weights once in the kernel's type, the input's cotangent and the
    f32 weight gradients written once."""
    ops = chain.fwd(ls, rows) + chain.dx(ls, rows, to_input=needs_dx)
    byt = 4 * rows * (raw_in + out) + weight_bytes * chain.weights(ls)
    if needs_dw:
        ops += chain.dw(ls, rows)
        byt += 4 * chain.weights(ls)
    if needs_dx:
        byt += 4 * rows * raw_in
    return ops, byt
