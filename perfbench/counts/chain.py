"""The arithmetic that the kernels' and model steps' counts share: a
skip-MLP's layers and the operations of its forward and backward
products, worked out from shapes. Only the products are counted (2
operations a multiply-add); the embeddings' sines and cosines, the
activations and the renderers' sums are not."""


def layers(in_dim, widths, skip_at=()):
    """[(fan_in, fan_out, fan_in from the previous layer)] of a
    skip-MLP: after layer i in ``skip_at`` the input is concatenated onto
    that layer's activation."""
    out, din, hid = [], in_dim, 0
    for i, w in enumerate(widths):
        out.append((din, w, hid))
        din = w + (in_dim if i in skip_at else 0)
        hid = w
    return out


def fwd(ls, rows):
    return 2 * rows * sum(din * dout for din, dout, _ in ls)


def dw(ls, rows):
    return 2 * rows * sum(din * dout for din, dout, _ in ls)


def dx(ls, rows, to_input=False):
    """The input cotangents' products: each layer's cotangent of what
    the previous layer made; with ``to_input`` also of the input."""
    return 2 * rows * sum((din if to_input else hid) * dout
                          for din, dout, hid in ls)


def weights(ls):
    return sum(din * dout + dout for din, dout, _ in ls)
