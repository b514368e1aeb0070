"""Parameter trees: the benchmark's seeded weights, made on the device in
one draw, and the tree helpers (the program's layout: dicts and lists
with tensor leaves, leaves in sorted-key order, as the JAX package
flattens them).

A layout leaf is ``(shape, init)`` with init ``'glorot'`` (uniform in
+-sqrt(6 / (fan_in + fan_out))), ``'zeros'``, ``('uniform', hi)`` or
``('normal', std)``.
"""

import math

import torch


def leaves(tree):
    """Leaves of a dict/list tree, dict keys sorted."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)) and not _is_leaf_spec(tree):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not _is_leaf_spec(tree):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def _is_leaf_spec(x):
    return isinstance(x, tuple) and len(x) == 2 and isinstance(x[0], tuple)


def make(layout, seed, device):
    """The tree of ``layout`` filled from ``seed``: one uniform and one
    normal draw on ``device`` (a generator there), sliced into the
    leaves; f32, as the program keeps its weights."""
    specs = leaves(layout)
    n_uniform = sum(math.prod(s) for s, init in specs if init != 'zeros'
                    and not (isinstance(init, tuple) and init[0] == 'normal'))
    n_normal = sum(math.prod(s) for s, init in specs
                   if isinstance(init, tuple) and init[0] == 'normal')
    gen = torch.Generator(device=device).manual_seed(seed)
    uni = torch.rand(n_uniform, generator=gen, device=device)
    nrm = torch.randn(n_normal, generator=gen, device=device)
    at = {'u': 0, 'n': 0}

    def take(pool, key, shape):
        n = math.prod(shape)
        out = pool[at[key]:at[key] + n].reshape(shape)
        at[key] += n
        return out

    def fill(spec):
        shape, init = spec
        if init == 'zeros':
            return torch.zeros(shape, device=device)
        if init == 'glorot':
            limit = math.sqrt(6.0 / (shape[0] + shape[1]))
            return (take(uni, 'u', shape) * 2.0 - 1.0) * limit
        kind, scale = init
        if kind == 'uniform':
            return take(uni, 'u', shape) * scale
        return take(nrm, 'n', shape) * scale

    return tree_map(fill, layout)
