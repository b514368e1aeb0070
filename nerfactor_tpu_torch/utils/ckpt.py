"""Checkpoints and the weight bridge to the JAX package (counterpart of
nerfactor_tpu/utils/ckpt.py).

A checkpoint is one ``ckpt-N.npz`` whose arrays ``leaf_%06d`` are the
leaves of a parameter tree in JAX flatten order: dict keys sorted, lists
and tuples in order (so each dense layer stores ``b`` before ``w``). The
port keeps its parameters in the same tree of dicts and lists, with torch
tensors as leaves, so a checkpoint written by either package loads in the
other. A training checkpoint holds {'opt_state', 'params'}; N counts
epochs.
"""

import os
import re

import numpy as np
import torch


def tree_leaves(tree):
    """Leaves of a dict/list/tuple tree in JAX flatten order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def _rebuild(seq, items):
    """A list, tuple or named tuple like ``seq`` holding ``items``."""
    if hasattr(seq, '_fields'):
        return type(seq)(*items)
    return type(seq)(items)


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return _rebuild(tree, [tree_map(fn, v) for v in tree])
    return fn(tree)


def tree_unflatten(template, leaves):
    """Rebuilds ``template``'s structure from ``leaves`` (flatten order)."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}
            return {k: built[k] for k in t}
        if isinstance(t, (list, tuple)):
            return _rebuild(t, [build(v) for v in t])
        return next(it)

    out = build(template)
    if next(it, None) is not None:
        raise ValueError("More leaves than the template holds")
    return out


def params_from_jax(tree, device='cpu'):
    """The JAX package's param pytree (NumPy or JAX arrays as leaves) ->
    the port's parameters: the same tree with float32 torch tensors."""
    return tree_map(lambda x: torch.as_tensor(
        np.array(x, np.float32), device=device), tree)


def params_to_jax(tree):
    """Inverse of :func:`params_from_jax`: the same tree, NumPy leaves."""
    return tree_map(lambda x: x.detach().cpu().numpy(), tree)


def _to_numpy(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def save_pytree(tree, path_prefix):
    """Writes ``<path_prefix>.npz`` with the tree's leaves in flatten
    order, as the JAX package's ``save_pytree``."""
    arrays = {'leaf_%06d' % i: _to_numpy(x)
              for i, x in enumerate(tree_leaves(tree))}
    os.makedirs(os.path.dirname(path_prefix), exist_ok=True)
    tmp = path_prefix + '.tmp.npz'
    with open(tmp, 'wb') as h:
        np.savez(h, **arrays)
    os.replace(tmp, path_prefix + '.npz')


def read_leaves(ckpt_path):
    """All arrays of a checkpoint, in leaf order."""
    path = ckpt_path if ckpt_path.endswith('.npz') else ckpt_path + '.npz'
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    with open(path, 'rb') as h:
        data = np.load(h)
        return [data['leaf_%06d' % i] for i in range(len(data.files))]


def restore_trained_params(ckpt_path, template_params, device='cpu'):
    """Restores the model parameters from a training checkpoint (which
    stores {'opt_state', 'params'}): flattened in sorted-key order, the
    params are the TRAILING leaves, so they are sliced from the tail and
    the optimizer state's layout never matters. Shapes must match the
    template's."""
    arrays = read_leaves(ckpt_path)
    leaves = tree_leaves(template_params)
    if len(arrays) < len(leaves):
        raise ValueError("Checkpoint has %d leaves but the params template "
                         "alone has %d" % (len(arrays), len(leaves)))
    tail = arrays[len(arrays) - len(leaves):]
    for i, (l, a) in enumerate(zip(leaves, tail)):
        if tuple(l.shape) != tuple(a.shape):
            raise ValueError(
                "Params leaf %d shape mismatch: template %s vs checkpoint %s"
                % (i, tuple(l.shape), a.shape))
    return tree_unflatten(template_params, [
        torch.as_tensor(np.array(a, np.float32), device=device)
        for a in tail])


def restore_pytree(template, path_prefix):
    """Loads a checkpoint written by :func:`save_pytree` into the
    structure of ``template``, each leaf on its template leaf's device;
    shapes must match, dtypes are the checkpoint's."""
    arrays = read_leaves(path_prefix)
    leaves = tree_leaves(template)
    if len(arrays) != len(leaves):
        raise ValueError("Checkpoint has %d leaves but the template has %d"
                         % (len(arrays), len(leaves)))
    for i, (l, a) in enumerate(zip(leaves, arrays)):
        if tuple(l.shape) != tuple(a.shape):
            raise ValueError("Leaf %d shape mismatch: template %s vs "
                             "checkpoint %s" % (i, tuple(l.shape), a.shape))
    return tree_unflatten(template, [
        torch.as_tensor(np.array(a), device=l.device)
        for l, a in zip(leaves, arrays)])


class CheckpointManager:
    """``<ckptdir>/ckpt-N.npz`` files, N counting epochs; ``max_to_keep``
    evicts the oldest (reference trainvali.py:134-146)."""

    def __init__(self, ckptdir, max_to_keep=None):
        self.ckptdir = ckptdir
        self.max_to_keep = max_to_keep
        os.makedirs(ckptdir, exist_ok=True)

    def _steps(self):
        steps = []
        for f in os.listdir(self.ckptdir):
            m = re.fullmatch(r'ckpt-(\d+)\.npz', f)
            if m:
                steps.append(int(m.group(1)))
        return sorted(steps)

    @property
    def latest_checkpoint(self):
        steps = self._steps()
        if not steps:
            return None
        return os.path.join(self.ckptdir, 'ckpt-%d' % steps[-1])

    def latest_step(self):
        steps = self._steps()
        return steps[-1] if steps else 0

    def save(self, step, tree):
        prefix = os.path.join(self.ckptdir, 'ckpt-%d' % step)
        save_pytree(tree, prefix)
        if self.max_to_keep is not None and self.max_to_keep > 0:
            for s in self._steps()[:-self.max_to_keep]:
                os.remove(os.path.join(self.ckptdir, 'ckpt-%d.npz' % s))
        return prefix

    def restore(self, template, step=None):
        prefix = self.latest_checkpoint if step is None else \
            os.path.join(self.ckptdir, 'ckpt-%d' % step)
        if prefix is None:
            return None
        return restore_pytree(template, prefix)
