"""Train and eval steps and the optimizer (counterpart of
nerfactor_tpu/parallel/train.py): on one device, or data parallel over
the ranks of a process group (parallel/mesh.py), each on its part of the
global batch.

The optimizer is the JAX package's TF-exact Adam(amsgrad) with the same
state layout: ``(count, m, v, vhat)`` inside a 1-tuple, the leaves
``optax.chain`` flattens to, so a checkpoint's ``opt_state`` moves between
the packages unchanged. Parameters and optimizer state are trees of
dicts and lists with tensor leaves (utils/ckpt.py).
"""

import time
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from nerfactor_tpu_torch.ops import kernel_lib
from nerfactor_tpu_torch.parallel import mesh
from nerfactor_tpu_torch.utils.ckpt import tree_leaves, tree_map


class TfAdamState(NamedTuple):
    count: torch.Tensor  # int32 scalar: steps taken
    m: object
    v: object
    vhat: object


class Optimizer:
    """A chain of gradient transforms ending in Adam, as ``optax.chain``:
    ``init(params)`` gives the state, ``update(grads, state)`` the
    parameter steps and the next state."""

    def __init__(self, clip, schedule, b1=0.9, b2=0.999, eps=1e-7):
        self.clip = clip
        self.schedule = schedule
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params):
        def zeros():
            return tree_map(torch.zeros_like, params)
        leaves = tree_leaves(params)
        device = leaves[0].device if leaves else None
        return (TfAdamState(count=torch.zeros([], dtype=torch.int32,
                                              device=device),
                            m=zeros(), v=zeros(), vhat=zeros()),)

    def lr_t(self, count):
        """lr * sqrt(1 - b2^t) / (1 - b1^t) at t = count + 1, in f32 on the
        device of ``count`` (the int32 step count, a tensor), as the JAX
        package's jitted update computes it (the schedule reads the
        pre-increment count). Nothing is read back to the host, so a CUDA
        graph can hold it."""
        t = (count + 1).to(torch.float32)
        return self.schedule(count) * torch.sqrt(
            1.0 - torch.pow(self.b2, t)) / (1.0 - torch.pow(self.b1, t))

    def update(self, grads, state):
        """tf.keras.optimizers.Adam(amsgrad=True) with TF's semantics,
        as the JAX package's ``_tf_adam_amsgrad``:

            m_t    = b1 m + (1 - b1) g
            v_t    = b2 v + (1 - b2) g^2
            vhat_t = max(vhat, v_t)
            step   = -lr_t m_t / (sqrt(vhat_t) + eps)

        eps goes to the BIASED sqrt(vhat), the bias corrections into lr_t.
        (torch.optim.Adam(amsgrad=True) puts eps on the corrected
        denominator: ~9 dB of joint-stage PSNR, QUALITY.md.) The state's
        tensors, the step count too, are updated in place on their device,
        and nothing is read back to the host; returns (steps, state)."""
        (adam,) = state
        if self.clip is not None:
            grads = tree_map(self.clip, grads)
        lr_t = self.lr_t(adam.count)
        b1, b2 = self.b1, self.b2
        steps = []
        for g, m, v, vh in zip(tree_leaves(grads), tree_leaves(adam.m),
                               tree_leaves(adam.v), tree_leaves(adam.vhat)):
            m.mul_(b1).add_(g * (1.0 - b1))
            v.mul_(b2).add_(torch.square(g) * (1.0 - b2))
            torch.maximum(vh, v, out=vh)
            steps.append(-lr_t * m / (torch.sqrt(vh) + self.eps))
        adam.count.add_(1)
        return steps, state


def clip_by_per_leaf_norm(max_norm):
    """Keras 'clipnorm': each gradient tensor clipped to L2 norm
    ``max_norm`` (not a global norm)."""
    def clip(g):
        norm = torch.sqrt(torch.sum(torch.square(g)))
        return g * torch.clamp(max_norm / torch.clamp(norm, min=1e-12),
                               max=1.0)
    return clip


def clip_by_value(max_delta):
    def clip(g):
        return torch.clamp(g, -max_delta, max_delta)
    return clip


def exponential_decay(init_value, transition_steps, decay_rate):
    """optax.exponential_decay with staircase=False, of an int32 count
    tensor, in f32 on its device: init_value * decay_rate^(count / steps),
    init_value at counts <= 0."""
    def schedule(count):
        p = count.to(torch.float32) / torch.full_like(
            count, transition_steps, dtype=torch.float32)
        return torch.where(count <= 0, torch.full_like(p, init_value),
                           init_value * torch.pow(decay_rate, p))
    return schedule


def build_optimizer(config):
    """Adam(amsgrad) + exponential lr decay + optional gradient clipping,
    reference trainvali.py:109-127."""
    lr = config.getfloat('lr')
    lr_decay_steps = config.getint('lr_decay_steps', fallback=-1)
    if lr_decay_steps and lr_decay_steps > 0:
        schedule = exponential_decay(lr, lr_decay_steps,
                                     config.getfloat('lr_decay_rate'))
    else:
        lr32 = float(np.float32(lr))

        def schedule(_):
            return lr32
    clipnorm = config.getfloat('clipnorm', fallback=-1.0)
    clipvalue = config.getfloat('clipvalue', fallback=-1.0)
    if clipnorm > 0 and clipvalue > 0:
        raise ValueError(
            "Both `clipnorm` and `clipvalue` are active -- turn one off")
    clip = None
    if clipnorm > 0:
        clip = clip_by_per_leaf_norm(clipnorm)
    elif clipvalue > 0:
        clip = clip_by_value(clipvalue)
    return Optimizer(clip, schedule,
                     eps=config.getfloat('adam_eps', fallback=1e-7))


def upcast_batch(arrays):
    """float16/bfloat16 transfer dtypes (e.g. the lvis targets) -> f32."""
    return {k: v.float() if v.dtype in (torch.float16, torch.bfloat16)
            else v for k, v in arrays.items()}


def _check_needs_dw_invariant(model, trainable_mask):
    """The needs_dw=False chains of the model's training forward are right
    only because trainable_mask freezes the same parameter subtrees."""
    keys = getattr(model, 'needs_dw_false_keys', frozenset)()
    if not keys:
        return
    if trainable_mask is None:
        raise ValueError(
            "%s declares needs_dw=False chains for %s but no trainable_mask "
            "was passed to the train step -- their weight gradients would "
            "be silently dropped. Pass trainable_mask=model.trainable_mask("
            "params)." % (type(model).__name__, sorted(keys)))
    for k in sorted(keys):
        if k in trainable_mask and any(tree_leaves(trainable_mask[k])):
            raise ValueError(
                "Param subtree '%s' is flagged needs_dw=False in %s's "
                "forward but is trainable per trainable_mask -- it would "
                "train on zero weight gradients." % (k, type(model).__name__))


def _make_step(model, optimizer, trainable_mask, group):
    """One SGD step, ``step(params, opt_state, arrays, generator, draws) ->
    (params, opt_state, loss)``, which :func:`make_train_step` and
    :func:`make_train_step_scan` share; ``draws`` is None or the
    keyword arguments of the model's draws (``jitter_noise``, or NeRF's
    ``t_rand_coarse``, ``sigma_noise``, ``u_fine``) for this rank's rows.
    Its work is all on the parameters' device, read nothing back to the
    host and copies nothing from it, so a CUDA graph can capture it."""
    _check_needs_dw_invariant(model, trainable_mask)

    def step(params, opt_state, arrays, generator, draws):
        arrays = upcast_batch(arrays)
        leaves = tree_leaves(params)
        mask = tree_leaves(trainable_mask) if trainable_mask is not None \
            else [True] * len(leaves)
        live = tree_map(lambda t: t.detach(), params)
        live_leaves = tree_leaves(live)
        wrt = [t.requires_grad_() for t, m in zip(live_leaves, mask) if m]
        if draws is None:
            draws = {'jitter_noise': None}
            if group is not None:
                world, rank = dist.get_world_size(group), \
                    dist.get_rank(group)
                draws.update(mesh.shard_batch(
                    model.train_draws(generator, arrays, world), rank,
                    world))
        with torch.enable_grad():
            pred, gt, loss_kwargs, _ = model.apply(
                live, arrays, mode='train', generator=generator, **draws)
            loss = torch.mean(model.compute_loss(live, pred, gt,
                                                 **loss_kwargs))
            got = list(torch.autograd.grad(loss, wrt, allow_unused=True))
        if group is not None:
            got = [torch.zeros_like(t) if g is None else g
                   for t, g in zip(wrt, got)]
            *got, loss = mesh.all_mean(got + [loss.detach()], group)
        got = iter(got)
        grads = []
        for t, m in zip(leaves, mask):
            g = next(got) if m else None
            grads.append(torch.zeros_like(t) if g is None else g)
        with torch.no_grad():
            steps, opt_state = optimizer.update(grads, opt_state)
            for p, s in zip(leaves, steps):
                p.add_(s)
        return params, opt_state, loss.detach()

    return step


def make_train_step(model, optimizer, trainable_mask=None, group=None):
    """Returns ``train_step(params, opt_state, arrays, generator=None,
    jitter_noise=None) -> (params, opt_state, loss)``: the loss and its
    gradients, zero gradients for the leaves ``trainable_mask`` freezes,
    and the optimizer update. ``generator`` draws the jitter noise (or
    ``jitter_noise`` gives it); a model with ``xyz_jitter_std > 0`` needs
    one of the two.

    Parameters and optimizer state are updated in place under
    torch.no_grad() (the JAX package donates both buffers to the jitted
    step); the returned trees are the ones passed in. Gradients are
    taken only for trainable leaves: the frozen ones would be zeroed
    anyway, so their backward work is skipped.

    With a process ``group`` (parallel/mesh.py), ``arrays`` is this
    rank's part of the global batch, the ranks in order. Each rank draws
    the global batch's random draws (``model.train_draws``) from its
    ``generator``, seeded alike on every rank, and keeps its own rows, as
    each device holds its rows of the draws of the JAX package's key; a
    ``jitter_noise`` given is this rank's rows already. The trainable
    gradients and the loss are averaged over the ranks in one all-reduce
    before the optimizer, whose per-leaf clipping (Keras ``clipnorm``)
    then sees the global gradient; the loss returned is the global
    batch's mean. Without a group, nothing of this runs."""
    step = _make_step(model, optimizer, trainable_mask, group)

    def train_step(params, opt_state, arrays, generator=None,
                   jitter_noise=None):
        draws = None if jitter_noise is None \
            else {'jitter_noise': jitter_noise}
        return step(params, opt_state, arrays, generator, draws)

    return train_step


def make_train_step_scan(model, optimizer, trainable_mask=None, n_steps=8,
                         group=None):
    """Device-side training loop (the JAX package's lax.scan dispatch):
    returns ``train_steps(params, opt_state, stacked_arrays,
    generator=None, draws=None) -> (params, opt_state, losses)``, which
    takes ``n_steps`` steps of :func:`make_train_step`, step i on
    ``{k: v[i]}`` of ``stacked_arrays`` (leading axis ``n_steps``), and
    returns the per-step losses ``(n_steps,)``. ``draws``, if given, holds
    each step's draws stacked the same way (``{'jitter_noise': (n_steps,
    N, 3)}``, or NeRF's three), so that a caller can replay another
    program's; else ``generator`` draws them, as in one step.

    On CPU parameters that is the plain loop of :func:`make_train_step`,
    the oracle. On CUDA parameters it is one CUDA graph of the ``n_steps``
    steps, one launch a call:

      * the first call runs its steps eagerly, on the stream the graph is
        then captured on, which fills every cache the steps read (the
        kernel library, its plan queries, NCCL's communicator); the second
        call captures the graph (capture runs nothing), then replays it;
        every later call replays it. No step runs twice, none is lost;
      * parameters and optimizer state keep their storage, which the
        graph updates in place; each call copies ``stacked_arrays`` (and
        ``draws``) once into static device buffers (a non-blocking copy
        from pinned host memory) and the losses come out of a static
        ``(n_steps,)`` buffer, cloned;
      * ``generator`` is registered with the graph, so each replay draws
        what the eager loop would have drawn from its state, and advances
        it as far;
      * the capture mode is thread-local: a thread that pins host memory
        meanwhile (trainvali's prefetch) does not break it.

    A later call must pass the same parameter and optimizer trees (the
    same storage), the same generator and batches of the same shapes:
    anything else raises. So does a failed capture or replay: nothing
    falls back to the eager loop. The process ``group`` of
    :func:`make_train_step` is captured with its all-reduce under NCCL; a
    gloo group on CUDA tensors raises, since gloo reduces through host
    copies, which a graph cannot hold. ``train_steps.captured`` holds,
    once captured, the capture's seconds and the bytes its memory pool
    reserved. The kernels' launch counters count what the card runs: the
    capture, which launches nothing, gives back what it counted, and each
    replay adds those launches."""
    step = _make_step(model, optimizer, trainable_mask, group)
    state = {}

    def loop(params, opt_state, stacked, generator, draws):
        losses = []
        for i in range(n_steps):
            params, opt_state, loss = step(
                params, opt_state, {k: v[i] for k, v in stacked.items()},
                generator, None if draws is None
                else {k: v[i] for k, v in draws.items()})
            losses.append(loss)
        return params, opt_state, torch.stack(losses)

    def train_steps(params, opt_state, stacked_arrays, generator=None,
                    draws=None):
        leaves = tree_leaves(params)
        device = leaves[0].device
        for k, v in dict(stacked_arrays, **(draws or {})).items():
            if v.shape[0] != n_steps:
                raise ValueError("%s: leading axis %d, not n_steps = %d"
                                 % (k, v.shape[0], n_steps))
        if device.type != 'cuda':
            return loop(params, opt_state,
                        {k: v.to(device) for k, v in stacked_arrays.items()},
                        generator, None if draws is None
                        else {k: v.to(device) for k, v in draws.items()})
        if group is not None and dist.get_backend(group) != 'nccl':
            raise ValueError(
                "make_train_step_scan on CUDA tensors with a %s process "
                "group: %s reduces through host copies, which a CUDA graph "
                "cannot hold; use NCCL, or scan_steps = 1"
                % (dist.get_backend(group), dist.get_backend(group)))
        runner = state.get('runner')
        if runner is None:
            runner = state['runner'] = _GraphSteps(
                loop, n_steps, params, opt_state, stacked_arrays, generator,
                draws, device)
            return runner.warm_up(params, opt_state)
        out = runner(params, opt_state, stacked_arrays, generator, draws)
        train_steps.captured = runner.captured
        return out

    train_steps.captured = None
    return train_steps


class _GraphSteps:
    """:func:`make_train_step_scan`'s CUDA graph of ``loop`` over the
    static batch buffers: built on the first call, which runs eagerly
    (:meth:`warm_up`), captured on the second and replayed from then on."""

    def __init__(self, loop, n_steps, params, opt_state, stacked, generator,
                 draws, device):
        # A leaf off the card (an optimizer count on the host, say) would
        # be baked into the graph as a constant, its update not captured
        off = [t.device for t in tree_leaves((params, opt_state))
               if t.device != device]
        if off:
            raise ValueError("train_steps: the graph updates parameters and "
                             "optimizer state on %s, but leaves lie on %s"
                             % (device, sorted(set(map(str, off)))))
        self.loop, self.n_steps, self.device = loop, n_steps, device
        self.generator = generator
        self.leaves = [t.data_ptr() for t in tree_leaves((params,
                                                          opt_state))]
        self.stacked = {k: torch.empty(v.shape, dtype=v.dtype, device=device)
                        for k, v in stacked.items()}
        self.draws = None if draws is None else {
            k: torch.empty(v.shape, dtype=v.dtype, device=device)
            for k, v in draws.items()}
        self.losses = torch.empty(n_steps, device=device)
        self.stream = torch.cuda.Stream(device)
        self.graph = None
        self.captured = None
        self.launches = {}
        self.fill(stacked, draws)

    def fill(self, stacked, draws):
        """Copies one group's batches (and draws) into the static
        buffers, on the current stream."""
        for k, v in stacked.items():
            self.stacked[k].copy_(v, non_blocking=True)
        if draws is not None:
            for k, v in draws.items():
                self.draws[k].copy_(v, non_blocking=True)

    def check(self, params, opt_state, stacked, generator, draws):
        if [t.data_ptr() for t in tree_leaves((params, opt_state))] \
                != self.leaves:
            raise ValueError("train_steps: the graph updates the parameters "
                             "and optimizer state it was built on; pass "
                             "those trees")
        if generator is not self.generator:
            raise ValueError("train_steps: the graph draws from the "
                             "generator it was built with; pass that one")
        for name, got, want in (('stacked_arrays', stacked, self.stacked),
                                ('draws', draws, self.draws)):
            if (got is None) != (want is None) or got is not None and (
                    sorted(got) != sorted(want) or any(
                        tuple(got[k].shape) != tuple(want[k].shape)
                        or got[k].dtype != want[k].dtype for k in got)):
                raise ValueError("train_steps: %s differ from those the "
                                 "graph was built on" % name)

    def warm_up(self, params, opt_state):
        """The first group's steps, eagerly, on the stream the graph is
        then captured on, ordered after the current stream's work and
        before its later work."""
        current = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            params, opt_state, losses = self.loop(
                params, opt_state, self.stacked, self.generator, self.draws)
            self.losses.copy_(losses)
        current.wait_stream(self.stream)
        return params, opt_state, self.losses.clone()

    def capture(self, params, opt_state):
        torch.cuda.synchronize(self.device)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(self.device)
        before = kernel_lib.launch_counts()
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        if self.generator is not None:
            graph.register_generator_state(self.generator)
        with torch.cuda.graph(graph, stream=self.stream,
                              capture_error_mode='thread_local'):
            _, _, losses = self.loop(params, opt_state, self.stacked,
                                     self.generator, self.draws)
            self.losses.copy_(losses)
        del losses
        torch.cuda.synchronize(self.device)
        self.captured = {
            'seconds': time.perf_counter() - t0,
            'pool_bytes': torch.cuda.memory_reserved(self.device) - reserved}
        # The wrappers counted their launches as the capture recorded
        # them; the card runs those at each replay
        self.launches = {k: n - before.get(k, 0)
                         for k, n in kernel_lib.launch_counts().items()
                         if n != before.get(k, 0)}
        kernel_lib.add_launches({k: -n for k, n in self.launches.items()})
        self.graph = graph

    def __call__(self, params, opt_state, stacked, generator, draws):
        self.check(params, opt_state, stacked, generator, draws)
        self.fill(stacked, draws)
        if self.graph is None:
            self.capture(params, opt_state)
        self.graph.replay()
        kernel_lib.add_launches(self.launches)
        return params, opt_state, self.losses.clone()


def make_eval_step(model, mode='vali'):
    """Returns ``eval_step(params, arrays) -> (loss, to_vis)``."""

    def eval_step(params, arrays):
        arrays = upcast_batch(arrays)
        with torch.no_grad():
            pred, gt, loss_kwargs, to_vis = model.apply(params, arrays,
                                                        mode=mode)
            loss = torch.mean(model.compute_loss(params, pred, gt,
                                                 **loss_kwargs))
        return loss, to_vis

    return eval_step
