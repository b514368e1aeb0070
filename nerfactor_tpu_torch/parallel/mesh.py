"""Data-parallel training over rays with torch.distributed (counterpart of
nerfactor_tpu/parallel/mesh.py).

As in the JAX package, the only parallelism is data parallelism over
rays: each batch is split on its leading (ray) axis, the parameters and
the optimizer state are replicated, and the models (MLPs 128-256 wide)
get no tensor or pipeline parallelism. A torch process drives one
device, so the JAX package's 1-D 'data' mesh is the default process
group, one rank a device. Each rank feeds its local batch, so the global
batch is world x n_rays_per_step (JAX's ``--multihost``); the train step
(parallel/train.py) sums every rank's gradients and loss in one
all-reduce and divides by world, the global batch's mean, as the psum
that XLA inserts.

  device = mesh.initialize()              # torchrun's environment, or
  device = mesh.initialize('host:port', num_processes=2, process_id=0)
  ...
  mesh.shutdown()

Outside ``initialize`` there is no group: ``rank()`` is 0, ``world()``
1, ``group()`` None, and ``barrier()`` returns at once.
"""

import faulthandler
import os
import sys
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

from nerfactor_tpu_torch.utils.ckpt import tree_leaves

# jax.distributed.initialize's default initialization_timeout
INIT_TIMEOUT_S = 300
# How long past the timeout a rank stuck in the rendezvous lives on
JOIN_GRACE_S = 5


def initialize(coordinator=None, num_processes=None, process_id=None,
               device='cuda', backend=None, timeout_s=INIT_TIMEOUT_S):
    """Joins the process group and returns this rank's device.

    With ``coordinator`` ('host:port' of rank 0, or an init URL such as
    'file:///shared/path'), ``num_processes`` and ``process_id`` given,
    those; otherwise torchrun's environment (RANK, WORLD_SIZE,
    MASTER_ADDR, MASTER_PORT). A CUDA rank drives ``cuda:LOCAL_RANK``
    (without LOCAL_RANK, its rank modulo the visible cards). The backend
    is NCCL for a CUDA device and gloo for the CPU unless ``backend``
    says otherwise (gloo reduces CUDA tensors too: two ranks on one card,
    which NCCL refuses). ``timeout_s`` bounds the rendezvous and every
    collective: a rank that cannot join raises, and one whose coordinator
    takes the connection and never answers (the store's handshake has no
    timeout) ends its process with exit code 1 and every thread's
    traceback JOIN_GRACE_S later."""
    device = torch.device(device)
    explicit = (coordinator, num_processes, process_id)
    if any(x is not None for x in explicit):
        if any(x is None for x in explicit):
            raise ValueError("--coordinator, --num_processes and "
                             "--process_id go together")
        init_method = coordinator if '://' in coordinator \
            else 'tcp://' + coordinator
        world_size, rank_ = num_processes, process_id
    else:
        for k in ('RANK', 'WORLD_SIZE', 'MASTER_ADDR', 'MASTER_PORT'):
            if k not in os.environ:
                raise ValueError(
                    "%s is not set: launch with torchrun, or give "
                    "--coordinator, --num_processes and --process_id" % k)
        init_method = 'env://'
        world_size, rank_ = int(os.environ['WORLD_SIZE']), \
            int(os.environ['RANK'])
    if device.type == 'cuda':
        if not torch.cuda.is_available():
            raise RuntimeError("--multihost on CUDA: no CUDA device")
        local = int(os.environ.get('LOCAL_RANK',
                                   rank_ % torch.cuda.device_count()))
        device = torch.device('cuda', local)
        torch.cuda.set_device(device)
    if backend is None:
        backend = 'nccl' if device.type == 'cuda' else 'gloo'
    if backend == 'nccl' and not dist.is_nccl_available():
        raise RuntimeError("--multihost on CUDA needs NCCL, which this "
                           "PyTorch build lacks")
    faulthandler.dump_traceback_later(timeout_s + JOIN_GRACE_S, exit=True,
                                      file=sys.__stderr__)
    try:
        dist.init_process_group(backend, init_method=init_method,
                                world_size=world_size, rank=rank_,
                                timeout=timedelta(seconds=timeout_s))
    finally:
        faulthandler.cancel_dump_traceback_later()
    return device


def group():
    """The default process group, or None outside ``initialize``."""
    return dist.group.WORLD if dist.is_initialized() else None


def rank():
    return dist.get_rank() if dist.is_initialized() else 0


def world():
    return dist.get_world_size() if dist.is_initialized() else 1


def is_lead():
    return rank() == 0


def barrier():
    if not dist.is_initialized():
        return
    if dist.get_backend() == 'nccl':
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def shutdown():
    if dist.is_initialized():
        dist.destroy_process_group()


def shard_batch(arrays, rank_, world_):
    """Rank ``rank_``'s part of one global batch (a dict of arrays or
    tensors), the JAX package's rule (``pick``): a leading axis that
    ``world_`` divides is split into equal parts in rank order; any
    other leaf (a scalar, an indivisible axis) is kept whole."""
    def pick(x):
        n = np.shape(x)[0] if np.ndim(x) else 0
        if n == 0 or n % world_:
            return x
        part = n // world_
        return x[rank_ * part:(rank_ + 1) * part]
    return {k: pick(v) for k, v in arrays.items()}


def _comm_device(tensor, group_):
    """Where a collective over ``tensor`` runs: the rank's card under
    NCCL (which takes no CPU tensor), else where the tensor is."""
    if dist.get_backend(group_) == 'nccl':
        return torch.device('cuda', torch.cuda.current_device())
    return tensor.device


def replicate(tree, group_=None):
    """Rank 0's values into every leaf of ``tree`` (parameters, optimizer
    state) on every rank, in place; one broadcast per dtype and device.
    Returns ``tree``. Without a group, ``tree`` as it is."""
    if not dist.is_initialized():
        return tree
    buckets = {}
    for t in tree_leaves(tree):
        buckets.setdefault((t.dtype, t.device), []).append(t)
    with torch.no_grad():
        for leaves in buckets.values():
            flat = torch.cat([t.reshape(-1) for t in leaves]).to(
                _comm_device(leaves[0], group_))
            dist.broadcast(flat, src=0, group=group_)
            at = 0
            for t in leaves:
                t.copy_(flat[at:at + t.numel()].view(t.shape))
                at += t.numel()
    return tree


def all_mean(tensors, group_=None):
    """The mean over the ranks of each of ``tensors`` (float32; the
    trainable gradients and the loss), through one all-reduce of one
    flat buffer. Returns new tensors shaped as the inputs."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    if flat.dtype != torch.float32:
        raise TypeError("all_mean reduces float32, got %s" % flat.dtype)
    device = flat.device
    flat = flat.to(_comm_device(flat, group_))
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group_)
    flat = flat.div_(dist.get_world_size(group_)).to(device)
    out, at = [], 0
    for t in tensors:
        out.append(flat[at:at + t.numel()].view(t.shape))
        at += t.numel()
    return out
