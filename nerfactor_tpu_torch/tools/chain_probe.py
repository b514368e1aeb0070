"""Isolated timing probe for one embed->MLP->head chain at lvis scale
(counterpart of tools/chain_probe.py).

Times JUST the chain at the joint step's dominant shape (524,288 rows x
the 128 x 4 lvis MLP, xyz and ldir posenc, a sigmoid head), each step
chained through the parameters as the JAX tool does:

  --impl ref             the plain version (chain_reference, autograd)
  --impl fused           K1-fwd / K1-bwd (_fused_chain, transposed=True)
  --impl fused_rowmajor  the stash route K1r-fwd / K1r-bwd
                         (_fused_chain, transposed=False)

``--mode fwd`` times the forward alone (no autograd, so K1r-fwd writes no
stash); ``--mode both`` the forward and the weights' gradient of a mean
square loss, plus the input cotangent with ``--needs_dx``.

Precision: the JAX tool's two flags map onto the chain's one
``compute_dtype``, on every impl: bf16 if ``--compute_dtype bf16`` or
``--matmul_dtype bf16`` (bf16 operands, f32 accumulation, as the joint
step's lvis chain ships), else f32; the JSON line reports that one
precision under both keys. (In the JAX tool ``--compute_dtype``
reached only the reference path and the fused kernels ran at their global
kernel dtype, bf16 unless the environment said otherwise.)

On the card the step ends in a synchronise and the host clock times
``--steps`` steps after 3 warm-up steps; ``--device cpu`` runs the plain
versions and checks the tool, it measures nothing of the card.

    python -m nerfactor_tpu_torch.tools.chain_probe --impl fused --mode both
    python -m nerfactor_tpu_torch.tools.chain_probe --impl ref --compute_dtype bf16
"""

import argparse
import json
import time

import numpy as np
import torch

from nerfactor_tpu_torch.ops import fused_mlp as fm


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--impl', choices=['ref', 'fused', 'fused_rowmajor'],
                    default='ref')
    ap.add_argument('--mode', choices=['fwd', 'both'], default='both')
    ap.add_argument('--rows', type=int, default=524288)
    ap.add_argument('--steps', type=int, default=20)
    ap.add_argument('--width', type=int, default=128)
    ap.add_argument('--depth', type=int, default=4)
    ap.add_argument('--compute_dtype', choices=['f32', 'bf16'],
                    default='f32', help="the chain's compute dtype (bf16: "
                    "bf16 operands, f32 accumulation)")
    ap.add_argument('--matmul_dtype', choices=['f32', 'bf16'],
                    default='f32', help="bf16 selects the same bf16 "
                    "compute dtype (the port has one precision switch)")
    ap.add_argument('--out_width', type=int, default=1,
                    help="head width (M of the final dot)")
    ap.add_argument('--fx', type=int, default=10,
                    help="posenc freqs for the xyz part")
    ap.add_argument('--fl', type=int, default=4,
                    help="posenc freqs for the ldir part")
    ap.add_argument('--needs_dx', action='store_true',
                    help="fused impls: also produce input cotangents")
    ap.add_argument('--device', default='cuda',
                    help="cuda (the kernels) or cpu (the plain versions)")
    return ap.parse_args(argv)


def main(argv=None):
    """Runs the probe; prints and returns its JSON record."""
    args = parse_args(argv)
    device = torch.device(args.device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError("chain_probe: no CUDA card (--device cpu runs the "
                           "plain versions)")
    precision = 'bf16' if 'bf16' in (args.compute_dtype,
                                     args.matmul_dtype) else 'f32'
    compute_dtype = torch.bfloat16 if precision == 'bf16' else None

    plan = fm.make_plan([(3, args.fx), (3, args.fl)],
                        (args.width,) * args.depth + (args.out_width,),
                        ('relu',) * args.depth + ('sigmoid',),
                        (args.depth // 2 - 1,))
    rng = np.random.RandomState(0)
    dims = fm.layer_in_dims(plan)
    params = [
        (torch.as_tensor(rng.randn(dims[i], w) * 0.1, dtype=torch.float32,
                         device=device),
         torch.as_tensor(rng.randn(w) * 0.01, dtype=torch.float32,
                         device=device))
        for i, w in enumerate(plan.widths)]
    x = torch.as_tensor(rng.randn(args.rows, fm.raw_dim(plan)),
                        dtype=torch.float32, device=device)

    def chain(x_, p_):
        if args.impl.startswith('fused'):
            return fm._fused_chain(plan, x_, p_, needs_dx=args.needs_dx,
                                   transposed=(args.impl == 'fused'),
                                   compute_dtype=compute_dtype)
        return fm.chain_reference(plan, x_, p_, compute_dtype=compute_dtype)

    if args.mode == 'fwd':
        @torch.no_grad()
        def step(p):
            y = chain(x, p)
            # Thread a scalar of the output back into the params
            s = 1e-12 * torch.mean(y)
            return [(w + s, b) for w, b in p]
    else:
        def step(p):
            leaves = [t.detach().requires_grad_() for pair in p for t in pair]
            loss = torch.mean(chain(x, fm._pairs(leaves)) ** 2)
            g = torch.autograd.grad(loss, leaves)
            with torch.no_grad():
                return fm._pairs([t - 1e-6 * gt for t, gt in zip(leaves, g)])

    def sync():
        if device.type == 'cuda':
            torch.cuda.synchronize(device)

    for _ in range(3):
        params = step(params)
    sync()
    t0 = time.perf_counter()
    for _ in range(args.steps):
        params = step(params)
    checksum = float(torch.sum(params[0][0]))
    dt = time.perf_counter() - t0
    record = {
        'impl': args.impl, 'mode': args.mode, 'rows': args.rows,
        'compute_dtype': precision, 'matmul_dtype': precision,
        'ms_per_step': 1e3 * dt / args.steps,
        'checksum': checksum, 'device': str(device)}
    print(json.dumps(record))
    return record


if __name__ == '__main__':
    main()
