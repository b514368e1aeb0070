"""Pass rate of chained 128 x 128 bf16 products on the card's tensor
cores (counterpart of tools/mosaic_dot_probe.py).

Kernel P (``ops/dot_probe.py``, ``csrc/dot_probe.cu``: the warpgroup
product ``wgmma``) runs D passes over a (cols, width) operand in three
dependency structures:

  serial:  y = bf16(y W_i^T)   (each pass needs the previous one: the
                                 chains' layer after layer)
  indep:   acc += y W_i^T      (same pass count, no pass needs another)
  pair:    two half-depth serial chains interleaved (dependency
                                 distance 2)

The cost of a pass is the SLOPE of time against D at fixed (block, cols),
fitted by least squares: what does not grow with D (the launch, reading x
and writing the output once) lands in the intercept. If serial's slope
matches indep's, consecutive dependent passes cost no bubble; pair says
how much interleaving two chains recovers. ``--grid_sweep`` times the
serial chain at depth 8 while the rows a CUDA block owns (``--block``)
vary at fixed total rows: a per-block cost shows as rising time at small
blocks.

Launches are timed back to back with CUDA events (3 warm-up launches,
then ``--steps``); nothing is threaded back between them, as the card runs
them in order. ``--device cpu`` runs the plain version (any width) and
times it with the host clock: a check of the tool, not a measurement.

Usage:
    python -m nerfactor_tpu_torch.tools.dot_probe            # slope probe
    python -m nerfactor_tpu_torch.tools.dot_probe --grid_sweep
    python -m nerfactor_tpu_torch.tools.dot_probe --device cpu --cols 512 \\
        --width 32 --depths 2,4 --steps 2 --block 256
"""

import argparse
import json
import time

import numpy as np
import torch

from nerfactor_tpu_torch.ops import dot_probe as dp

SWEEP_BLOCKS = (512, 1024, 2048, 4096, 8192)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--block', type=int, default=4096,
                    help="rows a CUDA block owns (a multiple of 256)")
    ap.add_argument('--cols', type=int, default=1048576,
                    help="rows of the operand (~= the joint step's 1M rows); "
                         "the TPU probe's columns")
    ap.add_argument('--width', type=int, default=128,
                    help="operand width (the kernel takes 128)")
    ap.add_argument('--depths', default='12,16,24,32',
                    help="passes per launch, at least two values; each even "
                         "for pair")
    ap.add_argument('--steps', type=int, default=30)
    ap.add_argument('--grid_sweep', action='store_true',
                    help="serial at depth 8, --block in %s at fixed --cols"
                         % (SWEEP_BLOCKS,))
    ap.add_argument('--device', default='cuda',
                    help="cuda (kernel P) or cpu (the plain version)")
    return ap.parse_args(argv)


def make_weights(rng, depth, width, device):
    """Orthonormal weights (bf16) keep the activations bounded over depth."""
    ws = [np.linalg.qr(rng.randn(width, width))[0] for _ in range(depth)]
    return torch.as_tensor(np.stack(ws), dtype=torch.bfloat16, device=device)


def time_ms(run, steps, device):
    """Mean ms per call of ``run`` after 3 warm-up calls: CUDA events on
    the card, the host clock on the CPU."""
    for _ in range(3):
        run()
    if device.type == 'cuda':
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(steps):
            run()
        end.record()
        torch.cuda.synchronize(device)
        return start.elapsed_time(end) / steps
    t0 = time.perf_counter()
    for _ in range(steps):
        run()
    return (time.perf_counter() - t0) / steps * 1e3


def main(argv=None):
    """Runs the probe; prints one JSON line per timing and a summary line,
    and returns the summary."""
    return run(parse_args(argv))


def run(args, chain=dp.dot_chain):
    """The probe over ``chain`` (x, ws, mode, block=) -> out: kernel P's
    entry point for the command line; ``chip_smoke.py`` also passes the
    ``mma.sync`` control (``dot_probe._dot_chain_mma``) to read both
    designs in one run."""
    device = torch.device(args.device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError("dot_probe: no CUDA card (--device cpu runs the "
                           "plain version)")
    depths = [int(d) for d in args.depths.split(',')]
    if not args.grid_sweep:
        bad = [d for d in depths if d % 2]
        if bad:
            raise ValueError("pair interleaves two half-chains, so every "
                             "depth must be even (got %s)" % bad)
        if len(set(depths)) < 2:
            raise ValueError("the slope needs two depths or more")
    rng = np.random.RandomState(0)
    gen = torch.Generator(device=device).manual_seed(0)
    x = 0.1 * torch.randn((args.cols, args.width), generator=gen,
                          device=device)

    def time_one(mode, depth, block):
        ws = make_weights(rng, depth, args.width, device)
        return time_ms(lambda: chain(x, ws, mode, block=block),
                       args.steps, device)

    results = {}
    if args.grid_sweep:
        depth = 8
        for block in SWEEP_BLOCKS:
            ms = time_one('serial', depth, block)
            results['serial_d8_block%d' % block] = ms
            print(json.dumps({'mode': 'serial', 'depth': depth,
                              'block': block,
                              'grid': -(-args.cols // block), 'ms': ms,
                              'ms_per_pass': ms / depth}))
    else:
        for mode in dp.MODES:
            times = []
            for depth in depths:
                ms = time_one(mode, depth, args.block)
                times.append(ms)
                print(json.dumps({'mode': mode, 'depth': depth,
                                  'block': args.block, 'ms': ms}))
            # least-squares slope: ms per additional pass
            a = np.polyfit(depths, times, 1)
            results[mode] = {'ms_per_pass': float(a[0]),
                             'intercept_ms': float(a[1])}
            print(json.dumps({'mode': mode, **results[mode]}))
    print(json.dumps({'summary': results, 'device': str(device),
                      'cols': args.cols, 'width': args.width}))
    return results


if __name__ == '__main__':
    main()
