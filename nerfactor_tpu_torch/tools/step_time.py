"""Train-step timer of the joint model or NeRF (counterpart of
tools/step_time.py) at bench.py's settings (tools/bench_model.py:
1024 rays x 512 lights, 128 x 4 MLPs; NeRF at nerf.ini's), with config
overrides.

On the card: ``--warmup`` steps, then ``--steps`` steps chained through
the parameters, timed by CUDA events around the run (the host's launch
work included, as training pays it). One JSON line: ms per step, rays per
second, each kernel's launches a step, the last loss, the card's name and
power limit. ``--device cpu`` runs the plain versions as a check of the
tool: its time is the host's (``clock``), not the card's. The JAX tool's
``--scan`` (a lax.scan dispatch) has no counterpart: the port dispatches
every step.

    python -m nerfactor_tpu_torch.tools.step_time
    python -m nerfactor_tpu_torch.tools.step_time --model nerf --steps 30
    python -m nerfactor_tpu_torch.tools.step_time \\
        --override bf16_big_chains=False
"""

import argparse
import json
import time

import torch

from nerfactor_tpu_torch.tools import bench_model
from nerfactor_tpu_torch.utils import card


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--override', default='',
                    help="comma-separated config overrides")
    ap.add_argument('--model', default='nerfactor',
                    choices=['nerfactor', 'nerf'])
    ap.add_argument('--rays', type=int, default=1024)
    ap.add_argument('--light_h', type=int, default=16)
    ap.add_argument('--steps', type=int, default=20)
    ap.add_argument('--warmup', type=int, default=3)
    ap.add_argument('--device', default='cuda',
                    help="cuda (the kernels) or cpu (the plain versions)")
    return ap.parse_args(argv)


def setup(args):
    """(device, the card's line or None, model, step runner)."""
    device = torch.device(args.device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError("no CUDA card (--device cpu runs the plain "
                           "versions)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gpu = card.name_and_power() if device.type == 'cuda' else None
    model, params, batch = bench_model.make(
        args.model, device, n_rays=args.rays, light_h=args.light_h,
        override=args.override)
    return device, gpu, model, bench_model.stepper(model, params, batch,
                                                   device)


def sync(device):
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


def main(argv=None):
    """Prints and returns the JSON record."""
    args = parse_args(argv)
    device, gpu, model, run = setup(args)
    t0 = time.perf_counter()
    for _ in range(args.warmup):
        run()
    sync(device)
    warmup_s = time.perf_counter() - t0
    before = bench_model.launches()
    if device.type == 'cuda':
        start, end = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
        start.record()
        for _ in range(args.steps):
            loss = run()
        end.record()
        sync(device)
        ms = start.elapsed_time(end) / args.steps
    else:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            loss = run()
        ms = 1e3 * (time.perf_counter() - t0) / args.steps
    loss = float(loss)
    if not torch.isfinite(torch.tensor(loss)):
        raise FloatingPointError("step loss %r" % loss)
    record = {
        'tool': 'step_time', 'model': args.model, 'override': args.override,
        'rays': args.rays, 'steps': args.steps, 'ms_per_step': ms,
        'rays_per_sec': args.rays / (ms / 1e3),
        'clock': 'cuda events' if device.type == 'cuda' else 'host',
        'warmup_s': warmup_s, 'loss': loss,
        'launches_per_step': {k: (v - before[k]) / args.steps
                              for k, v in bench_model.launches().items()
                              if v != before[k]},
        'device': str(device), 'card': gpu}
    if args.model == 'nerfactor':
        record['n_lights'] = model.n_lights
    print(json.dumps(record))
    return record


if __name__ == '__main__':
    main()
