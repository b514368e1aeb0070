"""Train-step timer of the joint model or NeRF (counterpart of
tools/step_time.py) at bench.py's settings (tools/bench_model.py:
1024 rays x 512 lights, 128 x 4 MLPs; NeRF at nerf.ini's), with config
overrides.

On the card: ``--warmup`` calls, then ``--steps`` calls chained through
the parameters, timed by CUDA events around the run (the host's launch
work included, as training pays it). A call is one step, or with ``--scan
N`` one ``make_train_step_scan`` call of N steps on the batch repeated
(the JAX tool's lax.scan dispatch): on the card one CUDA graph launch, its
first call eager and its second the capture, so at least 2 warm-up calls
run. One JSON line: ``scan``, ms per step, rays per second, each kernel's
launches a step over the timed steps (a graph replay counts the launches
it runs), the capture's seconds and pool MiB, the last loss, the card's
name and power limit. ``--device
cpu`` runs the plain versions (and under ``--scan`` the plain loop) as a
check of the tool: its time is the host's (``clock``), not the card's.

    python -m nerfactor_tpu_torch.tools.step_time
    python -m nerfactor_tpu_torch.tools.step_time --scan 8
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
    ap.add_argument('--steps', type=int, default=20,
                    help="timed calls (each --scan steps under --scan)")
    ap.add_argument('--warmup', type=int, default=3,
                    help="untimed calls first (at least 2 under --scan)")
    ap.add_argument('--scan', type=int, default=0,
                    help="steps a call through make_train_step_scan (one "
                         "CUDA graph launch on the card); 0 = one "
                         "make_train_step step a call")
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
                                                   device, scan=args.scan)


def sync(device):
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


def warmup_calls(args):
    """--warmup, at least 2 under --scan (the eager call and the
    capture)."""
    return max(args.warmup, 2) if args.scan else args.warmup


def launches_per_step(before, steps):
    """Each kernel's launches a step over the ``steps`` steps since
    ``before``."""
    return {k: (v - before[k]) / steps
            for k, v in bench_model.launches().items() if v != before[k]}


def capture_record(run):
    captured = getattr(run, 'captured', None)
    return None if captured is None else {
        'seconds': captured['seconds'],
        'pool_mib': captured['pool_bytes'] / 2 ** 20}


def main(argv=None):
    """Prints and returns the JSON record."""
    args = parse_args(argv)
    device, gpu, model, run = setup(args)
    n_steps = args.steps * max(1, args.scan)
    t0 = time.perf_counter()
    for _ in range(warmup_calls(args)):
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
        ms = start.elapsed_time(end) / n_steps
    else:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            loss = run()
        ms = 1e3 * (time.perf_counter() - t0) / n_steps
    loss = float(loss)
    if not torch.isfinite(torch.tensor(loss)):
        raise FloatingPointError("step loss %r" % loss)
    record = {
        'tool': 'step_time', 'model': args.model, 'override': args.override,
        'scan': args.scan, 'rays': args.rays, 'steps': n_steps,
        'ms_per_step': ms, 'rays_per_sec': args.rays / (ms / 1e3),
        'clock': 'cuda events' if device.type == 'cuda' else 'host',
        'warmup_s': warmup_s, 'loss': loss,
        'launches_per_step': launches_per_step(before, n_steps),
        'capture': capture_record(run), 'device': str(device), 'card': gpu}
    if args.model == 'nerfactor':
        record['n_lights'] = model.n_lights
    print(json.dumps(record))
    return record


if __name__ == '__main__':
    main()
