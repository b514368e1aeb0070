"""Time by op of the joint model's (or NeRF's) train step (counterpart of
tools/profile_joint.py) at bench.py's settings (tools/bench_model.py).

A call is one ``make_train_step_scan`` call of ``--scan`` steps on the
batch repeated (8 by default, as the JAX tool and the shipped INIs: on the
card one CUDA graph launch, its first call eager and its second the
capture), or with ``--scan 0`` one ``make_train_step`` step. After
``--warmup`` calls (at least 2 under ``--scan``), a torch.profiler window
over ``--steps`` calls: the device ms a step by kernel, the ``--top``
longest, the device's busy ms a step and idle share over the window, the
graph launches the host made, and each kernel of the port's (K1, K2, K3)
with the launches the window recorded against those its wrapper counted
in the window's steps (a graph replay counts the launches it runs).
One JSON line, with ``scan`` and the card's name and
power limit. ``--device cpu`` profiles the plain versions on the host
(under ``--scan`` the plain loop) as a check of the tool
(``top_host_ms`` by op); it measures nothing of the card.

    python -m nerfactor_tpu_torch.tools.profile_joint [--steps 3] \\
        [--scan 8] [--override k=v] [--top 25]
"""

import argparse
import json
import re
import time

import torch

from nerfactor_tpu_torch.tools import bench_model
from nerfactor_tpu_torch.tools.step_time import (
    capture_record, launches_per_step, setup, sync, warmup_calls)
from nerfactor_tpu_torch.utils import card


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--override', default='')
    ap.add_argument('--model', default='nerfactor',
                    choices=['nerfactor', 'nerf'])
    ap.add_argument('--rays', type=int, default=1024)
    ap.add_argument('--light_h', type=int, default=16)
    ap.add_argument('--warmup', type=int, default=2,
                    help="calls before the window (at least 2 under --scan)")
    ap.add_argument('--steps', type=int, default=3,
                    help="calls in the window (each --scan steps)")
    ap.add_argument('--scan', type=int, default=8,
                    help="steps a call through make_train_step_scan (one "
                         "CUDA graph launch on the card); 0 = one "
                         "make_train_step step a call")
    ap.add_argument('--top', type=int, default=25)
    ap.add_argument('--device', default='cuda',
                    help="cuda (the kernels) or cpu (the plain versions)")
    return ap.parse_args(argv)


def main(argv=None):
    """Prints and returns the JSON record."""
    args = parse_args(argv)
    device, gpu, _, run = setup(args)
    for _ in range(warmup_calls(args)):
        run()
    sync(device)
    n_steps = args.steps * max(1, args.scan)
    on_card = device.type == 'cuda'
    acts = [torch.profiler.ProfilerActivity.CPU]
    if on_card:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    before = bench_model.launches()
    with card.profiler_window(acts) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            run()
        sync(device)
        wall_ms = 1e3 * (time.perf_counter() - t0)
    ran = {k: v * n_steps for k, v in launches_per_step(
        before, n_steps).items()}
    ms, seen, graph_launches = {}, {}, 0
    for e in prof.key_averages():
        if card.is_filler(e):
            continue
        if on_card and e.device_type == torch.autograd.DeviceType.CUDA:
            us = getattr(e, 'self_device_time_total', 0.0)
        elif not on_card and e.device_type == torch.autograd.DeviceType.CPU:
            us = e.self_cpu_time_total
        else:
            graph_launches += e.count if e.key == 'cudaGraphLaunch' else 0
            continue
        ms[e.key] = ms.get(e.key, 0.0) + us / 1e3 / n_steps
        seen[e.key] = seen.get(e.key, 0) + e.count
    top = sorted(ms.items(), key=lambda kv: -kv[1])[:args.top]
    record = {'tool': 'profile_joint', 'model': args.model,
              'override': args.override, 'scan': args.scan,
              'rays': args.rays, 'steps': n_steps,
              'wall_ms_per_step': wall_ms / n_steps,
              'capture': capture_record(run), 'device': str(device),
              'card': gpu}
    if on_card:
        busy = sum(ms.values())
        record.update({
            'device_busy_ms_per_step': busy,
            'device_idle_share': 1 - busy / (wall_ms / n_steps)
            if busy else None, 'graph_launches': graph_launches,
            'top_device_ms': [[k[:100], v] for k, v in top],
            'launches': {
                name: {'ran': ran[name], 'recorded': sum(
                    n for k, n in seen.items() if re.search(pat, k))}
                for name, (_, pat) in bench_model.KERNELS.items()
                if ran.get(name)}})
    else:
        record['top_host_ms'] = [[k[:100], v] for k, v in top]
    print(json.dumps(record))
    return record


if __name__ == '__main__':
    main()
