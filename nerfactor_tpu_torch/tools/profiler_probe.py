"""Whether a torch.profiler window on the card records the kernels launched
inside it, as the process ages (tools of the port read device time from
such windows: ``profile_joint``, ``chip_smoke.py``).

One process. Every ``--every`` seconds, for ``--minutes``, one window for
each kind of work (``--kinds``: ``mm``, ``--launches`` small matmuls;
``p``, ``--launches`` calls of kernel P at the smoke's depth 32 and
1,048,576 rows, two launches a call, built from the checkout) and each
pad in ``--pads``: the launches, a sync, with the pad's seconds of host
sleep on each side of them inside the window. For each window: the
kernels it recorded, which of the launch calls (in their order, matched
by correlation id) have a recorded kernel, and the offset of each
recorded kernel's start from the start of the host call that launched it
(``cudaLaunchKernel``): a kernel starts after its launch call, so a
negative offset is the profiler's device clock placed off the host's.
Between windows the card multiplies matrices; after a third of the
rounds a CUDA graph is captured and replayed inside a window, after two
thirds ``--sessions`` empty profiler sessions run, so that the readings
part the process's age from those two events. One JSON line a window and
a last one with all of them (also written to ``--out``).

    python -m nerfactor_tpu_torch.tools.profiler_probe [--minutes 5] \\
        [--every 20] [--kinds mm,p] [--pads 0,0.25,1] \\
        [--out build/profiler_probe.json]
"""

import argparse
import json
import statistics
import time

import numpy as np
import torch

from nerfactor_tpu_torch.utils import card

ACTS = (torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA)
CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--minutes', type=float, default=5.0)
    ap.add_argument('--every', type=float, default=20.0)
    ap.add_argument('--launches', type=int, default=10)
    ap.add_argument('--kinds', default='mm')
    ap.add_argument('--pads', default='0,1')
    ap.add_argument('--sessions', type=int, default=50)
    ap.add_argument('--out', default='')
    return ap.parse_args(argv)


def window(run, pad):
    """One profiler window around ``run`` (``pad`` s of sleep each side):
    (kernels recorded, the indices of the launch calls whose kernel was
    recorded, the offsets in ms of each recorded kernel's start from its
    launch call's start)."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=list(ACTS)) as prof:
        time.sleep(pad)
        run()
        torch.cuda.synchronize()
        time.sleep(pad)
    events = prof.profiler.kineto_results.events()
    launches = sorted((e.start_ns(), e.correlation_id()) for e in events
                      if e.device_type() == CPU and 'Launch' in e.name()
                      and e.name().startswith('cu'))
    order = {cid: i for i, (_, cid) in enumerate(launches)}
    start = dict((cid, t) for t, cid in launches)
    kernels = [e for e in events if e.device_type() == CUDA
               and 'memcpy' not in e.name().lower()
               and 'memset' not in e.name().lower()]
    seen, offsets = [], []
    for e in kernels:
        for cid in (e.correlation_id(), e.linked_correlation_id()):
            if cid in order:
                seen.append(order[cid])
                offsets.append((e.start_ns() - start[cid]) / 1e6)
                break
    return len(kernels), len(launches), sorted(seen), offsets


def kinds(args):
    """{kind: run} of the work a window times."""
    out = {}
    names = args.kinds.split(',')
    if 'mm' in names:
        a = torch.randn(256, 256, device='cuda')

        def mm():
            for _ in range(args.launches):
                torch.mm(a, a)
        out['mm'] = mm
    if 'p' in names:
        from nerfactor_tpu_torch.ops import dot_probe as dp
        from nerfactor_tpu_torch.tools import dot_probe
        ws = dot_probe.make_weights(np.random.RandomState(8), 32, dp.WIDTH,
                                    'cuda')
        x = 0.1 * torch.randn(1 << 20, dp.WIDTH, device='cuda')

        def p():
            for _ in range(args.launches):
                dp.dot_chain_kernel(x, ws, 'serial')
        out['p'] = p
    return out


def main(argv=None):
    args = parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA card")
    gpu = card.name_and_power()
    runs = kinds(args)
    pads = [float(p) for p in args.pads.split(',')]
    for run in runs.values():
        run()
    big = torch.randn(4096, 4096, device='cuda')
    a = torch.randn(256, 256, device='cuda')
    graph = torch.cuda.CUDAGraph()
    n_rounds = max(3, int(args.minutes * 60 / args.every))
    t_start = time.perf_counter()
    readings = []
    for i in range(n_rounds):
        event = None
        if i == n_rounds // 3:
            torch.mm(a, a)
            torch.cuda.synchronize()
            with torch.cuda.graph(graph):
                torch.mm(a, a)
            window(graph.replay, 0.0)
            event = 'graph captured and replayed in a window'
        if i == 2 * n_rounds // 3:
            for _ in range(args.sessions):
                with torch.profiler.profile(activities=list(ACTS)):
                    pass
            event = '%d empty sessions' % args.sessions
        for kind, run in runs.items():
            for pad in pads:
                n, calls, seen, offsets = window(run, pad)
                rec = {'round': i, 'age_s': time.perf_counter() - t_start,
                       'event': event, 'kind': kind, 'pad_s': pad,
                       'launch_calls': calls, 'kernels_recorded': n,
                       'calls_recorded': seen,
                       'offset_ms_min': min(offsets) if offsets else None,
                       'offset_ms_median': statistics.median(offsets)
                       if offsets else None}
                print(json.dumps(rec), flush=True)
                readings.append(rec)
        t_next = t_start + (i + 1) * args.every
        while time.perf_counter() < t_next:
            torch.mm(big, big)
            torch.cuda.synchronize()
    out = {'gpu': gpu, 'torch': torch.__version__, 'windows': readings}
    print(json.dumps(out))
    if args.out:
        with open(args.out, 'w') as f:
            json.dump(out, f, indent=1)
    return out


if __name__ == '__main__':
    main()
