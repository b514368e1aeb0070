"""The card's name and power limit, and the profiler window that every
device reading of the benchmark comes from, with its reduction to busy
time, kernel time by name and the idle gaps.

``name_and_power`` and ``profiler_window`` (with its filler and pads)
are frozen copies of ``nerfactor_tpu_torch/utils/card.py`` as of the
benchmark's first version, so that a change to the program cannot move
the yardstick.
"""

import contextlib
import re
import subprocess
import time

import torch

# What every profiler window does before the work it times. torch's
# profiler on an H100 drops the first k kernels of about every other
# window, k growing with the process's age, and places the kernels of
# the other windows up to 12 ms off their launch calls (PERF.md). So a
# window first launches PROFILER_FILLER empty kernels, which the dropped
# ones are and which the readings leave out, and holds PROFILER_PAD_S of
# host idle on each side of the work.
PROFILER_FILLER = 1000
FILLER_KERNEL = 'spin_kernel'
PROFILER_PAD_S = 0.25


def name_and_power():
    """The first card's line of ``nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader``, e.g. 'NVIDIA H100 80GB HBM3, 700.00 W'."""
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


@contextlib.contextmanager
def profiler_window(pad_s=PROFILER_PAD_S, filler=PROFILER_FILLER,
                    warm=None):
    """A torch.profiler window (host and card) over the block: ``filler``
    empty kernels first, then ``warm()`` if given (work whose device
    operations the readings leave out: the first graph replay under the
    profiler leaves the card idle some 22 ms), the card synchronized, and
    ``pad_s`` seconds of host idle before and after the block; yields the
    profiler."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(filler):
            torch.cuda._sleep(0)
        if warm is not None:
            warm()
        torch.cuda.synchronize()
        time.sleep(pad_s)
        yield prof
        torch.cuda.synchronize()
        time.sleep(pad_s)


def _union(intervals):
    """Merged [start, end] segments of ``intervals``, sorted."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def reduce_trace(prof, after_gap_s=None,
                 host_label=re.compile(r'^(bench|program)\.')):
    """The device's readings of a profiler window, in seconds: the
    window from the first device operation's start to the last one's end
    (the filler left out, and with ``after_gap_s`` every operation before
    the first idle gap that long: the warm-up's), the time in it in
    which some operation ran
    (``busy_s``), each operation name's total (``by_name``), and the idle
    gaps, each named by the innermost host span (a ``record_function``
    whose name matches ``host_label``) open at the gap's middle."""
    device, host = [], []
    for e in prof.events():
        span = (e.time_range.start, e.time_range.end, e.name)
        if host_label.match(e.name):
            # A span shows on both sides (the device's copy is an
            # annotation over the work issued in it, not work)
            if e.device_type != torch.autograd.DeviceType.CUDA:
                host.append(span)
        elif e.device_type == torch.autograd.DeviceType.CUDA \
                and FILLER_KERNEL not in e.name:
            device.append(span)
    if after_gap_s is not None:
        device.sort()
        end = None
        for i, (s, e, _) in enumerate(device):
            if end is not None and s - end >= after_gap_s * 1e6:
                device = device[i:]
                break
            end = e if end is None else max(end, e)
    if not device:
        return None
    segs = _union([(s, e) for s, e, _ in device])
    by_name = {}
    for s, e, name in device:
        by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e6
    gaps = []
    for (_, end), (start, _) in zip(segs, segs[1:]):
        mid = 0.5 * (end + start)
        open_spans = [h for h in host if h[0] <= mid <= h[1]]
        label = min(open_spans, key=lambda h: h[1] - h[0])[2] \
            if open_spans else 'no host span'
        gaps.append((label, (start - end) / 1e6))
    return {'window_s': (segs[-1][1] - segs[0][0]) / 1e6,
            'busy_s': sum(e - s for s, e in segs) / 1e6,
            'by_name': by_name, 'gaps': gaps}


def kernel_seconds(trace, pattern):
    """Total device seconds of the operations whose names match
    ``pattern`` (a regular expression), and how many names matched."""
    hits = {k: v for k, v in trace['by_name'].items()
            if re.search(pattern, k)}
    return sum(hits.values()), len(hits)
