"""The card's name and power limit, which every time read on it carries
(a card set below its maximum power runs slower under load), and the
profiler window that every device time read on it comes from."""

import contextlib
import subprocess
import time

import torch


def name_and_power():
    """The first card's line of ``nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader``, e.g. 'NVIDIA H100 80GB HBM3, 700.00 W'."""
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]



# What every profiler window does before the work it times. torch 2.11's
# profiler on an H100 drops the first k kernels of about every other
# window, k growing with the process's age (by one every 17-20 s: all 20
# of a window's launches 360 s in), whatever the kernels' length or the
# host idle around them, and places the kernels of the other windows up to
# 12 ms off their launch calls (tools/profiler_probe.py, PERF.md §7). So a
# window first launches PROFILER_FILLER empty kernels (torch.cuda._sleep,
# FILLER_KERNEL), which the dropped ones are and which the readings leave
# out (device_events), and holds PROFILER_PAD_S of host idle on each side
# of the work.
PROFILER_FILLER = 1000
FILLER_KERNEL = 'spin_kernel'
PROFILER_PAD_S = 0.25


@contextlib.contextmanager
def profiler_window(activities, pad_s=PROFILER_PAD_S,
                    filler=PROFILER_FILLER):
    """A torch.profiler window over the block (which times its own work):
    on the card ``filler`` empty kernels first, the card synchronized, and
    ``pad_s`` seconds of host idle before and after the block; yields the
    profiler."""
    on_card = torch.cuda.is_available()
    if on_card:
        torch.cuda.synchronize()
    with torch.profiler.profile(activities=list(activities)) as prof:
        if on_card and torch.profiler.ProfilerActivity.CUDA in activities:
            for _ in range(filler):
                torch.cuda._sleep(0)
            torch.cuda.synchronize()
        time.sleep(pad_s)
        yield prof
        if on_card:
            torch.cuda.synchronize()
        time.sleep(pad_s)


def is_filler(event):
    """Whether a profiler event is one of profiler_window's empty
    kernels."""
    return event.device_type == torch.autograd.DeviceType.CUDA \
        and FILLER_KERNEL in event.key


def is_span(event):
    """Whether a profiler event is one of the program's spans
    (utils/trace.py), whose device-side copy is an annotation over the
    work issued in it, not work."""
    return event.key.startswith('program.')


def device_events(prof):
    """The device's events of ``prof.key_averages()``, the filler's and
    the program's spans left out."""
    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not is_filler(e) and not is_span(e)]


def step_phases(prof):
    """Device ms of the eager steps' phases in ``prof``'s window, summed
    over its steps: {'forward' | 'backward' | 'optimizer': {'span_ms',
    'busy_ms'}}. The forward and the optimizer are the device-side copies
    of their spans (``program.step.forward``, ``.optimizer``: from the
    first to the last device operation issued inside); the backward, whose
    kernels autograd's device thread launches outside the step's spans, is
    the device's time between a step's forward and its optimizer (one
    stream runs them in order). ``busy_ms``: the part of each in which some
    kernel ran."""
    marks = {'program.step.forward': [], 'program.step.optimizer': []}
    kernels = []
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        iv = (e.time_range.start, e.time_range.end)
        if e.name in marks:
            marks[e.name].append(iv)
        elif not e.name.startswith('program.') and FILLER_KERNEL not in e.name:
            kernels.append(iv)
    fwd = sorted(marks['program.step.forward'])
    opt = sorted(marks['program.step.optimizer'])
    windows = {'forward': fwd,
               'backward': [(f[1], o[0]) for f, o in zip(fwd, opt)],
               'optimizer': opt}
    busy = []
    for s, e in sorted(kernels):
        if busy and s <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], e)
        else:
            busy.append([s, e])
    out = {}
    for phase, ivs in windows.items():
        out[phase] = {
            'span_ms': sum(e - s for s, e in ivs) / 1e3,
            'busy_ms': sum(max(0.0, min(e, be) - max(s, bs))
                           for s, e in ivs for bs, be in busy) / 1e3}
    return out
