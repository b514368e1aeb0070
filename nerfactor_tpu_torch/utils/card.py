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


def device_events(prof):
    """The device's events of ``prof.key_averages()``, the filler's left
    out."""
    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not is_filler(e)]
