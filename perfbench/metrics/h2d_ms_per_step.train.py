"""Dispatch (``parallel/train.py`` ``make_train_step_scan``): the device
time of the window's host-to-device copies (``Memcpy HtoD`` operations:
the fill of the graph's static buffers from pinned memory), a step, from
the profiler window. Beside it, from the program's counters
(``utils/trace.py``), the bytes a group copies from the host
(``_GraphSteps.h2d_bytes`` over ``_GraphSteps.groups``) and the GB/s that
implies; left out where the program has no such counters."""

from perfbench import card

MEMCPY = r'^Memcpy HtoD'


def read(ctx):
    t = ctx.trace
    if t is None:
        return None
    seconds, names = card.kernel_seconds(t, MEMCPY)
    if not names:
        return None
    steps = t['units']['steps']
    out = {'value': 1e3 * seconds / steps}
    try:
        from nerfactor_tpu_torch.utils import trace
    except ImportError:
        return out
    counters = trace.summary()['counters']
    groups = counters.get('train._GraphSteps.groups')
    if groups:
        per_group = counters['train._GraphSteps.h2d_bytes'] / groups
        window_groups = steps / ctx.config['values']['scan_steps']
        out.update(h2d_bytes_a_group=per_group,
                   h2d_gb_s=per_group * window_groups / seconds / 1e9)
    return out
