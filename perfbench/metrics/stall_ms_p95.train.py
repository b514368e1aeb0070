"""Dispatch (``parallel/train.py`` ``make_train_step_scan``): how far the
window's slowest groups lag the groups around them, a step: each group's
time (the CUDA events of ``train_step_ms_p95``) less the median of the
``2 * NEAR + 1`` groups around it, and the 95th percentile of that over
the window's groups. The card's pace moves between two levels some 3 %
apart, each held for seconds, within one process (PERF.md), and the
95th percentile of all groups follows whichever level a window spends
more than a twentieth of its groups at; a stall, a group slower than its
neighbours (a copy, the allocator, the host), shows here at either
level."""

import numpy as np

NEAR = 10


def read(ctx):
    ms = np.asarray(ctx.window.get('step_ms', ()))
    if len(ms) < 2 * NEAR + 1:
        return None
    excess = [ms[i] - np.median(ms[max(0, i - NEAR):i + NEAR + 1])
              for i in range(len(ms))]
    return {'value': float(np.percentile(excess, 95))}
