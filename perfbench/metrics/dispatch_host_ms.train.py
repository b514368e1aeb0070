"""Dispatch (``parallel/train.py`` ``make_train_step_scan``): the host's
own work inside the program's call a step, from the program's own spans
(``utils/trace.py``, recorded in the ``--trace 1`` profiler window: its
warm-up groups and its traced groups): the self time of
``program.dispatch`` and of its ``check`` and ``fill`` children, over the
window's groups (``program.dispatch.replay`` spans) times
``scan_steps``; each part's ms a step beside it, ``replay_ms`` too. The
graph launch inside ``replay`` is left out of the value: under the
profiler's device tracing a launch costs 14-32 ms a group, against 0.12
ms without it (PERF.md), a reading of the tracer and not of the program.
The parts it keeps are traced host time too: under the profiler each op
costs the host some 2.5 times its untraced time, so the value reads above
``host_issue_ms.train`` (untraced, the graph launch included), and is to
be compared only with other traced readings of itself. Nothing where the
program records no such span (no profiler window, or a program without
the spans)."""

PARTS = ('program.dispatch', 'program.dispatch.check',
         'program.dispatch.fill')


def read(ctx):
    if ctx.trace is None:
        return None
    try:
        from nerfactor_tpu_torch.utils import trace
    except ImportError:
        return None
    spans = trace.summary()['spans']
    if 'program.dispatch.replay' not in spans:
        return None
    groups = spans['program.dispatch.replay']['count']
    steps = groups * ctx.config['values']['scan_steps']
    ms = {name: spans[name]['self_ms'] / steps for name in PARTS
          if name in spans}
    out = {'value': sum(ms.values()), 'groups': groups,
           'replay_ms': spans['program.dispatch.replay']['self_ms'] / steps}
    out.update({name.replace('program.', '') + '_ms': v
                for name, v in ms.items()})
    return out
