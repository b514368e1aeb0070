"""Device: the share of one profiler window (from its first device
operation to its last, the filler left out) in which no operation ran on
the card, over ``trace_groups`` training groups."""


def read(ctx):
    t = ctx.trace
    if t is None:
        return None
    return {'value': 100.0 * (1.0 - t['busy_s'] / t['window_s'])}
