"""Dispatch (``parallel/train.py`` ``make_train_step_scan``): the host's
time in the program's call a group (the copy into the graph's static
buffers and the replay's launch), a step, over the window: a span from
the benchmark's own files around each call."""


def read(ctx):
    w = ctx.window
    return {'value': 1e3 * w['issue_s'] / w['steps']}
