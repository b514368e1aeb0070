"""Dispatch: the program's kernel launches a step over the window, from
its own counters (``ops/kernel_lib.launch_counts``; a graph replay counts
the launches it runs)."""


def read(ctx):
    w = ctx.window
    return {'value': w['launches'] / w['steps']}
