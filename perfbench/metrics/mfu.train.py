"""Model step (``models/nerfactor.py``, ``models/nerf.py`` under
``parallel/train.py``): the model's forward and backward products a step
(``counts/<config>.py``, the kernels' recomputed forwards not counted)
times the window's steps, over the window's time, as a share of one
H100's dense bf16 peak (f32 work counted at that rate too)."""

from perfbench.harness import BF16_PEAK


def read(ctx):
    w = ctx.window
    flops = ctx.counts(ctx.config_name).train_step_flops(ctx.config)
    return {'value': 100.0 * flops * w['steps'] / w['window_s'] / BF16_PEAK}
