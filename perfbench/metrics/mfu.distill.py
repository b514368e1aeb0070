"""Distillation step (``geometry_from_nerf.py`` ``lvis_block`` ->
``models/nerf.py`` ``eval_sigma``): the sigma chain's coarse and fine
products a light ray (``counts/nerf.py``) times the window's light rays,
over the window's time, as a share of one H100's dense bf16 peak."""

from perfbench.harness import BF16_PEAK


def read(ctx):
    w = ctx.window
    flops = ctx.counts(ctx.config_name).march_flops_per_ray(ctx.config)
    return {'value': 100.0 * flops * w['rays'] / w['window_s'] / BF16_PEAK}
