"""Geometry distillation's visibility march (stage 2):
``geometry_from_nerf.GeometryDistiller.compute_light_visibility`` over
calls of ``points_a_call`` surface points, each x the light directions
of an ``light_h`` x 2 ``light_h`` map, as the distillation CLI runs it
(its blocks, its ``--bf16_march`` and ``--lvis_far``).

Every call's points are drawn from the seed on the unit sphere, with
outward normals. Set-up warms one full block and one short block (the
last block of a call). The window runs calls until ``--seconds`` have
passed and closes at that call's end (each call ends in a wait on the
card). The check draws ``check_points`` points from the seed among all
the window's points and marches them again in the reference.
"""

import time
from types import SimpleNamespace

import numpy as np
import torch

from perfbench import harness, weights
from perfbench.reference import plain


def _distiller(run, params):
    from nerfactor_tpu_torch import geometry_from_nerf as geo
    t = run.traffic
    model = harness.build_model(run)
    gargs = geo.parse_args([
        '--trained_nerf', 'unused', '--out_root', 'unused',
        '--light_h', str(t['light_h']), '--lvis_far', str(t['lvis_far']),
        '--mlp_chunk', str(run.config['values']['mlp_chunk']),
        '--device', str(run.device),
        '--bf16_march' if t['bf16_march'] else '--no-bf16_march'])
    return geo.GeometryDistiller(model, params, model.config, gargs)


def setup(run):
    s = SimpleNamespace()
    s.run = run
    s.ref_mod = harness.load_module('reference', run.config_name)
    s.params = weights.make(s.ref_mod.param_tree(run.config), run.seed,
                            run.device)
    s.dist = _distiller(run, s.params)
    s.rng = np.random.default_rng(run.seed)
    s.n = run.traffic['points_a_call']
    block = s.dist.lvis_block_pts
    warm = s.ref_mod.sphere_points(s.rng, block + (s.n % block or block))
    s.dist.compute_light_visibility(*warm)
    s.calls = []
    return s


def _call(s):
    pts, nrm = s.ref_mod.sphere_points(s.rng, s.n)
    with harness.span('program.compute_light_visibility'):
        out = s.dist.compute_light_visibility(pts, nrm)
    s.calls.append((pts, nrm, out))


def window(s, seconds):
    t0 = time.perf_counter()
    while True:
        _call(s)
        if time.perf_counter() - t0 >= seconds:
            break
    elapsed = time.perf_counter() - t0
    rays = len(s.calls) * s.n * s.dist.n_lights
    failed = sum(int((~np.isfinite(o)).sum()) for _, _, o in s.calls)
    return {'attempted': rays, 'failed': failed,
            'metrics': {'distill_rays_per_s': rays / elapsed},
            'layer': {'calls': len(s.calls), 'rays': rays,
                      'window_s': elapsed}}


def trace_warm(s):
    """Before the traced work, inside the profiler: one block's points."""
    s.dist.compute_light_visibility(*s.ref_mod.sphere_points(
        s.rng, s.dist.lvis_block_pts))


def trace_work(s):
    """One traced unit of work: one call."""
    _call(s)
    return {'calls': 1}


def release(s):
    del s.dist
    harness.free(s.run.device)


def readings(s, variant=None):
    """The mean and 99th percentile of the absolute visibility gap over
    ``check_points`` points drawn from the seed among the window's calls
    (all their lights): the program's against the reference's, or the
    reference's ``variant`` ('low': the fields' operands in fp8) against
    it."""
    t = s.run.traffic
    pts = np.concatenate([c[0] for c in s.calls])
    nrm = np.concatenate([c[1] for c in s.calls])
    out = np.concatenate([c[2] for c in s.calls])
    pick = np.random.default_rng(s.run.seed + 3).choice(
        len(pts), min(t['check_points'], len(pts)), replace=False)
    ref = s.ref_mod.Reference(s.run.config, s.run.device)
    lxyz = torch.tensor(plain.light_sphere(t['light_h'], 2 * t['light_h'])[0],
                        dtype=torch.float32, device=s.run.device)

    def march(ops):
        return ref.light_visibility(
            s.params, torch.as_tensor(pts[pick], device=s.run.device),
            torch.as_tensor(nrm[pick], device=s.run.device), lxyz,
            t['lvis_far'], ops=ops).cpu().numpy()
    want = march(None)
    got = out[pick] if variant is None else march('fp8')
    gap = np.abs(got.astype(np.float64) - want)
    if not np.all(np.isfinite(gap)):
        return {'lvis_mean_gap': float('nan'), 'lvis_p99_gap': float('nan')}
    return {'lvis_mean_gap': float(gap.mean()),
            'lvis_p99_gap': float(np.percentile(gap, 99))}
