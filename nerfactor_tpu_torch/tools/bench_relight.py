"""A/B timer of the test-time relighting epilogue (counterpart of
tools/bench_relight.py).

Compares the joint model's materialization-free ``render`` (two (N, L) x
(L, .) products per light set; models/nerfactor.py) with the epilogue
that writes out the (N, L, 3) contribution tensor and contracts it once
per light condition (the reference's hot loop, nerfactor.py:315-364),
which lives here and not in the model. At test.py's chunk scale: N rows
x 512 lights x {1 render, 512 OLATs, ``--probes`` random probes}, the
model and weights of tools/bench_model.py.

On the card each epilogue runs ``--warmup`` times, then ``--steps`` times
between two CUDA events. The two must agree within REL_TOL by relative
norm on every output, or the tool raises. One JSON line with the card's
name and power limit. ``--device cpu`` runs both on the host as a check
of the tool (``clock``); it measures nothing of the card.

    python -m nerfactor_tpu_torch.tools.bench_relight --rows 8192 [--no_olat]
"""

import argparse
import json
import math
import time

import numpy as np
import torch

from nerfactor_tpu_torch.tools import bench_model
from nerfactor_tpu_torch.utils import card

REL_TOL = 1e-5


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--rows', type=int, default=8192,
                    help="rays per chunk (test.py's eval chunk scale)")
    ap.add_argument('--light_h', type=int, default=16)
    ap.add_argument('--probes', type=int, default=4)
    ap.add_argument('--no_olat', action='store_true')
    ap.add_argument('--steps', type=int, default=10)
    ap.add_argument('--warmup', type=int, default=2)
    ap.add_argument('--device', default='cuda',
                    help="cuda or cpu (a check of the tool)")
    return ap.parse_args(argv)


def relight_inputs(model, rows, n_probes, device, seed=0):
    """The epilogue's inputs as the JAX tool draws them (lvis, spec,
    albedo, light directions, normals), NumPy; sets the model's
    ``probes_flat`` to ``n_probes`` random probes."""
    rng = np.random.RandomState(seed)
    n_l = model.n_lights
    model.probes_flat = torch.as_tensor(
        rng.rand(n_probes, n_l, 3).astype(np.float32), device=device)
    lvis = rng.rand(rows, n_l).astype(np.float32)
    spec = rng.rand(rows, n_l).astype(np.float32)
    albedo = rng.rand(rows, 3).astype(np.float32)
    ldirs = rng.randn(rows, n_l, 3).astype(np.float32)
    ldirs /= np.linalg.norm(ldirs, axis=-1, keepdims=True)
    nrm = rng.randn(rows, 3).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    return {'lvis': lvis, 'spec': spec, 'albedo': albedo, 'l': ldirs,
            'n': nrm}


def factored(model, params, x, olat):
    """The model's ``render``: (rgb, rgb_olat or None, rgb_probes)."""
    return model.render(params, x['lvis'], x['spec'], x['albedo'], x['l'],
                        x['n'], relight_olat=olat, relight_probes=True)


def materialized(model, params, x, olat):
    """The same outputs through the (N, L, 3) contribution tensor
    C = (albedo / pi + spec) * lvis * max(cos, 0) * dOmega."""
    cos = torch.einsum('ijk,ik->ij', x['l'], x['n'])
    w = (cos > 0).to(cos.dtype) * x['lvis'] * cos \
        * model.lareas.reshape(1, -1)
    brdf = x['albedo'][:, None, :] / math.pi + x['spec'][:, :, None]
    contrib = brdf * w[:, :, None]  # (N, L, 3)
    light = model.light_from(params).reshape(-1, 3)
    rgb = model._finish_render(torch.einsum('nlc,lc->nc', contrib, light))
    rgb_olat = None
    if olat:
        o = model.olat_inten * contrib[:, model.olat_inds, :]
        if model.ambient_inten > 0:
            o = o + model.ambient_inten * torch.sum(contrib, dim=1,
                                                    keepdim=True)
        rgb_olat = model._finish_render(o)
    rgb_probes = model._finish_render(
        torch.einsum('nlc,plc->npc', contrib, model.probes_flat))
    return rgb, rgb_olat, rgb_probes


def rel_err(got, want):
    """The largest relative norm of the difference over the outputs."""
    return max(float(torch.linalg.norm(g - w) / torch.linalg.norm(w))
               for g, w in zip(got, want) if w is not None)


def main(argv=None):
    """Prints and returns the JSON record."""
    args = parse_args(argv)
    device = torch.device(args.device)
    on_card = device.type == 'cuda'
    if on_card and not torch.cuda.is_available():
        raise RuntimeError("no CUDA card (--device cpu checks the tool)")
    torch.backends.cuda.matmul.allow_tf32 = False
    gpu = card.name_and_power() if on_card else None
    model, params, _ = bench_model.make('nerfactor', device, n_rays=1,
                                        light_h=args.light_h)
    x = {k: torch.as_tensor(v, device=device) for k, v in relight_inputs(
        model, args.rows, args.probes, device).items()}
    olat = not args.no_olat
    results = {}
    outs = {}
    with torch.no_grad():
        for name, epilogue in (('factored', factored),
                               ('materialized', materialized)):
            for _ in range(args.warmup):
                outs[name] = epilogue(model, params, x, olat)
            if on_card:
                torch.cuda.synchronize(device)
                start, end = (torch.cuda.Event(enable_timing=True)
                              for _ in range(2))
                start.record()
                for _ in range(args.steps):
                    epilogue(model, params, x, olat)
                end.record()
                torch.cuda.synchronize(device)
                ms = start.elapsed_time(end) / args.steps
            else:
                t0 = time.perf_counter()
                for _ in range(args.steps):
                    epilogue(model, params, x, olat)
                ms = 1e3 * (time.perf_counter() - t0) / args.steps
            results[name] = {'ms_per_eval': ms, 'checksum': float(sum(
                torch.sum(o) for o in outs[name] if o is not None))}
    err = rel_err(outs['factored'], outs['materialized'])
    if not err <= REL_TOL:
        raise AssertionError("the two epilogues disagree: %r > %r"
                             % (err, REL_TOL))
    record = dict(results, tool='bench_relight', rel_err=err,
                  speedup=results['materialized']['ms_per_eval']
                  / results['factored']['ms_per_eval'],
                  config={'rows': args.rows, 'lights': model.n_lights,
                          'olat': olat, 'n_olat': len(model.olat_inds)
                          if olat else 0, 'probes': args.probes},
                  clock='cuda events' if on_card else 'host',
                  device=str(device), card=gpu)
    print(json.dumps(record))
    return record


if __name__ == '__main__':
    main()
