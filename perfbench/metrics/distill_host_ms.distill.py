"""Distillation step (``geometry_from_nerf.py`` ``_map_blocks``): the
host's own time to issue a block, from the program's own spans
(``utils/trace.py``, recorded in the ``--trace 1`` profiler window: its
warm-up block's call and the traced call). A block issues some hundred
launches, and the launch queue holds some ten blocks' worth: past that
the host waits inside each block's span for the card, at the pace of the
kernels. So the value takes a block's issue (``program.distill.block``)
and its copy out (``program.distill.copy_out``) from the first ``FREE``
blocks of each call alone, as the median of each, and adds the self time
of ``program.distill`` and ``program.distill.inputs`` over the window's
blocks. It is a traced host time: under the profiler each op costs the
host more than without it, so compare it only with traced readings of
itself. Beside the value: ``blocked_ms``, the self time of all four
spans over the blocks, the final wait (``program.distill.wait``) left
out, which follows the card's pace; the medians of the first blocks and
of the later ones; the window's calls and blocks; the wait's ms; the
bytes a point that the program's counters saw move to the card and
back. Nothing where the program records no such span (no profiler
window, or a program without the spans)."""

import statistics

# Blocks at the start of a call that the host issues before the launch
# queue can fill
FREE = 4
PARTS = ('program.distill', 'program.distill.inputs',
         'program.distill.block', 'program.distill.copy_out')


def read(ctx):
    if ctx.trace is None:
        return None
    try:
        from nerfactor_tpu_torch.utils import trace
    except ImportError:
        return None
    summary = trace.summary()
    spans = summary['spans']
    if 'program.distill.block' not in spans:
        return None
    # Each call's block and copy-out durations (ms): its first FREE, and
    # the rest
    rows = trace.spans()
    ms = {name: ([], []) for name in PARTS[2:]}
    for call, (name, *_) in enumerate(rows):
        if name != 'program.distill':
            continue
        seen = dict.fromkeys(ms, 0)
        for kid, t0, t1, parent in rows:
            if parent == call and kid in ms:
                ms[kid][seen[kid] >= FREE].append((t1 - t0) / 1e6)
                seen[kid] += 1
    first, later = ms['program.distill.block']
    copies = ms['program.distill.copy_out'][0]
    if not first:
        return None
    blocks = spans['program.distill.block']['count']
    rest = sum(spans[n]['self_ms'] for n in PARTS[:2] if n in spans)
    out = {'value': statistics.median(first)
           + (statistics.median(copies) if copies else 0.0)
           + rest / blocks,
           'blocked_ms': sum(spans[n]['self_ms'] for n in PARTS
                             if n in spans) / blocks,
           'block_ms_first': statistics.median(first),
           'calls': spans['program.distill']['count'], 'blocks': blocks}
    if later:
        out['block_ms_later'] = statistics.median(later)
    if 'program.distill.wait' in spans:
        out['wait_ms'] = spans['program.distill.wait']['total_ms']
    c = summary['counters']
    points = c.get('geometry_from_nerf.GeometryDistiller.points')
    if points:
        out.update(
            h2d_bytes_a_point=c['geometry_from_nerf.GeometryDistiller.'
                                'h2d_bytes'] / points,
            d2h_bytes_a_point=c['geometry_from_nerf.GeometryDistiller.'
                                'd2h_bytes'] / points)
    return out
