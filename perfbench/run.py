"""Runs one cell of the benchmark of nerfactor_tpu_torch once, on the
card(s) of the machine it starts on, and prints its result as the last
line of standard output (one JSON object), with the compared numbers
beside their limits as the last lines of standard error:

    python3 perfbench/run.py --workload joint-train-graph --seed 7 \\
        --seconds 25 --trace 0

``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer ones (and the device's busy and traced seconds and a
breakdown), read from the same kind of run plus one profiler window.
It runs from the root of a checkout, builds the program's kernels there
(``build/``) on a checkout's first run, and fails without a result when
the machine has fewer CUDA cards than the cell asks for, or when JAX or
the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Caches of the program's kernels stay at fixed paths inside the checkout
os.environ['TRITON_CACHE_DIR'] = os.path.join(ROOT, 'build', 'triton')
os.environ['USE_FLAX'] = '0'
sys.path.insert(0, ROOT)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from perfbench import harness
    spec = harness.load_spec()
    chips = harness.find_cell(spec, args.workload)['chips']
    import torch
    t_torch = time.perf_counter()
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print("perfbench: the cell needs %d CUDA card(s); this machine has "
              "%d" % (chips, torch.cuda.device_count()
                      if torch.cuda.is_available() else 0), file=sys.stderr)
        return 3
    result = harness.run_cell(args.workload, args.seed, args.seconds,
                              args.trace, torch.device('cuda', 0), T_START,
                              spec=spec)
    result['setup_parts'] = dict(result.get('setup_parts', {}),
                                 python_and_torch_s=t_torch - T_START)
    result['checks'] = result.pop('checks')
    found = harness.forbidden_modules()
    if found:
        print("perfbench: the run loaded %s" % ', '.join(found),
              file=sys.stderr)
        return 4
    sys.stdout.flush()
    print('\n'.join(harness.check_lines(result)), file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == '__main__':
    sys.exit(main())
