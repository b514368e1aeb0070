"""The readings that a cell's limits are set from (``checks/<workload>.json``),
at the cell's own size, in one process: for each of ``--seeds`` the
program's numbers against the reference (the lower readings); for each
of ``--control-seeds`` the control's (the reference with its big chains'
operands in fp8 and the rest in TF32, put in the program's place) and,
for a training cell, the fault's (the reference put in the program's
place with the loss's mean over half of the batch). A state left
unchanged reads 1 by the step gap's measure and needs no run. One JSON
line a reading, also written to ``--out``:

    python3 perfbench/limits.py --workload joint-train-graph \\
        --seeds 1,2,3 --control-seeds 4,5,6 --out chiprun_out/limits.jsonl
"""

import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seeds', default='')
    ap.add_argument('--control-seeds', default='')
    ap.add_argument('--out', required=True)
    args = ap.parse_args(argv)
    import torch
    from perfbench import harness
    if not torch.cuda.is_available():
        raise SystemExit("limits: no CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell, config, traffic, driver, _ = harness.prepare(args.workload)
    device = torch.device('cuda', 0)
    training = traffic['driver'] == 'train_scan'
    jobs = [(int(s), False) for s in args.seeds.split(',') if s] + \
        [(int(s), True) for s in args.control_seeds.split(',') if s]
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, 'a') as out:
        for seed, control in jobs:
            with tempfile.TemporaryDirectory(prefix='perfbench_') as tmp:
                run = harness.new_run(cell, config, traffic, seed, device,
                                      tmp)
                t0 = time.perf_counter()
                state = driver.setup(run)
                if not training:
                    driver.window(state, 0)
                driver.release(state)
                kinds = [('control', 'low')] + (
                    [('half_batch', 'half_batch')] if training else []) \
                    if control else [('program', None)]
                for kind, variant in kinds:
                    t1 = time.perf_counter()
                    rec = {'workload': args.workload, 'seed': seed,
                           'kind': kind,
                           'readings': driver.readings(state, variant),
                           'setup_s': t1 - t0 if kind in ('program',
                                                          'control') else None,
                           'reference_s': time.perf_counter() - t1}
                    line = json.dumps(rec)
                    print(line, flush=True)
                    out.write(line + '\n')
                    out.flush()
                del state
                harness.free(device)


if __name__ == '__main__':
    main()
