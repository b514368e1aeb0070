"""The benchmark's core: finds a cell's configuration, traffic mix,
driver, per-layer readers and limits by the names in ``BENCHMARK.json``,
runs the cell once and builds its result line.

A run: set-up (the program built, its weights made from the seed, the
driver's first calls, which the check reads, and the warm-up), the
measured window of ``--seconds``, with ``--trace 1`` one profiler window
after it, then the program freed and the reference run, which decides
``correct``. Everything per configuration, traffic mix, per-layer metric
and cell lives in files of its own under ``perfbench/``:
``configs/<config>.json``, ``traffic/<traffic>.json``,
``drivers/<driver>.py``, ``metrics/<metric>.py``,
``reference/<config>.py``, ``counts/<name>.py`` and
``checks/<workload>.json`` (each compared number's limit, with the
readings it was set from).
"""

import contextlib
import importlib.util
import json
import math
import os
import sys
import tempfile
from os.path import dirname, join
from types import SimpleNamespace


HERE = dirname(os.path.abspath(__file__))
ROOT = dirname(HERE)
# Top-level module names that must not be loaded in a run's process: the
# JAX package, JAX and what sits on it, compared whole (the port's name
# begins with the JAX package's)
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'nerfactor_tpu', 'brdf_tpu',
             'data_gen_tpu')
BF16_PEAK = 989e12  # dense bf16 FLOP/s of one H100 SXM (data sheet)
HBM_BYTES_S = 3.35e12


def load_spec():
    with open(join(ROOT, 'BENCHMARK.json')) as f:
        return json.load(f)


def load_json(kind, name):
    with open(join(HERE, kind, name + '.json')) as f:
        return json.load(f)


def load_module(kind, name):
    """``perfbench/<kind>/<name>.py`` as a module (names may hold '-'
    and '.')."""
    key = 'perfbench.%s.%s' % (kind, name.replace('-', '_').replace('.', '_'))
    if key in sys.modules:
        return sys.modules[key]
    spec = importlib.util.spec_from_file_location(
        key, join(HERE, kind, name + '.py'))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules():
    """The forbidden top-level names that ``sys.modules`` holds."""
    tops = {name.split('.')[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def worst(values):
    """The largest of ``values``; NaN if any is NaN."""
    values = list(values)
    if any(math.isnan(v) for v in values):
        return float('nan')
    return max(values)


def sync(device):
    import torch
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


def free(device):
    import gc
    import torch
    gc.collect()
    if device.type == 'cuda':
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


@contextlib.contextmanager
def span(name):
    """A host span the profiler records (``record_function``)."""
    import torch
    with torch.profiler.record_function(name):
        yield


def launches(kernel_lib):
    """All the program's kernel wrappers' launches so far (each wrapper's
    ``launches`` counter; a graph replay counts what it runs)."""
    return sum(n for (_, attr), n in kernel_lib.launch_counts().items()
               if attr == 'launches')


def build_model(run):
    """The program's model of ``run.config``: its INI with every value of
    the configuration file set on top, and each sub-configuration (an
    experiment the model reads the INI of, as the joint model reads its
    BRDF prior's) written under ``run.tmp`` and named by its key."""
    from nerfactor_tpu_torch.models import get_model_class
    from nerfactor_tpu_torch.utils import config as configutil
    cfg = run.config
    parser = configutil.read_config(configutil.resolve_config_path(
        cfg['ini']))
    for key, sub in cfg.get('sub_configs', {}).items():
        sp = configutil.read_config(configutil.resolve_config_path(
            sub['ini']))
        for k, v in cfg[sub['values']].items():
            sp.set('DEFAULT', k, str(v))
        exp = join(run.tmp, key, 'exp')
        configutil.write_config(sp, exp + '.ini')
        parser.set('DEFAULT', key, join(exp, 'checkpoints', 'ckpt-0'))
    for k, v in cfg['values'].items():
        parser.set('DEFAULT', k, str(v))
    return get_model_class(parser.get('DEFAULT', 'model'))(
        configutil.Config(parser), device=run.device)


def find_cell(spec, workload):
    for cell in spec['workloads']:
        if cell['name'] == workload:
            return cell
    raise SystemExit("no workload %r in BENCHMARK.json" % workload)


def _applies(metric, workload):
    return 'workloads' not in metric or workload in metric['workloads']


def prepare(workload, patch=None, spec=None):
    """(cell, configuration, traffic, driver, limits) of ``workload``;
    ``patch`` updates the configuration's values and groups and the
    traffic's parameters (the tests' small sizes)."""
    cell = find_cell(spec or load_spec(), workload)
    config = load_json('configs', cell['config'])
    traffic = load_json('traffic', cell['traffic'])
    if patch:
        config['values'].update(patch.get('values', {}))
        for k, v in patch.get('config', {}).items():
            config[k].update(v)
        traffic.update(patch.get('traffic', {}))
    return (cell, config, traffic, load_module('drivers', traffic['driver']),
            load_json('checks', workload)['limits'])


def new_run(cell, config, traffic, seed, device, tmp):
    """What a driver is handed: the cell's names, sizes and seed."""
    return SimpleNamespace(workload=cell['name'], config=config,
                           config_name=cell['config'], traffic=traffic,
                           seed=seed, device=device, tmp=tmp)


def run_cell(workload, seed, seconds, trace, device, t_start, patch=None,
             spec=None):
    """Runs one cell once on ``device`` and returns its result line (a
    dict, the compared numbers last under ``checks``)."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    spec = spec or load_spec()
    cell, config, traffic, driver, limits = prepare(workload, patch, spec)
    on_card = device.type == 'cuda'
    with tempfile.TemporaryDirectory(prefix='perfbench_') as tmp:
        run = new_run(cell, config, traffic, seed, device, tmp)
        t_setup = _now()
        state = driver.setup(run)
        setup_s = _now() - t_start
        win = driver.window(state, seconds)
        peak = torch.cuda.max_memory_allocated(device) if on_card else 0
        traced = None
        if trace and on_card:
            traced = _trace(driver, state)
        driver.release(state)
        numbers = driver.readings(state)
    checks = {k: {'value': numbers[k], 'limit': limits[k]} for k in limits}
    correct = win['failed'] == 0 and all(
        not math.isnan(c['value']) and c['value'] <= c['limit']
        for c in checks.values())
    if trace:
        ctx = SimpleNamespace(workload=workload, config=config,
                              config_name=cell['config'],
                              traffic=traffic, window=win['layer'],
                              trace=traced,
                              counts=lambda name: load_module('counts', name))
        metrics = {}
        for m in spec['per_layer']:
            if not _applies(m, workload):
                continue
            value = load_module('metrics', m['name']).read(ctx)
            if value is not None:
                metrics[m['name']] = dict(value, unit=m['unit'])
    else:
        metrics = {}
        for m in spec['end_to_end']:
            if not _applies(m, workload):
                continue
            value = setup_s if m['name'] == 'setup_s' \
                else win['metrics'].get(m['name'])
            if value is not None:
                metrics[m['name']] = {'value': value, 'unit': m['unit']}
    result = {'correct': correct, 'attempted': win['attempted'],
              'failed': win['failed'], 'metrics': metrics,
              'device': {'platform': 'gpu' if on_card else device.type,
                         'kind': torch.cuda.get_device_name(device)
                         if on_card else 'cpu',
                         'count': 1, 'memory_peak_bytes': int(peak)}}
    if on_card:
        from perfbench import card
        result['device']['power'] = card.name_and_power()
    if traced is not None:
        result['device'].update(busy_s=traced['busy_s'],
                                window_s=traced['window_s'])
        result['breakdown'] = {
            'device_ops': [[k, v] for k, v in sorted(
                traced['by_name'].items(), key=lambda kv: -kv[1])[:10]],
            'idle_gaps': [list(g) for g in sorted(
                traced['gaps'], key=lambda g: -g[1])[:10]]}
    result['setup_parts'] = {'before_driver_s': t_setup - t_start,
                             'driver_s': setup_s - (t_setup - t_start)}
    result['checks'] = checks
    return result


def _trace(driver, state):
    from perfbench import card
    with card.profiler_window(warm=lambda: driver.trace_warm(state)) as prof:
        units = driver.trace_work(state)
    traced = card.reduce_trace(prof, after_gap_s=card.PROFILER_PAD_S / 2)
    if traced is None:
        raise RuntimeError("the profiler recorded no device operation")
    traced['units'] = units
    traced['power'] = card.name_and_power()
    return traced


def _now():
    import time
    return time.perf_counter()


def check_lines(result):
    """The compared numbers beside their limits, one a line."""
    return ['check %s %.6g limit %.6g' % (k, c['value'], c['limit'])
            for k, c in result['checks'].items()]
