"""The port's new modules and run scripts without JAX (CPU): every module
this slice added imports in a subprocess with ``jax``, ``jaxlib`` and the
JAX package (``nerfactor_tpu``, ``brdf_tpu``, ``data_gen_tpu``) blocked,
and each ``scripts/torch_*_run.sh`` wrapper runs its CLI's ``--help``
with rc 0 under the same blocks (a ``sitecustomize`` on PYTHONPATH sets
them before the CLI starts; the wrappers run side by side).
"""

import os
import subprocess
import sys
from os.path import dirname, join

import pytest

REPO = dirname(dirname(os.path.abspath(__file__)))


BLOCKED = ('jax', 'jaxlib', 'nerfactor_tpu', 'brdf_tpu', 'data_gen_tpu')
NEW_MODULES = (
    'nerfactor_tpu_torch.utils.io',
    'nerfactor_tpu_torch.brdf.merl',
    'nerfactor_tpu_torch.data_gen.poses',
    'nerfactor_tpu_torch.data_gen.nerf_real_make_dataset',
    'nerfactor_tpu_torch.data_gen.dtu_make_dataset',
    'nerfactor_tpu_torch.data_gen.dtu_make_dataset_from_raw',
    'nerfactor_tpu_torch.data_gen.merl_make_dataset',
    'nerfactor_tpu_torch.data_gen.nerf_synth_render',
    'nerfactor_tpu_torch.debug',
    'nerfactor_tpu_torch.debug.dataloader',
    'nerfactor_tpu_torch.trainvali',
    'nerfactor_tpu_torch.tools.synth_llff',
    'nerfactor_tpu_torch.tools.synth_dtu',
)


def test_new_modules_import_without_jax():
    code = ("import importlib, sys\n"
            "for m in %r:\n"
            "    sys.modules[m] = None\n"
            "for m in sys.argv[1:]:\n"
            "    importlib.import_module(m)\n"
            "print('ok')\n" % (BLOCKED,))
    proc = subprocess.run(
        [sys.executable, '-c', code, *NEW_MODULES], cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO), capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.strip() == 'ok'


SCRIPTS = ('torch_trainvali_run.sh', 'torch_test_run.sh',
           'torch_nerf_test_run.sh', 'torch_geometry_from_nerf_run.sh',
           'torch_explore_brdf_space_run.sh', 'torch_mvs_run.sh')


@pytest.fixture(scope='module')
def script_runs(tmp_path_factory):
    """Every wrapper's ``--help``, run side by side: script -> (rc,
    stdout, stderr). ``python`` on PATH is this interpreter."""
    tmp = tmp_path_factory.mktemp('scripts')
    with open(str(tmp / 'sitecustomize.py'), 'w') as h:
        h.write("import sys\nfor m in %r:\n    sys.modules[m] = None\n"
                % (BLOCKED,))
    bindir = tmp / 'bin'
    bindir.mkdir()
    shim = str(bindir / 'python')
    with open(shim, 'w') as h:
        h.write('#!/bin/sh\nexec %s "$@"\n' % sys.executable)
    os.chmod(shim, 0o755)
    env = dict(os.environ, PYTHONPATH=str(tmp),
               PATH=str(bindir) + os.pathsep + os.environ['PATH'])
    procs = {s: subprocess.Popen(
        ['bash', join(REPO, 'scripts', s), '--help'], cwd=str(tmp), env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for s in SCRIPTS}
    out = {}
    for s, proc in procs.items():
        stdout, stderr = proc.communicate(timeout=300)
        out[s] = (proc.returncode, stdout, stderr)
    return out


@pytest.mark.parametrize('script', SCRIPTS)
def test_script_help_without_jax(script, script_runs):
    rc, stdout, stderr = script_runs[script]
    assert rc == 0, stderr[-4000:]
    assert stdout.startswith('usage:')
