"""What the benchmark may load: nothing of JAX or the JAX package (top-level
names compared whole: the port's name begins with the JAX package's),
nothing of the program in the references, and not the root bench.py."""

import ast
import os
import subprocess
import sys

import pytest

from perfbench import harness

SOURCES = [os.path.join(d, f) for d, _, fs in os.walk(harness.HERE)
           for f in fs if f.endswith('.py')]


def imported_tops(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops.update(a.name.split('.')[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module \
                and not node.level:
            tops.add(node.module.split('.')[0])
    return tops


@pytest.mark.parametrize('path', SOURCES,
                         ids=[os.path.relpath(p, harness.HERE)
                              for p in SOURCES])
def test_sources_import_no_jax(path):
    assert not imported_tops(path) & set(harness.FORBIDDEN + ('bench',))
    if os.sep + 'tests' + os.sep not in path:
        with open(path) as f:
            assert 'bench.py' not in f.read().replace('perfbench', '')


@pytest.mark.parametrize('path', [p for p in SOURCES
                                  if os.sep + 'reference' + os.sep in p])
def test_reference_imports_nothing_of_the_program(path):
    assert 'nerfactor_tpu_torch' not in imported_tops(path)


def test_loading_the_references_loads_no_program():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from perfbench import harness\n"
            "for n in ('nerfactor_joint', 'nerf'):\n"
            "    harness.load_module('reference', n)\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('nerfactor_tpu_torch',) + harness.FORBIDDEN))" % harness.ROOT)
    out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, check=True, timeout=120)
    assert out.stdout.strip() == '[]'


def test_the_check_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, 'nerfactor_tpu_torch_fake', object())
    monkeypatch.setitem(sys.modules, 'jaxfake.sub', object())
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, 'nerfactor_tpu.models', object())
    assert harness.forbidden_modules() == ['nerfactor_tpu']
