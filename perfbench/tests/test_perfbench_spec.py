"""``BENCHMARK.json`` against its contract: keys, names, units and
characters; every name resolving to its file under ``perfbench/``; each
per-layer metric's ``moves`` reported in every cell that lists it."""

import os
import re

import pytest

from perfbench import harness

SPEC = harness.load_spec()
NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')
KEYS = {'command', 'paths', 'run_seconds', 'configs', 'workloads',
        'end_to_end', 'per_layer'}


def text_ok(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and '\n' not in s \
        and '\t' not in s


def test_top_level():
    assert set(SPEC) == KEYS
    assert 1 <= len(SPEC['paths']) <= 16 and SPEC['paths'] == ['perfbench']
    assert len(SPEC['command']) <= 32 and all(map(text_ok, SPEC['command']))
    assert isinstance(SPEC['run_seconds'], int) \
        and 1 <= SPEC['run_seconds'] <= 51
    assert os.path.getsize(os.path.join(harness.ROOT, 'BENCHMARK.json')) \
        <= 64 * 1024


def test_configs():
    used = {w['config'] for w in SPEC['workloads']}
    files = set()
    for c in SPEC['configs']:
        assert set(c) == {'name', 'source', 'file', 'reduced', 'why'}
        assert NAME.match(c['name']) and text_ok(c['why'])
        assert text_ok(c['source']) and c['source'].startswith('https://')
        assert c['file'] == 'perfbench/configs/%s.json' % c['name']
        assert c['file'] not in files
        files.add(c['file'])
        body = harness.load_json('configs', c['name'])
        assert body['reduced'] == c['reduced'] and body['source'] == \
            c['source']
        assert all(NAME.match(k) for k in c['reduced'])
        assert not any(k.endswith(('_dim', '_rank', 'width')) for k in
                       c['reduced'])
        assert c['name'] in used
        assert os.path.exists(os.path.join(harness.HERE, 'reference',
                                           c['name'] + '.py'))


def test_workloads():
    pairs = set()
    for w in SPEC['workloads']:
        assert set(w) == {'name', 'config', 'traffic', 'chips', 'why'}
        assert NAME.match(w['name']) and NAME.match(w['traffic'])
        assert text_ok(w['why']) and w['chips'] in (1, 4)
        assert (w['config'], w['traffic']) not in pairs
        pairs.add((w['config'], w['traffic']))
        traffic = harness.load_json('traffic', w['traffic'])
        assert os.path.exists(os.path.join(harness.HERE, 'drivers',
                                           traffic['driver'] + '.py'))
        assert set(harness.load_json('checks', w['name'])['limits'])
    assert sum(w['chips'] == 4 for w in SPEC['workloads']) <= max(
        1, len(SPEC['workloads']) // 4)


def reported(workload):
    return {m['name'] for m in SPEC['end_to_end']
            if 'workloads' not in m or workload in m['workloads']}


@pytest.mark.parametrize('kind', ['end_to_end', 'per_layer'])
def test_metrics(kind):
    names = [m['name'] for m in SPEC['end_to_end'] + SPEC['per_layer']]
    assert len(names) == len(set(names))
    cells = {w['name'] for w in SPEC['workloads']}
    for m in SPEC[kind]:
        assert NAME.match(m['name']) and UNIT.match(m['unit'])
        assert m['better'] in ('lower', 'higher')
        assert set(m.get('workloads', [])) <= cells
        if kind == 'end_to_end':
            assert set(m) - {'workloads'} == {'name', 'unit', 'better',
                                              'bound', 'source'}
            assert m['source'] in ('host_clock', 'device_trace')
            cap = 0.25
            assert 0.01 <= m['bound'] <= cap
        else:
            assert set(m) - {'workloads'} == {'name', 'unit', 'better',
                                              'source', 'layer', 'moves'}
            assert m['source'] in ('device_trace', 'program_span',
                                   'program_counter', 'host_clock')
            assert text_ok(m['layer'])
            assert os.path.exists(os.path.join(harness.HERE, 'metrics',
                                               m['name'] + '.py'))
            for w in m.get('workloads', cells):
                assert m['moves'] in reported(w)
            if 'roofline' in m['name'] or 'mfu' in m['name']:
                assert m['unit'] == '%'


def test_every_cell_reports_enough():
    for w in SPEC['workloads']:
        got = reported(w['name'])
        assert 'setup_s' in got and len(got) >= 2
        assert any('workloads' not in m or w['name'] in m['workloads']
                   for m in SPEC['per_layer'])


def test_file_names():
    allowed = re.compile(r'^[A-Za-z0-9_./-]+$')
    for dirpath, _, files in os.walk(harness.HERE):
        if '__pycache__' in dirpath:
            continue
        for f in files:
            rel = os.path.relpath(os.path.join(dirpath, f), harness.ROOT)
            assert allowed.match(rel) and len(rel) <= 200, rel
