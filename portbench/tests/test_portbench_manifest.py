"""BENCHMARK.json against the benchmark's contract, and every file the
harness finds by a name in it."""

import json
import os
import re

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')


@pytest.fixture(scope='module')
def bench():
    with open(os.path.join(ROOT, 'BENCHMARK.json')) as f:
        return json.load(f)


def test_top_level_keys_and_paths(bench):
    assert set(bench) == {'command', 'paths', 'run_seconds', 'configs',
                          'workloads', 'end_to_end', 'per_layer'}
    assert bench['command'] == ['python3', 'portbench/run.py']
    assert bench['paths'] == ['portbench']
    assert isinstance(bench['run_seconds'], int)
    assert 1 <= bench['run_seconds'] <= 51
    assert os.path.getsize(os.path.join(ROOT, 'BENCHMARK.json')) <= 64 * 1024


def test_names_units_and_keys(bench):
    allowed = {'configs': {'name', 'source', 'file', 'reduced', 'why'},
               'workloads': {'name', 'config', 'traffic', 'chips', 'why'},
               'end_to_end': {'name', 'unit', 'better', 'bound', 'source',
                              'workloads'},
               'per_layer': {'name', 'unit', 'better', 'source', 'layer',
                             'moves', 'workloads'}}
    for section, keys in allowed.items():
        names = [e['name'] for e in bench[section]]
        assert len(names) == len(set(names)), section
        for e in bench[section]:
            assert set(e) <= keys, (section, e['name'])
            assert NAME.match(e['name']), e['name']
            for text in ('why', 'layer', 'source'):
                if text in e:
                    assert 1 <= len(e[text]) <= 200 and '\n' not in e[text]
    for m in bench['end_to_end'] + bench['per_layer']:
        assert UNIT.match(m['unit']), m['unit']
        assert m['better'] in ('lower', 'higher')
    for m in bench['end_to_end']:
        assert m['source'] in ('host_clock', 'device_trace')
        assert 0.01 <= m['bound'] <= 0.25
    for m in bench['per_layer']:
        assert m['source'] in ('device_trace', 'program_span',
                               'program_counter', 'host_clock')


def test_cells_configs_and_chips(bench):
    configs = {c['name'] for c in bench['configs']}
    used = {w['config'] for w in bench['workloads']}
    assert used == configs
    pairs = [(w['config'], w['traffic']) for w in bench['workloads']]
    assert len(pairs) == len(set(pairs))
    assert all(w['chips'] == 1 for w in bench['workloads'])
    for w in bench['workloads']:
        assert NAME.match(w['traffic'])
        for sub, name in (('traffic', w['traffic']), ('limits', w['name'])):
            assert os.path.exists(os.path.join(ROOT, 'portbench', sub,
                                               f'{name}.json')), (sub, name)


def test_config_files(bench):
    files = [c['file'] for c in bench['configs']]
    assert len(files) == len(set(files))
    for c in bench['configs']:
        assert c['file'].startswith('portbench/')
        assert c['reduced'] == []
        with open(os.path.join(ROOT, c['file'])) as f:
            config = json.load(f)
        assert config['name'] == c['name']
        assert config['reduced'] == c['reduced']
        assert 'assumed' in config


def test_every_cell_reports_setup_another_metric_and_a_layer(bench):
    for w in bench['workloads']:
        e2e = [m['name'] for m in bench['end_to_end']
               if w['name'] in m.get('workloads', [w['name']])]
        layer = [m for m in bench['per_layer']
                 if w['name'] in m.get('workloads', [w['name']])]
        assert 'setup_s' in e2e and len(e2e) >= 2, w['name']
        assert layer, w['name']


def test_every_per_layer_metric_moves_a_metric_its_cells_report(bench):
    e2e = {m['name']: m for m in bench['end_to_end']}
    layers = {}
    for m in bench['per_layer']:
        assert m['moves'] in e2e
        assert os.path.exists(os.path.join(ROOT, 'portbench', 'metrics',
                                           f'{m["name"]}.py')), m['name']
        for w in m['workloads']:
            assert w in e2e[m['moves']].get('workloads', [w]), (m['name'], w)
        layers.setdefault(m['layer'], []).append(m['name'])
    assert set(layers) == {'entry and graph replay', 'optimizer', 'model',
                           'kernels', 'device'}


def test_a_full_check_fits_with_24_cells(bench):
    runs = 2 + 14 * 24
    assert (runs * (bench['run_seconds'] + 60) + 24 * 2 * 90 + 1200
            <= 43200)


def test_paths_hold_only_names_of_the_allowed_characters():
    for dirpath, _, files in os.walk(os.path.join(ROOT, 'portbench')):
        if '__pycache__' in dirpath:
            continue
        for f in files:
            rel = os.path.relpath(os.path.join(dirpath, f), ROOT)
            assert re.match(r'^[A-Za-z0-9_./-]{1,200}$', rel), rel
