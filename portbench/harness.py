"""The harness: runs one cell of ``BENCHMARK.json`` once and builds the
result line.

It holds no code of its own for any cell.  A cell names a configuration
(``portbench/configs/<config>.json``) and a traffic mix
(``portbench/traffic/<traffic>.json``); the mix's ``kind`` names the
runner (``portbench/kinds/<kind>.py``); the numbers that decide
``correct`` have their limits in ``portbench/limits/<cell>.json``; each
per-layer metric is read by ``portbench/metrics/<metric>.py``.  A later
cell or metric is new files and new manifest entries.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import os
import sys
import types

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# Top-level modules that may not be loaded in a run, compared whole.
FORBIDDEN_MODULES = ('jax', 'jaxlib', 'flax', 'deepcgp_tpu')


def process_age_s() -> float:
    """Seconds since this process started, from the kernel's record."""
    with open('/proc/self/stat') as f:
        fields = f.read().rsplit(')', 1)[1].split()
    with open('/proc/uptime') as f:
        uptime = float(f.read().split()[0])
    return uptime - int(fields[19]) / os.sysconf('SC_CLK_TCK')


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest() -> dict:
    return _json(os.path.join(ROOT, 'BENCHMARK.json'))


def cell(name: str, bench: dict | None = None) -> dict:
    """The cell's manifest entry, configuration, traffic mix, limits and
    metric entries."""
    bench = bench or manifest()
    entry = next((w for w in bench['workloads'] if w['name'] == name), None)
    if entry is None:
        raise KeyError(f'no workload {name!r} in BENCHMARK.json')
    config = next(c for c in bench['configs'] if c['name'] == entry['config'])
    from portbench import compare
    return {'name': name, 'entry': entry,
            'config': _json(os.path.join(ROOT, config['file'])),
            'traffic': _json(os.path.join(HERE, 'traffic',
                                          f'{entry["traffic"]}.json')),
            'limits': compare.limits(name),
            'end_to_end': [m for m in bench['end_to_end']
                           if name in m.get('workloads', [name])],
            'per_layer': [m for m in bench['per_layer']
                          if name in m.get('workloads', [name])]}


def read_metric(name: str, reading) -> float | None:
    """``portbench/metrics/<name>.py``'s ``read(reading)``."""
    path = os.path.join(HERE, 'metrics', f'{name}.py')
    spec = importlib.util.spec_from_file_location(
        'portbench_metric_' + name.replace('.', '_'), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read(reading)


class Context:
    """What a kind's runner reads (the cell, the seed, the window's
    length, the device) and what it reports."""

    def __init__(self, spec: dict, seed: int, seconds: float, trace: bool,
                 device):
        import torch
        self.name = spec['name']
        self.config, self.traffic = spec['config'], spec['traffic']
        self.limits = spec['limits']
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device = torch.device(device)
        self.metrics: dict = {}
        self.checks: list = []
        self.attempted = self.failed = 0
        self.setup_s = None
        self.reading = None
        self.peak_bytes = 0
        self.busy_s = self.window_s = None
        self.breakdown = None

    def log(self, msg: str) -> None:
        print(f'[portbench] {msg}', file=sys.stderr, flush=True)

    def synchronize(self) -> None:
        import torch
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)

    def setup_done(self) -> None:
        self.setup_s = process_age_s()
        self.log(f'set-up done at {self.setup_s:.3f} s')

    def metric(self, name: str, value: float) -> None:
        self.metrics[name] = value

    def count(self, attempted: int, failed: int) -> None:
        self.attempted, self.failed = attempted, failed

    def traced(self, trace, units: int, sources=None) -> None:
        """The traced stretch of ``units`` steps or requests."""
        from portbench import tracing
        self.busy_s, self.window_s = tracing.busy_and_window_s(trace)
        self.breakdown = tracing.breakdown(trace)
        self.reading = types.SimpleNamespace(
            kind=self.traffic['kind'], workload=self.name,
            config=self.config, traffic=self.traffic, units=units,
            busy_s=self.busy_s, window_s=self.window_s, sources=sources)

    def memory_peak(self) -> None:
        import torch
        if self.device.type == 'cuda':
            self.peak_bytes = torch.cuda.max_memory_reserved(self.device)

    def check(self, name: str, value: float) -> None:
        self.checks.append((name, value, self.limits[name]))


def run_cell(spec: dict, seed: int, seconds: float, trace: bool,
             device='cuda') -> dict:
    """Run the cell once: the result line's object, with ``checks``, each
    number compared and its limit, as its last key."""
    kind = importlib.import_module(f'portbench.kinds.{spec["traffic"]["kind"]}')
    ctx = Context(spec, seed, seconds, trace, device)
    kind.run(ctx)
    if trace:
        metrics = {}
        for m in spec['per_layer']:
            value = read_metric(m['name'], ctx.reading)
            if value is not None:
                metrics[m['name']] = {'value': value, 'unit': m['unit']}
    else:
        ctx.metrics['setup_s'] = ctx.setup_s
        metrics = {m['name']: {'value': ctx.metrics[m['name']],
                               'unit': m['unit']}
                   for m in spec['end_to_end']}
    correct = all(math.isfinite(v) and v <= limit
                  for _, v, limit in ctx.checks) and bool(ctx.checks)
    import torch
    device_info = {'platform': 'gpu' if ctx.device.type == 'cuda' else 'cpu',
                   'kind': (torch.cuda.get_device_name(ctx.device)
                            if ctx.device.type == 'cuda' else 'cpu'),
                   'count': 1, 'memory_peak_bytes': ctx.peak_bytes}
    if trace:
        device_info.update(busy_s=ctx.busy_s, window_s=ctx.window_s)
    out = {'correct': correct, 'attempted': ctx.attempted,
           'failed': ctx.failed, 'metrics': metrics, 'device': device_info}
    if trace and ctx.breakdown is not None:
        out['breakdown'] = ctx.breakdown
    out['checks'] = {name: {'value': v, 'limit': limit}
                     for name, v, limit in ctx.checks}
    return out


def forbidden_loaded() -> list:
    return sorted({m.split('.')[0] for m in sys.modules}
                  & set(FORBIDDEN_MODULES))


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description='Run one benchmark cell once.')
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    import torch
    spec = cell(args.workload)
    chips = spec['entry']['chips']
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f'portbench: the cell needs {chips} CUDA device(s); '
              f'{torch.cuda.device_count() if torch.cuda.is_available() else 0}'
              ' found', file=sys.stderr)
        return 2
    from portbench import program
    compile_s = program.build_kernels()
    print(f'[portbench] kernels built in {compile_s:.3f} s', file=sys.stderr,
          flush=True)
    out = run_cell(spec, args.seed, args.seconds, bool(args.trace))
    out['compile_s'] = compile_s
    found = forbidden_loaded()
    if found:
        print(f'portbench: {found} loaded in the run\'s process',
              file=sys.stderr)
        return 3
    checks = out.pop('checks')
    out['checks'] = checks
    for name, c in checks.items():
        print(f'check {name} = {c["value"]!r} (limit {c["limit"]!r})',
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
