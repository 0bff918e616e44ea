#!/usr/bin/env python3
"""One benchmark cell's set-up and window (``portbench/kinds``), then the
port's own spans read without the profiler (``utils.profiling``): the
graph captures over the window (``COUNTERS['graph captures']``), one
stretch of 100 steps or requests under ``profiling.recording()`` (the
device's idle share, each span's count and self ms, the idle by span,
a request's host ms less its wait), the same stretch under the
profiler as the benchmark traces it (the idle share by hand: 1 - traced
busy ms a unit x the window's rate), and an A/B of short windows with
the recorder off and on, alternated (the recorder's cost when on).

    python3 tools/torch_span_probe.py --workload <cell> --seed <n>
        [--seconds 20] [--ab 3] [--ab-seconds 8] [--out FILE]

Prints one JSON line (and appends it to ``--out``); the summary's self ms
and idle by span go to standard error.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
import types

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
UNITS = 100
WARM = 10


def _log(msg: str) -> None:
    print(f'[span_probe] {msg}', file=sys.stderr, flush=True)


def recorded(fn, units: int) -> dict:
    """fn() (``units`` steps or requests, ending in a wait for the card)
    under the recorder: its summary, rate and per-request host ms."""
    from deepcgp_tpu_torch.utils import profiling
    with profiling.recording(events=8 * units) as rec:
        fn()
    out = rec.summary()
    out['idle_pct'] = 100.0 * (1.0 - out['busy_ns'] / out['wall_ns'])
    out['rate'] = units / (out['wall_ns'] / 1e9)
    waits = {s.parent: s.end_ns - s.start_ns for s in rec.spans
             if s.name == 'serve wait'}
    hosts = [(s.end_ns - s.start_ns - waits.get(s.id, 0)) / 1e6
             for s in rec.spans if s.parent is None
             and s.name in ('predict_proba', 'log_density')]
    if hosts:
        out['host_ms_per_request'] = statistics.fmean(hosts)
    return out


def window(unit, seconds: float, per_unit: int, record: bool,
           events: int = 0) -> dict:
    """Units in a closed loop for ``seconds``: rate and p95 ms of a unit,
    with the recorder on (``events`` CUDA events made before the clock
    starts) or off."""
    import contextlib

    import numpy as np

    from deepcgp_tpu_torch.utils import profiling
    with (profiling.recording(events=events) if record
          else contextlib.nullcontext()):
        lat, t0 = [], time.perf_counter()
        while True:
            t = time.perf_counter()
            unit()
            lat.append(time.perf_counter() - t)
            elapsed = time.perf_counter() - t0
            if elapsed >= seconds:
                break
    return {'recorder': record, 'rate': per_unit * len(lat) / elapsed,
            'p95_ms': 1e3 * float(np.percentile(lat, 95)), 'units': len(lat)}


def probe(spec: dict, seed: int, seconds: float, ab: int, ab_seconds: float,
          device='cuda') -> dict:
    import torch

    from deepcgp_tpu_torch.utils import profiling
    from portbench import program, tracing
    from portbench.kinds import serve, train
    cfg, tr = spec['config'], spec['traffic']
    cuda = torch.device(device).type == 'cuda'

    def sync():
        if cuda:
            torch.cuda.synchronize()
    out = {'workload': spec['name'], 'seed': seed}
    ctx = types.SimpleNamespace(log=_log)
    if tr['kind'] == 'train':
        start = train.checked_start(cfg, tr, seed, device)
        state, tc, X, Y = start['state'], start['tc'], start['X'], start['Y']
        chunk = tr['chunk_steps']

        def unit(steps=chunk):
            program.run_chunk(state, tc, X, Y, steps)
            sync()
        unit()
        per_unit, rows = chunk, 1
    else:
        s = serve.Session(cfg, tr, seed, device, _log)
        for _ in range(tr['warmup_requests']):
            s.request()

        def unit():
            s.request()
        per_unit, rows = 1, tr['rows']
    before = profiling.COUNTERS['graph captures']
    win = window(unit, seconds, per_unit * rows, False)
    out['graph_captures'] = profiling.COUNTERS['graph captures'] - before
    out['window'] = win
    unit_rate = win['rate'] / rows          # steps or requests a second
    if cuda:
        if tr['kind'] == 'train':
            _, trace = train.traced_stretch(ctx, state, tc, X, Y, UNITS)
        else:
            def stretch():
                for _ in range(tracing.WARM):
                    s.request()
                sync()
                with torch.profiler.record_function(tracing.WINDOW):
                    for _ in range(UNITS):
                        s.request()
            trace = serve.traced_stretch(ctx, stretch)
        busy_s, window_s = tracing.busy_and_window_s(trace)
        out['traced'] = {
            'idle_pct': 100.0 * (1.0 - busy_s / window_s),
            'busy_ms_per_unit': 1e3 * busy_s / UNITS,
            'idle_pct_by_hand': 100.0 * (1.0 - busy_s / UNITS * unit_rate),
            'idle_gaps': tracing.breakdown(trace)['idle_gaps']}
    if tr['kind'] == 'train':
        unit(WARM)

        def stretch():
            unit(UNITS)
    else:
        for _ in range(WARM):
            s.request()

        def stretch():
            for _ in range(UNITS):
                s.request()
            sync()
    rec = recorded(stretch, UNITS)
    rec['rate_against_window'] = rec['rate'] / unit_rate
    out['recorded'] = rec
    _log('self ms by span: ' + json.dumps(
        {k: round(v['self_ms'], 3) for k, v in rec['spans'].items()}))
    _log('idle ms by span: ' + json.dumps(
        {k: round(v, 3) for k, v in rec['idle_ms'].items()}))
    # Device spans a unit: 2 events each, a replay a step or 4 spans a
    # request; half as many again for a fast run.
    events = int(3 * unit_rate * ab_seconds * (per_unit if per_unit > 1
                                                else 4)) + 64
    out['ab'] = [window(unit, ab_seconds, per_unit * rows, on, events)
                 for _ in range(ab) for on in (False, True)]
    if tr['kind'] != 'train':
        s.close()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, default=20.0)
    ap.add_argument('--ab', type=int, default=3)
    ap.add_argument('--ab-seconds', type=float, default=8.0)
    ap.add_argument('--out')
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import torch
    if not torch.cuda.is_available():
        print('torch_span_probe: needs a CUDA card', file=sys.stderr)
        return 2
    from portbench import harness, program
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True, check=True).stdout.strip()
    program.build_kernels()
    out = probe(harness.cell(args.workload), args.seed, args.seconds,
                args.ab, args.ab_seconds)
    out['card'] = card
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, 'a') as f:
            f.write(line + '\n')
    return 0


if __name__ == '__main__':
    sys.exit(main())
