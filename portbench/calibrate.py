"""The readings that the limits of ``portbench/limits/<cell>.json`` are set
from, at the cell's own size on the device it is started on:

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3 [--seconds 2]

For each seed one JSON line on standard output with the numbers compared
of the program (its lower reading), of the control (the reference in
TF32 put in the program's place: the upper reading) and, for a training
cell, of the reference with half of each batch left out and the mean
taken over the rest (a fault).  A training cell's readings need no
window; a serving cell's come from a window of ``--seconds`` at the
cell's own load, compared as a run compares them.  The benchmark's own
runs do not run this.
"""

import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:] = [ROOT] + [p for p in sys.path if os.path.abspath(p or '.') != HERE]


def training(spec, seed, device, log):
    from portbench import compare, program
    from portbench.kinds import train
    cfg, tr = spec['config'], spec['traffic']
    start = train.checked_start(cfg, tr, seed, device)
    del start['state']
    program.release(device)
    ref64 = train.reference(start, cfg, tr, seed)
    out = {}
    for label, readings in (
            ('program', start['readings']),
            ('control', train.reference(start, cfg, tr, seed, 'tf32')),
            ('float32', train.reference(start, cfg, tr, seed, 'float32')),
            ('half_batch', train.reference(start, cfg, tr, seed,
                                           half_batch=True))):
        numbers = compare.training_numbers(readings, ref64, start['p0'])
        d = numbers['detail']
        log(f'{label}: losses {d["losses"]}, reference {d["reference_losses"]}')
        out[label] = {k: numbers[k] for k in ('loss_rel', 'grad_gap',
                                              'change_gap',
                                              'grad_err_median')}
        out[label]['leaves'] = {
            'loss_rels': [abs(a - b) / abs(b) for a, b in
                          zip(d['losses'], d['reference_losses'])],
            **{k: d[k] for k in ('grad_gaps', 'change_gaps', 'grad_errors')}}
    return out


def serving(spec, seed, seconds, device, log):
    from portbench import inputs
    from portbench.kinds import serve
    s = serve.Session(spec['config'], spec['traffic'], seed, device, log)
    try:
        for _ in range(spec['traffic']['warmup_requests']):
            s.request()
        answers, t0 = [], time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            k, p, _ = s.request()
            answers.append((k, p))
    finally:
        s.close()
    pick = inputs.subseed(seed, 'sample')
    return {label: {'prob_gap': s.numbers(answers, pick, arith)['prob_gap']}
            for label, arith in (('program', 'float64'), ('control', 'tf32'),
                                 ('float32', 'float32'))} | {
        'requests': len(answers)}


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seeds', required=True)
    ap.add_argument('--seconds', type=float, default=2.0)
    ap.add_argument('--device', default='cuda')
    args = ap.parse_args(argv)
    from portbench import harness, program

    def log(msg):
        print(f'[calibrate] {msg}', file=sys.stderr, flush=True)

    spec = harness.cell(args.workload)
    if args.device == 'cuda':
        program.build_kernels()
    for seed in [int(s) for s in args.seeds.split(',')]:
        t = time.perf_counter()
        if spec['traffic']['kind'] == 'train':
            out = training(spec, seed, args.device, log)
        else:
            out = serving(spec, seed, args.seconds, args.device, log)
        print(json.dumps({'workload': args.workload, 'seed': seed, **out,
                          'seconds': time.perf_counter() - t}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
