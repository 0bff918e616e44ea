"""The readings that the limits of a NatGrad training cell
(``portbench/limits/<cell>.json``, kind ``train_natgrad``) are set from, at
the cell's own size on the device it is started on:

    python3 portbench/calibrate_natgrad.py --workload <cell> --seeds 1,2,3

For each seed one JSON line on standard output with the numbers compared
(``kinds/train_natgrad.CHECKS``) of the program (its lower reading), of
the control (the reference in TF32 put in the program's place) and of the
reference with a fault planted: half of each batch left out (the mean
taken over the rest), the natural-gradient half skipped (q_mu and q_sqrt
left as they are) and gamma doubled (the upper readings); and, as a
witness, of the reference in plain float32.  Each reading carries its
``steps_back`` after each checked step, and the line carries the
reference's ``margins``: per checked step, the smallest eigenvalue over
the GPs of G = I + gamma (tril(X) + tril(X, -1)^T), X = W^T dW, the matrix
whose leaving the PD cone backs the step off (a seed whose margin lies
near 0 could back off on one side only).  The benchmark's own runs do not
run this.
"""

import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:] = [ROOT] + [p for p in sys.path if os.path.abspath(p or '.') != HERE]

# (label, the reference's precision, its planted fault)
READINGS = (('control', 'tf32', {}), ('float32', 'float32', {}),
            ('half_batch', 'float64', {'half_batch': True}),
            ('natgrad_skipped', 'float64', {'natgrad': False}),
            ('gamma_doubled', 'float64', {'gamma_scale': 2.0}))


def margins(start, cfg, tr) -> list:
    """Per checked step, the smallest eigenvalue of the float64
    reference's G over the GPs, from its W, its gradient dW and its
    gamma."""
    import torch

    from portbench.kinds import train_natgrad as kind
    from portbench.reference import svgp
    from portbench.reference.convgp import Arith
    X, Y = start['X'], start['Y']
    g = torch.Generator(device=X.device)
    g.manual_seed(start['train_seed'])
    t = svgp.Trainer(Arith('float64'), svgp.initial_params(start['weights']),
                     cfg, tr, g, noise_dtype=X.dtype)
    out = []
    for _ in range(kind.CHECKED_STEPS):
        gamma = svgp.gamma_schedule(t.step_count, t.steps_back, cfg['gamma'])
        W = torch.tril(t.params[svgp.Q_SQRT])
        _, grads = t.step(X, Y)
        t.final_check(X, Y)
        Xw = W.transpose(-1, -2) @ torch.tril(grads[svgp.Q_SQRT])
        G = gamma * (torch.tril(Xw) + torch.tril(Xw, -1).transpose(-1, -2))
        G = G + torch.eye(G.shape[-1], dtype=G.dtype, device=G.device)
        out.append(float(torch.linalg.eigvalsh(G).min()))
    return out


def readings(spec, seed, device, log):
    from portbench import program
    from portbench.kinds import train_natgrad as kind
    cfg, tr = spec['config'], spec['traffic']
    start = kind.checked_start(cfg, tr, seed, device)
    del start['state']
    program.release(device)
    ref64 = kind.reference(start, cfg, tr)
    out = {}
    for label, arith, faults in (('program', None, None),) + READINGS:
        got = (start['readings'] if arith is None
               else kind.reference(start, cfg, tr, arith, **faults))
        numbers = kind.numbers(got, ref64, start['p0'])
        d = numbers['detail']
        log(f'{label}: losses {d["losses"]}, reference {d["reference_losses"]}')
        out[label] = {k: numbers[k] for k in kind.CHECKS}
        out[label]['steps_back'] = d['steps_back']
        out[label]['natgrad_step'] = d['natgrad_step']
        out[label]['leaves'] = {k: d[k] for k in ('grad_gaps', 'natgrad_gaps',
                                                  'change_gaps')}
    out['margins'] = margins(start, cfg, tr)
    out['reference_steps_back'] = ref64[4]
    return out


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seeds', required=True)
    ap.add_argument('--device', default='cuda')
    args = ap.parse_args(argv)
    from portbench import harness, program

    def log(msg):
        print(f'[calibrate] {msg}', file=sys.stderr, flush=True)

    spec = harness.cell(args.workload)
    if spec['traffic']['kind'] != 'train_natgrad':
        raise SystemExit(f'{args.workload}: not a train_natgrad cell')
    if args.device == 'cuda':
        program.build_kernels()
    for seed in [int(s) for s in args.seeds.split(',')]:
        t = time.perf_counter()
        out = readings(spec, seed, args.device, log)
        print(json.dumps({'workload': args.workload, 'seed': seed, **out,
                          'seconds': time.perf_counter() - t}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
