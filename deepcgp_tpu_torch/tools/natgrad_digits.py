"""NatGrad-vs-Adam convergence sweep on real data, the UCI digits
(counterpart of the JAX repository's ``tools/natgrad_digits.py``).

The same seven settings of the knobs the reference exposes -- gamma0,
whitening and an Adam warm start -- on the fixed digits split and
schedule, held-out accuracy at every eval epoch and the ``steps_back``
backoff counter, one JSON record a setting.  Every setting runs in one
process, graphed on the card.  A setting that raises is recorded in the
JSON as its error, the sweep goes on, and the tool exits nonzero at the
end, so a failure cannot pass as a result.

    python -m deepcgp_tpu_torch.tools.natgrad_digits [--steps 4000]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import traceback
from types import SimpleNamespace

import torch

from deepcgp_tpu_torch import config as port_config
from deepcgp_tpu_torch.training import data, trainer

SWEEPS = [
    ('adam', dict(optimizer='Adam', gamma0=0.001)),
    ('ng-g1e-3', dict(optimizer='NatGrad', gamma0=0.001)),
    ('ng-g1e-2', dict(optimizer='NatGrad', gamma0=0.01)),
    ('ng-g3e-2', dict(optimizer='NatGrad', gamma0=0.03)),
    ('ng-g1e-1', dict(optimizer='NatGrad', gamma0=0.1)),
    ('ng-g1e-2-white', dict(optimizer='NatGrad', gamma0=0.01,
                            white=True)),
    ('ng-g1e-2-warm500', dict(optimizer='NatGrad', gamma0=0.01,
                              warm_adam_steps=500)),
]


def _log(msg):
    print(msg, file=sys.stderr, flush=True)


def _flags(white=False):
    return SimpleNamespace(N=1438, test_size=359, seed=0, M='64,64',
                           feature_maps='10', filter_sizes='3,3',
                           strides='1,1', num_samples=10, batch_size=64,
                           base_kernel='rbf', white=white,
                           last_kernel='conv', identity_mean=False)


def run_config(tag, *, optimizer, gamma0, white=False, warm_adam_steps=0,
               total_steps=4000, eval_every=500, lr=0.01,
               lr_decay_steps=7000, seed=1, device=None):
    from deepcgp_tpu_torch.models.builder import build_model
    device = port_config.default_device(device)
    f = _flags(white=white)
    xtr, ytr, xte, yte = data.digits_data(f)
    model = build_model(f, xtr.shape[1:], images=xtr,
                        generator=torch.Generator().manual_seed(0),
                        device=device)
    Xd = torch.as_tensor(xtr.reshape(len(xtr), -1), device=device)
    Yd = torch.as_tensor(ytr, device=device)
    Xte = torch.as_tensor(xte.reshape(len(xte), -1), device=device)
    Yte = torch.as_tensor(yte, device=device)

    if warm_adam_steps:
        cfg_a = trainer.TrainConfig(optimizer='Adam', lr=lr,
                                    lr_decay_steps=lr_decay_steps,
                                    gamma=gamma0, batch_size=f.batch_size)
        st = trainer.init_state(model, cfg_a, seed=seed)
        trainer.run_chunk(st, cfg_a, Xd, Yd, warm_adam_steps)

    config = trainer.TrainConfig(optimizer=optimizer, lr=lr,
                                 lr_decay_steps=lr_decay_steps, gamma=gamma0,
                                 batch_size=f.batch_size)
    state = trainer.init_state(model, config, seed=seed)

    accs, elbos = [], []
    peak = 0.0
    t0 = time.time()
    for _ in range(0, total_steps, eval_every):
        el = trainer.run_chunk(state, config, Xd, Yd, eval_every)
        acc = trainer.accuracy(state.model, Xte, Yte, seed=9,
                               batch_size=128, num_samples=5)
        accs.append(round(acc, 4))
        elbos.append(round(float(el[-1]), 1))
        peak = max(peak, acc)
    out = {
        'tag': tag, 'optimizer': optimizer, 'gamma0': gamma0,
        'white': white, 'warm_adam_steps': warm_adam_steps,
        'final_acc': accs[-1], 'peak_acc': round(peak, 4),
        'steps_back': (0.0 if state.steps_back is None
                       else float(state.steps_back)),
        'accs': accs, 'elbos': elbos,
        'wall_s': round(time.time() - t0, 1),
    }
    _log(f"[{tag}] {json.dumps(out)}")
    return out


def main(argv=None, device=None) -> int:
    """Run the sweep and print its JSON; 0 when every setting ran, 1 when
    one raised (its record holds the error)."""
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--steps', type=int, default=4000)
    ap.add_argument('--eval-every', type=int, default=500)
    ap.add_argument('--only', default=None,
                    help='comma list of tags to run')
    args = ap.parse_args(argv)
    device = port_config.default_device(device)
    _log(f"device: {device}"
         + (f" ({torch.cuda.get_device_name(device)})"
            if device.type == 'cuda' else ''))
    only = set(args.only.split(',')) if args.only else None
    results = []
    for tag, kw in SWEEPS:
        if only and tag not in only:
            continue
        try:
            results.append(run_config(tag, total_steps=args.steps,
                                      eval_every=args.eval_every,
                                      device=device, **kw))
        except Exception as e:  # keep the sweep going; record the failure
            _log(f"[{tag}] FAILED:\n{traceback.format_exc()}")
            results.append({'tag': tag, 'error': repr(e)})
    print(json.dumps(results, indent=1))
    return 1 if any('error' in r for r in results) else 0


if __name__ == '__main__':
    sys.exit(main())
