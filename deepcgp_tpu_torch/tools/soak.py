"""NatGrad / Adam soak on learnable data (counterpart of the JAX
repository's ``tools/soak.py``).

Random images are unlearnable noise; the soak trains on separable
Gaussian blobs (``training.data.learnable_blobs``) so optimizer health is
observable: in chunks of graphed ``run_chunk`` steps, every ELBO must
stay finite (no NaN step, ``steps_back == 0``: NatGrad never backed off)
and the last ELBO finite, as the JAX tool gates it; train accuracy is
printed beside.  ``SOAK FAIL`` exits nonzero.

    python -m deepcgp_tpu_torch.tools.soak --config flagship --steps 10000
"""

from __future__ import annotations

import argparse
import sys
import time
import types

import numpy as np
import torch

from deepcgp_tpu_torch import config as port_config
from deepcgp_tpu_torch.training import data, trainer

FLAGSHIP = dict(M='384,384', feature_maps='10', filter_sizes='5,5',
                strides='3,1', base_kernel='rbf', last_kernel='conv',
                white=False, identity_mean=False)
M1024 = dict(M='1024', feature_maps='', filter_sizes='5', strides='1',
             base_kernel='rbf', last_kernel='rbf', white=False,
             identity_mean=False)
# name: (builder flags, image, batch) as tools/soak.py:54-64.
CONFIGS = {'flagship': (FLAGSHIP, (32, 32, 3), 32),
           'm1024': (M1024, (28, 28, 1), 128)}
NUM_SAMPLES, IMAGES = 10, 2048


def build(config: str, seed: int = 0, device=None):
    """(model, X [N, D], Y [N, 1]) of the configuration on the blobs; the
    data stay fixed, the initialisation follows ``seed``."""
    from deepcgp_tpu_torch.models.builder import build_model
    flags, image, _ = CONFIGS[config]
    device = port_config.default_device(device)
    X, Y = data.learnable_blobs(IMAGES, image, 10, 0)
    t0 = time.time()
    model = build_model(types.SimpleNamespace(**flags, num_samples=NUM_SAMPLES),
                        image, images=X,
                        generator=torch.Generator().manual_seed(100 * seed),
                        device=device)
    print(f"model built in {time.time() - t0:.1f}s", flush=True)
    return (model, torch.as_tensor(X.reshape(len(X), -1), device=device),
            torch.as_tensor(Y, device=device))


def soak(model, X, Y, label: str, optimizer: str, batch_size: int,
         steps: int, chunk: int, seed: int = 0) -> dict:
    """Chunks of ``chunk`` steps until ``steps`` are done, one line a chunk,
    then train accuracy and the verdict line.  Returns the verdict, the
    ELBO trace, nan_steps, steps_back, train accuracy and steps/s."""
    config = trainer.TrainConfig(optimizer=optimizer, lr=0.01,
                                 lr_decay_steps=100000, gamma=0.001,
                                 batch_size=batch_size)
    state = trainer.init_state(model, config, seed=100 * seed + 1)
    trace, nan_steps, done = [], 0, 0
    t0 = time.time()
    while done < steps:
        e = trainer.run_chunk(state, config, X, Y, chunk).cpu().numpy()
        trace.append(e)
        nan_steps += int(np.sum(~np.isfinite(e)))
        done += chunk
        sps = done / (time.time() - t0)
        print(f"step {done}: elbo {float(e[-1]):.1f} "
              f"(mean {float(np.nanmean(e)):.1f}), "
              f"steps_back {steps_back(state):.0f}, "
              f"nan_steps {nan_steps}, {sps:.0f} steps/s", flush=True)
    acc = trainer.accuracy(state.model, X, Y, seed=9, batch_size=128,
                           num_samples=5)
    last = float(trace[-1][-1])
    ok = nan_steps == 0 and steps_back(state) == 0.0 and np.isfinite(last)
    print(f"SOAK {'OK' if ok else 'FAIL'}: {label} {optimizer} "
          f"{steps} steps, nan_steps={nan_steps}, "
          f"steps_back={steps_back(state):.0f}, "
          f"train_accuracy={acc:.3f}, final elbo {last:.1f}", flush=True)
    return {'ok': bool(ok), 'elbos': np.concatenate(trace),
            'nan_steps': nan_steps, 'steps_back': steps_back(state),
            'train_accuracy': acc, 'steps_per_s': sps}


def steps_back(state) -> float:
    """NatGrad's backoff counter; 0 under Adam, which has none."""
    return 0.0 if state.steps_back is None else float(state.steps_back)


def main(argv=None, device=None) -> int:
    """Run the soak; 0 on SOAK OK, 1 on SOAK FAIL."""
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--config', default='flagship', choices=list(CONFIGS))
    ap.add_argument('--optimizer', default='NatGrad')
    ap.add_argument('--steps', type=int, default=10000)
    ap.add_argument('--chunk', type=int, default=500)
    ap.add_argument('--seed', type=int, default=0,
                    help='init/train seed offset -- vary to measure the '
                         'seed-to-seed envelope (the data blobs stay fixed)')
    args = ap.parse_args(argv)
    device = port_config.default_device(device)
    if device.type == 'cuda':
        print(f"device: {torch.cuda.get_device_name(device)}", flush=True)
    model, X, Y = build(args.config, args.seed, device)
    result = soak(model, X, Y, args.config, args.optimizer,
                  CONFIGS[args.config][2], args.steps, args.chunk, args.seed)
    return 0 if result['ok'] else 1


if __name__ == '__main__':
    sys.exit(main())
