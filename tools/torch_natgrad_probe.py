#!/usr/bin/env python3
"""The M=1088 NatGrad path of ``chip_smoke.py`` under the profiler, for
comparing two trees in one call: the M=1024 MNIST-shaped configuration at
M = 1088 (beyond K1's largest matrix), built fresh from the seed, two
warm-up steps, then 16-step ``run_chunk`` calls profiled by that tree's
``chip_smoke.profile_device`` (device busy ms, wall ms, the kernels with
the most device time, launches by counter).

    python3 tools/torch_natgrad_probe.py [ROOT] [--rounds N]

ROOT (default: this checkout) is the root of the tree whose package,
kernels and ``chip_smoke.py`` are imported and built, e.g. an unpacked
parent commit, so that ``for r in . parent . parent`` alternates two
trees.  Prints one JSON line per profiled chunk.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import types

import numpy as np


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('root', nargs='?', default=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument('--rounds', type=int, default=2)
    ap.add_argument('--seed', type=int, default=0)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        print('torch_natgrad_probe: needs a CUDA card', file=sys.stderr)
        return 2
    import chip_smoke as cs
    from deepcgp_tpu_torch.models import builder
    from deepcgp_tpu_torch.ops import (cuda_build, cuda_cross, cuda_linalg,
                                       cuda_patches)
    from deepcgp_tpu_torch.training import trainer
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(json.dumps({'root': root, 'card': card,
                      'build': sorted(cuda_build.build())}), flush=True)
    counters = {'chol_inv_base': cuda_linalg.chol_inv_base,
                'chol_inv_base_upper': cuda_linalg.chol_inv_base_upper,
                'tri_inv_base': cuda_linalg.tri_inv_base,
                'conv_rbf_cross': cuda_cross.conv_rbf_cross,
                'conv_rbf_cross_bwd': cuda_cross.conv_rbf_cross_bwd,
                'extract_patches_transposed':
                    cuda_patches.extract_patches_transposed,
                'col2im_transposed': cuda_patches.col2im_transposed}

    def reset_counts():
        for fn in counters.values():
            fn.launches = 0

    def read_counts():
        return {name: fn.launches for name, fn in counters.items()}

    dev = torch.device('cuda')
    rng = np.random.RandomState(args.seed)
    X = rng.randn(cs.TRAIN_IMAGES, *cs.M1024_IMAGE).astype(np.float32)
    Y = rng.randint(0, 10, size=(cs.TRAIN_IMAGES, 1))
    flags = types.SimpleNamespace(**cs.M1088, num_samples=cs.TRAIN_SAMPLES)
    model = builder.build_model(
        flags, cs.M1024_IMAGE, images=X,
        generator=torch.Generator().manual_seed(args.seed), device=dev)
    config = trainer.TrainConfig(optimizer='NatGrad', lr=0.01,
                                 batch_size=cs.M1024_BATCH, gamma=0.001)
    state = trainer.init_state(model, config, seed=args.seed)
    Xd = torch.as_tensor(X.reshape(cs.TRAIN_IMAGES, -1), device=dev)
    Yd = torch.as_tensor(Y, device=dev)
    trainer.run_chunk(state, config, Xd, Yd, 2)
    torch.cuda.synchronize()
    for r in range(args.rounds):
        wall_ms, busy_ms, top, rounds = cs.profile_device(
            torch, lambda: trainer.run_chunk(state, config, Xd, Yd, 16),
            reset_counts, read_counts)
        print(json.dumps({'root': root, 'card': card, 'path': 'm1088 natgrad',
                          'round': r, 'steps': 16, 'wall_ms': wall_ms,
                          'device_busy_ms': busy_ms,
                          'device_busy_share': busy_ms / wall_ms,
                          'launches': read_counts(),
                          'profile_rounds': rounds, 'top_device_ms': top}),
              flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
