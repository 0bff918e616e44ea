#!/usr/bin/env python3
"""K4 and K5 (``csrc/conv_rbf_cross.cu``, ``csrc/conv_rbf_cross_bwd.cu``)
alone on the card, for comparing two trees' kernels in one call: the
forward at chip_smoke.py's seven geometries and the backward at its five
and the partial view's last layer, each held against its plain version,
with device ms per launch (the backward's two sides apart), whether each
gradient is bit-equal run to run, and the image side's phase trace where
the tree has one.

    python3 tools/torch_cross_probe.py [ROOT]

ROOT (default: this checkout) is the root of the tree whose package and
kernels are imported and built, e.g. an unpacked parent commit, so that
``for r in . parent . parent`` alternates two trees.  Prints one JSON line
per kernel and geometry.  Needs a CUDA card.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np

FORWARD = (  # (N, H, W, C, f, stride, M, with_kdiag), as chip_smoke.py's
    (640, 10, 10, 10, 5, 1, 384, True),    # flagship serving
    (256, 15, 13, 10, 3, 2, 200, True),
    (256, 15, 13, 10, 3, 2, 200, False),
    (320, 10, 10, 10, 5, 1, 384, True),    # flagship training
    (320, 10, 10, 12, 5, 1, 384, True),    # L = 300
    (320, 10, 10, 16, 5, 1, 384, True),    # L = 400, CIFAR fm16
    (32, 28, 28, 1, 5, 1, 1024, True))     # P = 576: row tiles (not fused)
BACKWARD = (
    (320, 10, 10, 10, 5, 1, 384, True),
    (256, 15, 13, 10, 3, 2, 200, True),
    (256, 15, 13, 10, 3, 2, 200, False),
    (320, 10, 10, 12, 5, 1, 384, True),
    (320, 10, 10, 16, 5, 1, 384, True),
    (320, 12, 12, 1, 5, 1, 384, True))     # the partial view: P = 64, L = 25


def _inputs(torch, cs, rng, dev, geometry, backward):
    N, H, W, C, f, s, M, kd_on = geometry
    img = torch.as_tensor(rng.randn(N, H, W, C), dtype=torch.float32,
                          device=dev)
    Z = torch.as_tensor(cs.patches_of(rng, rng.randn(32, H, W, C), M, f),
                        dtype=torch.float32, device=dev)
    P = ((H - f) // s + 1) * ((W - f) // s + 1)
    w = torch.as_tensor(rng.rand(P) + 0.5, dtype=torch.float32, device=dev)
    var = torch.tensor(5.0, device=dev)
    gamma = torch.tensor(-0.5 / 25.0 ** 2, device=dev)
    a = (img, Z, var, gamma, w / P, w, f, s, 1, kd_on)
    if backward:
        a += (torch.as_tensor(rng.randn(N, M), dtype=torch.float32, device=dev),
              torch.as_tensor(rng.randn(N), dtype=torch.float32, device=dev))
    return a


def main() -> int:
    root = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else
                           os.path.dirname(os.path.dirname(
                               os.path.abspath(__file__))))
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        print('torch_cross_probe: needs a CUDA card', file=sys.stderr)
        return 2
    import chip_smoke as cs
    from deepcgp_tpu_torch.ops import cuda_build, cuda_cross
    print(json.dumps({'root': root, 'build': cuda_build.build(
        ('conv_rbf_cross', 'conv_rbf_cross_bwd'))}), flush=True)
    dev = torch.device('cuda')
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True, check=True).stdout.strip()
    rng = np.random.RandomState(0)
    for geometry in FORWARD:
        a = _inputs(torch, cs, rng, dev, geometry, False)
        out = cuda_cross.conv_rbf_cross(*a)
        torch.cuda.synchronize()
        ref = cuda_cross.conv_rbf_cross_plain(*a)
        print(json.dumps({
            'root': root, 'card': card, 'kernel': 'K4',
            'geometry': list(geometry),
            'rel_err': [cs.rel(o, r) for o, r in zip(out, ref)],
            'ms': cs.kernel_ms(torch, lambda: cuda_cross.conv_rbf_cross(*a),
                               'conv_rbf_cross_kernel')}), flush=True)
    names = ('images', 'Z', 'variance', 'gamma', 'u', 'wkd')
    for geometry in BACKWARD:
        a = _inputs(torch, cs, rng, dev, geometry, True)
        out = cuda_cross.conv_rbf_cross_bwd(*a)
        torch.cuda.synchronize()
        ref = cuda_cross.conv_rbf_cross_bwd_plain(*a)
        again = cuda_cross.conv_rbf_cross_bwd(*a)

        def fn():
            return cuda_cross.conv_rbf_cross_bwd(*a)
        line = {'root': root, 'card': card, 'kernel': 'K5',
                'geometry': list(geometry),
                'rel_err': {n: cs.rel(o, r) for n, o, r in zip(names, out, ref)},
                'dimg_deterministic': bool(torch.equal(again[0], out[0])),
                'dz_deterministic': bool(torch.equal(again[1], out[1])),
                'bit_equal_run_to_run': {n: bool(torch.equal(o, g)) for n, o, g
                                         in zip(names, out, again)},
                'ms_image': cs.kernel_ms(torch, fn, 'bwd_image_kernel'),
                'ms_z': cs.kernel_ms(torch, fn, 'bwd_z_kernel')}
        if hasattr(cs, 'k5_image_trace'):
            line['trace_cycles'] = cs.k5_image_trace(torch, *a)
        print(json.dumps(line), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
