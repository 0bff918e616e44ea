#!/usr/bin/env python3
"""K6 and K7 (``csrc/patches.cu``) alone on the card, for comparing two
trees' kernels in one call: at chip_smoke.py's K6/K7 shapes, each held
against its plain version (K6 bit for bit, K7 within 1e-6 of max|.| and
bit-equal in two launches), with the profiler's device ms per launch,
back to back and with the L2 overwritten before each launch, beside the
bytes bound.

    python3 tools/torch_patches_probe.py [ROOT]

ROOT (default: this checkout) is the root of the tree whose package and
kernels are imported and built, e.g. an unpacked parent commit, so that
``for r in . parent . parent`` alternates two trees.  Prints one JSON line
per geometry.  Needs a CUDA card.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np

GEOMETRIES = (  # (label, N, H, W, C, f, stride, dilation), as chip_smoke.py's
    ('fm32', 320, 10, 10, 32, 5, 1, 1),
    ('strides21', 320, 14, 14, 10, 5, 1, 1),
    ('mnist', 32, 28, 28, 1, 5, 1, 1),
    ('mnist serving', 128, 28, 28, 1, 5, 1, 1),
    ('odd', 7, 9, 11, 3, 3, 2, 2),
    ('beyond smem', 4, 40, 40, 40, 5, 1, 1))


def main() -> int:
    root = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else
                           os.path.dirname(os.path.dirname(
                               os.path.abspath(__file__))))
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        print('torch_patches_probe: needs a CUDA card', file=sys.stderr)
        return 2
    import chip_smoke as cs
    from deepcgp_tpu_torch.ops import cuda_build
    from deepcgp_tpu_torch.ops import cuda_patches as cp
    from deepcgp_tpu_torch.ops.patches import out_size
    print(json.dumps({'root': root,
                      'build': cuda_build.build(('patches',))}), flush=True)
    dev = torch.device('cuda')
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True, check=True).stdout.strip()
    flush = torch.empty(2 ** 25, dtype=torch.float32, device=dev)  # 128 MiB
    rng = np.random.RandomState(0)
    for label, N, H, W, C, f, s, d in GEOMETRIES:
        Hout, Wout = out_size(H, f, s, d), out_size(W, f, s, d)
        P, L = Hout * Wout, f * f * C
        img = torch.as_tensor(rng.randn(N, H, W, C), dtype=torch.float32,
                              device=dev)
        g = torch.as_tensor(rng.randn(N, P, L), dtype=torch.float32,
                            device=dev)
        a6, a7 = (img, f, s, d), (g, (H, W, C), f, s, d)
        out = cp.extract_patches_transposed(*a6)
        back = cp.col2im_transposed(*a7)
        again = cp.col2im_transposed(*a7)
        torch.cuda.synchronize()
        bound = cs.bound_ms(4 * (N * H * W * C + N * P * L), 0)[0]
        k6_ms = cs.kernel_ms(torch, lambda: cp.extract_patches_transposed(*a6),
                             'extract_transposed_kernel')
        k7_ms = cs.kernel_ms(torch, lambda: cp.col2im_transposed(*a7),
                             'col2im_transposed_kernel')
        # The same with the 50 MB L2 overwritten before every launch.
        k6_cold = cs.kernel_ms(torch, lambda: (
            flush.zero_(), cp.extract_patches_transposed(*a6)),
            'extract_transposed_kernel')
        k7_cold = cs.kernel_ms(torch, lambda: (
            flush.zero_(), cp.col2im_transposed(*a7)),
            'col2im_transposed_kernel')
        print(json.dumps({
            'root': root, 'card': card, 'geometry': label,
            'shape': [N, H, W, C, f, s, d], 'P': P, 'L': L,
            'k6_bit_equal': bool(torch.equal(
                out, cp.extract_patches_transposed_plain(*a6))),
            'k7_rel_err': cs.rel(back, cp.col2im_transposed_plain(*a7)),
            'k7_bit_equal_two_launches': bool(torch.equal(back, again)),
            'bound_ms': bound, 'k6_ms': k6_ms, 'k7_ms': k7_ms,
            'k6_fraction_of_bound': bound / k6_ms,
            'k7_fraction_of_bound': bound / k7_ms,
            'k6_cold_l2_ms': k6_cold, 'k7_cold_l2_ms': k7_cold}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
