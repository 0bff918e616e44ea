#!/usr/bin/env python3
"""Where K4 and K5's Z side spend their time, on the card: the peak rates
of the instructions they are built on, and the kernels with one part
taken out.

    python3 tools/torch_cross_variants.py

* Peaks: mma.sync.m16n8k8 TF32 and m16n8k16 F16 (16 independent products
  a warp, register operands) and float32 FMA, at 2, 4 and 8 blocks of 256
  threads an SM.
* Variants of ``csrc/conv_rbf_cross.cu`` (K4) and of the Z side of
  ``csrc/conv_rbf_cross_bwd.cu``, built from this checkout's sources by
  replacing named lines: ``no_mma`` drops the products; ``no_staging``
  (K4) drops the copies and the splits, so the products run on whatever
  shared memory holds; ``l1_patches`` (Z side) loads every patch element
  from the first KB of the images, which stays in L1.  Their outputs are
  meaningless; only their times are read.  A variant whose lines are no
  longer in the source is reported and skipped.

Times are CUDA events over 50 launches at the flagship shapes (K4: N =
640 and 320 images of 10x10x10, f 5, M = 384, with Kdiag; the Z side: N =
320).  Prints one JSON line per measurement.  Needs a CUDA card.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

PEAK_SOURCE = r'''
#include <cuda_runtime.h>
#include <stdint.h>
template <int KIND>
__global__ void __launch_bounds__(256) peak(float* out, int iters) {
  float acc[16][4];
  for (int i = 0; i < 16; ++i) for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  const uint32_t a0 = threadIdx.x, a1 = a0 + 1, a2 = a0 + 2, a3 = a0 + 3;
  const uint32_t b0 = threadIdx.x * 7u, b1 = threadIdx.x * 9u;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      if (KIND == 0)
        asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+f"(acc[i][0]), "+f"(acc[i][1]), "+f"(acc[i][2]), "+f"(acc[i][3])
            : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
      else if (KIND == 1)
        asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+f"(acc[i][0]), "+f"(acc[i][1]), "+f"(acc[i][2]), "+f"(acc[i][3])
            : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
      else
        for (int r = 0; r < 8; ++r) acc[i][0] = fmaf(acc[i][0], 1.0000001f, 1e-9f);
    }
  }
  float s = 0.f;
  for (int i = 0; i < 16; ++i) for (int e = 0; e < 4; ++e) s += acc[i][e];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int run_peak(int kind, float* out, int blocks, int iters, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kind == 0) peak<0><<<blocks, 256, 0, s>>>(out, iters);
  else if (kind == 1) peak<1><<<blocks, 256, 0, s>>>(out, iters);
  else peak<2><<<blocks, 256, 0, s>>>(out, iters);
  return static_cast<int>(cudaGetLastError());
}
'''

K4_MMA = '''          mma_tf32(acc[i][jh + jj], pass == 0 ? al[i] : ah[i],
                   pass == 1 ? bl[jj][0] : bh[jj][0],
                   pass == 1 ? bl[jj][1] : bh[jj][1]);'''
K4_STAGING = [
    ('          cp_async4(As + r * kLdA + hk, va ? x + ra + lo : x, va);', ''),
    ('''            cp_async16(Br + r * kKC + 4 * sq,
                       Zp + static_cast<size_t>(m0 + r) * Lpad + c * kKC + 4 * sq);''', ''),
    ('        if (c + 1 < nk) convert(c + 1);', ''),
    ('      convert(0);\n', '')]
Z_MMA = '              mma_tf32(acc[i][j], a, b[0], b[1]);'
Z_LOAD = '      xv[j] = base >= 0 && lo >= 0 ? __ldg(img + base + lo) : 0.0f;'
VARIANTS = {
    'conv_rbf_cross': {'as_is': [], 'no_mma': [(K4_MMA, '')],
                       'no_staging': K4_STAGING},
    'conv_rbf_cross_bwd': {
        'as_is': [], 'no_mma': [(Z_MMA, '')],
        'l1_patches': [(Z_LOAD, '      xv[j] = __ldg(img + ((lo >= 0 ? lo : 0) & 1023));')]},
}


def _build(cuda_build, out_dir, name, text):
    path = os.path.join(out_dir, name + '.cu')
    with open(path, 'w') as fh:
        fh.write(text)
    so = path[:-3] + '.so'
    proc = subprocess.Popen([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, '-o', so,
                             path], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, so


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print('torch_cross_variants: needs a CUDA card', file=sys.stderr)
        return 2
    import chip_smoke as cs
    from deepcgp_tpu_torch.ops import cuda_build, cuda_cross
    out_dir = os.path.join(ROOT, 'build', 'variants')
    os.makedirs(out_dir, exist_ok=True)
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True, check=True).stdout.strip()
    jobs = {('peak', 'peak'): _build(cuda_build, out_dir, 'peak', PEAK_SOURCE)}
    for src, variants in VARIANTS.items():
        with open(os.path.join(cuda_build.CSRC, src + '.cu')) as fh:
            text = fh.read()
        for name, edits in variants.items():
            t = text
            missing = [a[:60] for a, _ in edits if a not in t]
            if missing:
                print(json.dumps({'variant': [src, name], 'skipped': missing}))
                continue
            for a, b in edits:
                t = t.replace(a, b)
            jobs[(src, name)] = _build(cuda_build, out_dir, f'{src}_{name}', t)
    libs = {}
    for key, (proc, so) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            print(json.dumps({'variant': key, 'build_failed': log[-2000:]}))
            continue
        libs[key] = ctypes.CDLL(so)
        print(json.dumps({'variant': key, 'ptxas': [
            ln.strip() for ln in log.splitlines()
            if 'Used' in ln or 'spill' in ln]}), flush=True)

    stream = torch.cuda.current_stream().cuda_stream

    def ev_ms(fn, iters=50):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / iters

    if ('peak', 'peak') in libs:
        fn = libs[('peak', 'peak')].run_peak
        fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p]
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        out = torch.empty(sms * 8 * 256, device='cuda')
        # Operations a warp does in one of the loop's iterations.
        for kind, label, ops in ((0, 'mma.sync m16n8k8 tf32', 16 * 2 * 16 * 8 * 8),
                                 (1, 'mma.sync m16n8k16 f16', 16 * 2 * 16 * 8 * 16),
                                 (2, 'ffma float32', 16 * 8 * 2 * 32)):
            for per_sm in (2, 4, 8):
                blocks, iters = sms * per_sm, 2000
                ms = ev_ms(lambda: fn(kind, out.data_ptr(), blocks, iters, stream),
                           iters=3)
                print(json.dumps({'peak': label, 'card': card,
                                  'blocks_per_sm': per_sm, 'ms': ms,
                                  'tflops': ops * 8 * blocks * iters / ms / 1e9}),
                      flush=True)

    dev = torch.device('cuda')
    rng = np.random.RandomState(0)
    H = W = 10
    C, f, M = 10, 5, 384
    L = f * f * C
    scal = torch.tensor([5.0, -0.5 / 25.0 ** 2], device=dev)
    for N in (640, 320):
        img = torch.as_tensor(rng.randn(N, H, W, C), dtype=torch.float32,
                              device=dev)
        Z = torch.as_tensor(cs.patches_of(rng, rng.randn(32, H, W, C), M, f),
                            dtype=torch.float32, device=dev)
        P = (H - f + 1) * (W - f + 1)
        w = torch.as_tensor(rng.rand(P) + 0.5, dtype=torch.float32, device=dev)
        u = (w / P).contiguous()
        Zp = cuda_cross._padded_z(Z)
        Mpad, Lpad = Zp.shape
        kzx = torch.empty(N, M, device=dev)
        kd = torch.empty(N, device=dev)
        for name in VARIANTS['conv_rbf_cross']:
            lib = libs.get(('conv_rbf_cross', name))
            if lib is None:
                continue
            fn = lib.conv_rbf_cross
            fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 12 + [ctypes.c_void_p]

            def call():
                return fn(img.data_ptr(), Zp.data_ptr(), scal.data_ptr(),
                          u.data_ptr(), w.data_ptr(), kzx.data_ptr(),
                          kd.data_ptr(), N, H, W, C, f, 1, 1, M, Mpad, Lpad,
                          cuda_cross.fwd_group(P), 1, stream)
            print(json.dumps({'kernel': 'K4', 'variant': name, 'card': card,
                              'N': N, 'ms': ev_ms(call)}), flush=True)
        if N != 320:
            continue
        T = torch.randn(N, P, Mpad, device=dev) * 1e-3
        dZ = torch.empty_like(Z)
        cluster = cuda_cross.z_side_cluster(
            N, P, M, L, torch.cuda.get_device_properties(0).multi_processor_count)
        for name in VARIANTS['conv_rbf_cross_bwd']:
            lib = libs.get(('conv_rbf_cross_bwd', name))
            if lib is None:
                continue
            fn = lib.conv_rbf_cross_bwd_z
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
            # The variants at the wrapper's cluster size; the kernel as it
            # is at other cluster sizes too.
            for size in ((cluster,) if name != 'as_is' else (8, 11, 12, 16)):
                def call():
                    return fn(img.data_ptr(), Z.data_ptr(), T.data_ptr(),
                              dZ.data_ptr(), N, H, W, C, f, 1, 1, M, Mpad, size,
                              stream)
                print(json.dumps({'kernel': 'K5 Z side', 'variant': name,
                                  'card': card, 'N': N, 'cluster': size,
                                  'wrapper_cluster': cluster, 'ms': ev_ms(call)}),
                      flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
