#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (deepcgp_tpu_torch) on one NVIDIA H100.

    python3 chip_smoke.py [--seed 0]

Builds every CUDA kernel of the port from deepcgp_tpu_torch/csrc and holds
each against its plain PyTorch version on the card: K1 (the whole blocked
Cholesky factor of a batch, one thread-block cluster a matrix) and K3 (the
whole triangular inverse, by column strips) -- together the port's
factor-plus-inverse in two launches -- at the old base shapes, the two
Kuu route shapes [3, 384, 384] and [1, 1024, 1024] and the NatGrad
solve's [20, 384, 384] and [10, 1024, 1024], K2 (the whole upper
Cholesky factor of the NatGrad G, one cluster a matrix, read from G's
lower triangle) at the solve's shapes up to [2, 2048, 2048], K4 (fused
extraction -> RBF cross-covariance, its products on the tensor cores in
split TF32) and K5 (its backward: the image side one thread-block cluster
per image, the Z side in split TF32), each with its distance from a
float64 evaluation beside the plain float32 version's.  Then it drives
the main paths of the flagship CIFAR-shaped 2-layer conv-GP (M=384,384,
10 feature maps, filters 5,5, strides 3,1, ConvKernel last layer; random
weights or data from the seed):

* serving, through ``Predictor.from_run_dir`` (the last layer's
  lengthscale is 25, not the initial 5: its 250-element input patches
  carry the hidden layer's O(1) sampling noise, so at 5 every
  cross-covariance underflows to ~1e-4, a random-weight model answers 0.1
  for every class, and the comparison with the CPU would check nothing);
* training, Adam at batch 32 and S=10 from a fresh build on synthetic
  CIFAR-shaped data, as bench.py drives the JAX package, then the trained
  model saved as a snapshot and served;
* NatGrad training of the same configuration (natural gradient on q_mu
  and q_sqrt, its solve by K2 and K3 on G's lower triangle, Adam on the
  rest, gamma 0.001);

and of the M=1024 MNIST-shaped configuration (28x28x1, no hidden layer, an
ARD-RBF last layer over the 784 pixels, M=1024, batch 128, S=10, k-means++
inducing points): NatGrad training through K1 and K3 at M = 1024 (Kuu)
and K2 and K3 (the solve), a short Adam run through the bf16
stochastic-rounding moment store, and five NatGrad steps at M = 1088,
above K1's largest matrix, where the solve takes K2 on the whole G, one
step of it against the CPU and 16 under the profiler.

Then the unfused last-layer route, whose geometries the fused K4/K5 pair
does not take: K6 (patch extraction in transposed order) and K7 (its
col2im) against their plain versions, and Adam training of

* the paper's MNIST single-layer ConvKernel (28x28x1, filter 5, stride 1,
  M=1024, batch 32, S=10: P = 576), whose trained snapshot is then served;
* the CIFAR fm32 configuration (M=384,384, 32 feature maps, filters 5,5,
  strides 3,1, batch 32, S=10: a last layer with L = 800), where K7
  carries the hidden layer's gradient, and one step of it from the
  builder's default init against the CPU.

Last, the CLI a user runs, in process, on the synthetic fallback: the
flagship through ``deepcgp_tpu_torch.cifar.main`` (5 chunks of 20 Adam
steps, an eval of 1000 images after each), its run dir served on raw
images, the same run stopped after 2 chunks and resumed from its
full-state snapshot, the M=1024 configuration through
``deepcgp_tpu_torch.mnist.main`` (NatGrad after 20 warm Adam steps), and
the flagship's argv on learnable blobs, held to a held-out accuracy.

Then the models the JAX CLI builds beyond the flagship's, through the
same entry point: a 3-layer stack with the identity mean (32x32x3,
M=384,384,384, 10 and 10 feature maps, filters 5,3,3, strides 2,1,1: an
unfused last layer over P = 100, L = 90) trained with Adam, served, and
stopped and resumed bit for bit, then trained with NatGrad after an Adam
warm start (the solve's [30, 384, 384] batch on K2); and the flagship's
geometry with an ArcCosine hidden layer and the identity mean on learnable
blobs, Adam then NatGrad.  The second hidden layer's extraction, whose
backward is the first to reach a sample, is timed by the plain route it
takes against K6/K7.

Last, the rest of the JAX package's single-device surface: the flagship
CLI with its TensorBoard log on (2 chunks of 20 Adam steps, the events
file read back by the port's own reader: CRCs, the JAX logger's tags,
the layer-0 images), full-covariance sampling (the trained flagship's
two layers at N = 16, the MNIST ConvKernel's last layer at N = 16 and
N = 128, its peak memory held under 1 GiB), the diagnostics, a trace of
a flagship chunk naming its annotated region and K1, K3, K4 and K5, the
noise sweep, a RandomPartialView model trained with Adam (28x28x1, 144
positions read as 12x12, the patchwise mean, M = 384, a ConvKernel last
layer over P = 64, L = 25 on the fused route), the regression example
(2000 Adam steps, its train RMSE gated) and the upper base case at
blocks that are not a multiple of 32 (the identity padding).

Last, the multi-process layer (``deepcgp_tpu_torch/parallel``) on the
card: the flagship CLI as a one-rank NCCL group (``--mesh data=1
--distributed``), its log rows and launches against the plain run; then
two spawned processes sharing the card over gloo (NCCL takes one rank a
device), with mesh data=2 and then model=2, each holding two Adam and
two NatGrad steps of the flagship, and under model=2 one Adam step of
the MNIST ConvKernel and of fm32, against the same steps in one process,
with each rank's launches; and ``Predictor(mesh='data=2')``.  One card
shows the collectives, not a speed-up.

Besides, the last of the JAX package's surface: right after the kernels'
build, the native host data path (``deepcgp_tpu_torch/native``: g++ builds
it, and each function is held bit for bit against its numpy version on a
60000 x 784 fit and 10000 CIFAR-shaped images, both timed); after the
mesh, the FLOP accounting (``utils/flops``) of the flagship Adam and
M=1024 NatGrad windows against the card's BF16 peak, beside a measured
8192^3 ``torch.matmul`` in BF16 and FP32; the example scripts at cut
schedules (``train_mnist`` with its TensorBoard log, ``serve`` and
``inspect_model`` on its run, whose PNGs are decoded; ``fm_sweep`` over
feature maps 1 and 2; each parity script refused without its data, then
on learnable blobs written in the reference's file layout); and the
digits probe on the real UCI scans, its held-out accuracy gated.

Last, the measurement tools (``deepcgp_tpu_torch/tools``): the roofline
of a graphed chunk of 50 flagship Adam and of 50 M=1024 NatGrad steps,
each ``python -m deepcgp_tpu_torch.tools.roofline`` in a process of its
own (its buckets held to the profiler's device total, its K buckets to the
launch counters, 'other' to at most 5% of the time, every replayed step
joined to the eager step), the flagship's bytes audit (the hand kernels'
bytes at PERF.md's formulas), the flagship NatGrad soak cut to 1000 steps
and the digits NatGrad sweep cut to Adam and gamma0 0.01 at 1000 steps.
The compiled chunk's bit-equality holds, besides the seven paths of its
introduction, the ArcCosine + identity-mean model (NatGrad and Adam) and
the partial view (Adam), and it runs each path eager twice.

Each path is checked to have gone through the kernels (launch counters)
and to agree with the same model on the CPU.  Each phase prints one JSON
line; any failed check raises, so the script exits non-zero and prints no
final line.  The last line is the device summary.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import csv
import ctypes
import io
import json
import os
import subprocess
import sys
import tempfile
import time
import types

import numpy as np

# H100 SXM peaks (NVIDIA data sheet): HBM3 rate, float32 outside the tensor
# cores, TF32 on them.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# Dense TF32 on the tensor cores; a split-TF32 product takes three passes.
TF32_OPS_PER_S = 495e12

FLAGSHIP = dict(M='384,384', feature_maps='10', filter_sizes='5,5',
                strides='3,1', base_kernel='rbf', last_kernel='conv',
                white=False, identity_mean=False)
IMAGE = (32, 32, 3)
BATCH, SAMPLES = 128, 5
LENGTHSCALES = (5.0, 25.0)
# Serving: warm-up requests, then batch-sized requests for this many seconds.
WARMUP_REQUESTS = 30
WINDOW_SECONDS = 5.0
# Training (bench.py's flagship Adam run): batch, MC samples, synthetic
# training images, warm-up steps, steps per timed chunk, window seconds.
TRAIN_BATCH, TRAIN_SAMPLES, TRAIN_IMAGES = 32, 10, 2048
TRAIN_WARMUP_STEPS, TRAIN_CHUNK = 10, 20
# The M=1024 configuration (bench.py's mnist-m1024 and mnist-m1024-natgrad).
M1024 = dict(M='1024', feature_maps='', filter_sizes='5', strides='1',
             base_kernel='rbf', last_kernel='rbf', white=False,
             identity_mean=False)
M1024_IMAGE, M1024_BATCH = (28, 28, 1), 128
# Launches per NatGrad step and per run_chunk call (the terminal ELBO that
# verifies a chunk's last commit), by kernel counter.
# The NatGrad solve runs K2 and K3 on G's lower triangle (one each per
# step) at every M % 32 == 0 up to 2048; Kuu takes K1 and K3 up to
# M = 1024 and the library route at M = 1088.
NATGRAD_PER_STEP = {
    'flagship': {'chol_inv_base': 1, 'chol_inv_base_upper': 1,
                 'tri_inv_base': 2, 'conv_rbf_cross': 1,
                 'conv_rbf_cross_bwd': 2},
    'm1024': {'chol_inv_base': 1, 'chol_inv_base_upper': 1, 'tri_inv_base': 2,
              'conv_rbf_cross': 0, 'conv_rbf_cross_bwd': 0},
    'm1088': {'chol_inv_base_upper': 1, 'tri_inv_base': 1},
    'deep3': {'chol_inv_base': 1, 'chol_inv_base_upper': 1, 'tri_inv_base': 2,
              'extract_patches_transposed': 1, 'col2im_transposed': 2}}
NATGRAD_PER_CHUNK = {
    'flagship': {'chol_inv_base': 1, 'tri_inv_base': 1, 'conv_rbf_cross': 1},
    'm1024': {'chol_inv_base': 1, 'tri_inv_base': 1},
    'm1088': {},
    'deep3': {'chol_inv_base': 1, 'tri_inv_base': 1,
              'extract_patches_transposed': 1}}
# NatGrad above K1's largest matrix: the M=1024 configuration at M = 1088.
# No configuration of the repo goes past M = 1024 (BASELINE.md's sweep ends
# there); this path drives K2 beyond K1's largest matrix through the
# trainer, and Kuu through the library route.
M1088 = dict(M1024, M='1088')
# The unfused route's configurations (examples/mnist_parity.py --m1024, and
# BASELINE.md's CIFAR fm32 sweep point), their launches per Adam step, and
# the MNIST snapshot's launches per predict_y.
MNIST_CONV = dict(M='1024', feature_maps='', filter_sizes='5', strides='1',
                  base_kernel='rbf', last_kernel='conv', white=False,
                  identity_mean=False)
MNIST_IMAGE = (28, 28, 1)
FM32 = dict(FLAGSHIP, feature_maps='32')
UNFUSED_PER_STEP = {
    'mnist_conv': {'chol_inv_base': 1, 'tri_inv_base': 1,
                   'extract_patches_transposed': 1},
    'fm32': {'chol_inv_base': 1, 'tri_inv_base': 1,
             'extract_patches_transposed': 1, 'col2im_transposed': 1}}
MNIST_SERVING_PER_CALL = UNFUSED_PER_STEP['mnist_conv']
UNFUSED_WARMUP_STEPS, UNFUSED_CHUNK, UNFUSED_WINDOW_SECONDS = 5, 10, 5.0
# The CLI paths: the entry points' argv, the JAX package's CLI flags.  The
# flagship CIFAR run: 5 chunks of 20 Adam steps, an eval of 1000 test
# images after each; the M=1024 MNIST run: 20 warm Adam steps, then 5
# chunks of 10 NatGrad steps, an eval of 512 after each; the blob run:
# the flagship's argv on learnable blobs, 6 chunks of 100 steps.
CLI_FLAGSHIP = ['--name', 'flagship', '-N', '2048', '-M', '384,384',
                '--feature-maps', '10', '--filter-sizes', '5,5', '--strides',
                '3,1', '--batch-size', '32', '--num-samples', '10',
                '--test-every', '20', '--lr-decay-steps', '40', '--test-size',
                '1000', '--no-tensorboard', '--full-state-ckpt']
CLI_M1024 = ['--name', 'm1024', '-N', '2048', '-M', '1024', '--feature-maps',
             '', '--filter-sizes', '5', '--strides', '1', '--last-kernel',
             'rbf', '--batch-size', '128', '--num-samples', '10',
             '--optimizer', 'NatGrad', '--natgrad-warm-steps', '20',
             '--test-every', '10', '--lr-decay-steps', '20', '--test-size',
             '512', '--no-tensorboard']
CLI_BLOBS = CLI_FLAGSHIP + ['--name', 'blobs', '--test-every', '100',
                            '--lr-decay-steps', '100000']
BLOB_IMAGES, BLOB_TRAIN, BLOB_CHUNKS, BLOB_MIN_ACCURACY = 2560, 2048, 6, 0.95
# Depth 3: tests/test_deep_stack.py's geometry at CIFAR's 32x32x3 and the
# flagship's widths (M = 384 a layer, 10 feature maps) with the identity
# mean: 14x14x10 -> 12x12x10 -> an unfused ConvKernel last layer over
# P = 100, L = 90.  Adam: 3 chunks of 10 steps, an eval of 256 images
# after each, then the same run stopped after a chunk and resumed.  NatGrad:
# 10 warm Adam steps, then 3 chunks of 10 NatGrad steps whose solve
# stacks the three layers' 30 GPs into one [30, 384, 384] batch.  The
# ArcCosine path: the flagship's geometry with an order-0 ArcCosine hidden
# layer and the identity mean on learnable blobs, 100 warm Adam steps,
# then 3 chunks of 50 NatGrad steps.
CLI_DEEP3 = ['--name', 'deep3', '-N', '2048', '-M', '384,384,384',
             '--feature-maps', '10,10', '--filter-sizes', '5,3,3', '--strides',
             '2,1,1', '--identity-mean', '--batch-size', '32',
             '--num-samples', '10', '--test-every', '10', '--lr-decay-steps',
             '10', '--test-size', '256', '--no-tensorboard',
             '--full-state-ckpt']
CLI_DEEP3_NATGRAD = CLI_DEEP3[:-1] + ['--name', 'deep3ng', '--optimizer',
                                      'NatGrad', '--natgrad-warm-steps', '10',
                                      '--test-size', '64']
CLI_ACOS = ['--name', 'acos', '-N', '2048', '-M', '384,384', '--feature-maps',
            '10', '--filter-sizes', '5,5', '--strides', '3,1', '--base-kernel',
            'acos', '--identity-mean', '--batch-size', '32', '--num-samples',
            '10', '--optimizer', 'NatGrad', '--natgrad-warm-steps', '100',
            '--test-every', '50', '--lr-decay-steps', '100000',
            '--no-tensorboard']
ACOS_CHUNKS = 3
# The batch of the depth-3 steps held against the CPU (its float64 side
# runs the [S*N*P, R*M] products of layer 2 on the host); the chunks and
# steps of each new path's bare run_chunk window after its CLI run, and
# the steps of it under the profiler (each takes ~1 s of the profiler's
# host work).
DEEP3_CHECK_BATCH = 8
WINDOW_CHUNKS, WINDOW_CHUNK, WINDOW_PROFILE_STEPS = 3, 10, 8
# Launches per predict_y of an eval batch (EVAL_BATCH rows) and per Adam
# step.
EVAL_BATCH = 32
# Depth 3 factors its five [384, 384] grams (two hidden layers' Kuu and KL
# prior, the last layer's Kuu) in one K1 + K3 pair; its hidden layers'
# extraction is a strided copy, and only the unfused last layer launches
# K6.  The backward launches K7 twice: once for the last layer, once for
# the second hidden layer's extraction of a sample (layer 1 reads images,
# which need no gradient).
EVAL_PER_BATCH = {'flagship': {'chol_inv_base': 1, 'tri_inv_base': 1,
                               'conv_rbf_cross': 1},
                  'm1024': {'chol_inv_base': 1, 'tri_inv_base': 1},
                  'deep3': {'chol_inv_base': 1, 'tri_inv_base': 1,
                            'extract_patches_transposed': 1}}
ADAM_PER_STEP = {'flagship': {'chol_inv_base': 1, 'tri_inv_base': 1,
                              'conv_rbf_cross': 1, 'conv_rbf_cross_bwd': 2},
                 'm1024': {'chol_inv_base': 1, 'tri_inv_base': 1},
                 'deep3': {'chol_inv_base': 1, 'tri_inv_base': 1,
                           'extract_patches_transposed': 1,
                           'col2im_transposed': 2}}
# Every launch counter, in the order of the kernels line.
COUNTERS = ('chol_inv_base', 'chol_inv_base_upper', 'tri_inv_base',
            'conv_rbf_cross', 'conv_rbf_cross_bwd',
            'extract_patches_transposed', 'col2im_transposed')


def launches_of(**counts) -> dict:
    """Expected launches: ``counts`` for the kernels named, 0 for the rest."""
    return {name: counts.get(name, 0) for name in COUNTERS}


_T0 = time.perf_counter()


def emit(obj) -> None:
    """Print one JSON line; a phase's line carries the seconds since the
    script started and the card's memory the process holds (allocated,
    and reserved by the caching allocator, its graph pools included)."""
    if 'phase' in obj:
        obj = {**obj, 'elapsed_s': time.perf_counter() - _T0}
        torch = sys.modules.get('torch')
        if torch is not None and torch.cuda.is_initialized():
            obj.update(memory_allocated_bytes=torch.cuda.memory_allocated(),
                       memory_reserved_bytes=torch.cuda.memory_reserved())
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f'chip_smoke check failed: {what}')


def cuda_ms(torch, fn, iters: int, warmup: int = 3) -> float:
    """Mean device milliseconds of fn() over ``iters`` back-to-back calls,
    by CUDA events after a warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def queued_ms(torch, fn, iters: int, warmup: int = 3) -> float:
    """Mean device milliseconds of fn() over ``iters`` calls whose launches
    the host queued while the device spun (``torch.cuda._sleep``), so the
    device runs them back to back: the device time of a call that the
    host takes longer to launch than the device to run, which CUDA events
    around host-paced calls cannot give.  The spin doubles until the
    device is still in it when the host has queued every call."""
    for _ in range(warmup):
        fn()
    cycles = 1 << 24
    for _ in range(12):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        queued_ahead = not start.query()
        end.synchronize()
        if queued_ahead:
            return start.elapsed_time(end) / iters
        cycles *= 2
    raise RuntimeError('chip_smoke check failed: the host never queued '
                       f'{iters} calls ahead of the device')


# Every profiled round of kernel_ms: [kernel, launches recorded, made].
PROFILER_ROUNDS = []


def kernel_ms(torch, fn, kernel: str, iters: int = 50,
              rounds: int = 8) -> float:
    """Mean device milliseconds of the CUDA kernel whose name contains
    ``kernel``, per launch, from the profiler over ``iters`` calls of fn()
    -- the kernel alone, without the host time of its wrapper."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    # The profiler may lose some of a round's device events (seen: 49, 46
    # and 29 of 50).  Each recorded event is one whole launch, so the mean
    # is over the launches recorded, and rounds of ``iters`` calls go on
    # until ``iters`` launches are recorded.  A round that records more
    # launches than it made matched another kernel, and fails.
    total_us, seen = 0.0, 0
    for _ in range(rounds):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        hits = [e for e in prof.key_averages() if kernel in e.key
                and e.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(e, 'is_user_annotation', False)]
        check(len(hits) <= 1 and sum(e.count for e in hits) <= iters,
              f'profiler saw {[(e.key, e.count) for e in hits]} for '
              f'{iters} launches of {kernel}')
        PROFILER_ROUNDS.append([kernel, hits[0].count if hits else 0, iters])
        if hits:
            total_us += hits[0].self_device_time_total
            seen += hits[0].count
        if seen >= iters:
            return total_us / 1e3 / seen
    raise RuntimeError(f'chip_smoke check failed: profiler recorded {seen} '
                       f'of {rounds * iters} launches of {kernel}')


def profile_device(torch, fn, reset_counts, read_counts):
    """Run fn() under the profiler: (wall ms, device busy ms, the 12
    device entries with the most time as [name, count, ms], rounds), from
    a round whose recorded launches of the port's kernels match the launch
    counters (``utils.profiling.profile_device``: the profiler may lose a
    round's device events, so a short round is profiled again, up to
    ``PROFILE_ROUNDS``; more, or every round short, fails)."""
    from deepcgp_tpu_torch.utils import profiling
    return profiling.profile_device(fn, reset_counts, read_counts)


def bound_ms(nbytes: float, ops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ('bytes' if t_bytes >= t_ops else 'operations')


def k2_bound_ms(b: int, M: int):
    """K2's bound on [b, M, M]: G's lower triangle read once, Lf and Dinv
    ([b, M/32, 32, 32]) written once, against b M^3 / 3 operations."""
    return bound_ms(4 * b * (M * (M + 1) // 2 + M * M + M * 32), b * M ** 3 / 3)


def rel(a, b) -> float:
    """max |a - b| over max |b| (max |a| where b is all zeros)."""
    scale = float(b.abs().max())
    err = float((a - b).abs().max())
    return err / scale if scale > 0 else err


def patches_of(rng, images: np.ndarray, count: int, f: int) -> np.ndarray:
    """``count`` distinct random f x f patches of ``images`` [N, H, W, C],
    TF order."""
    N, H, W, C = images.shape
    ny, nx = H - f + 1, W - f + 1
    pick = rng.choice(N * ny * nx, count, replace=False)
    n, y, x = pick // (ny * nx), pick // nx % ny, pick % nx
    return np.stack([images[a, b:b + f, c:c + f, :].reshape(-1)
                     for a, b, c in zip(n, y, x)])


def flagship_snapshot(seed: int) -> dict:
    """Reference-format parameters of the flagship geometry from ``seed``:
    inducing patches from seeded images, small q_mu, lower-triangular
    q_sqrt, variance 5, LENGTHSCALES, unit patch weights."""
    rng = np.random.RandomState(seed)
    images0 = rng.randn(64, *IMAGE)
    images1 = rng.randn(64, 10, 10, 10)
    params = {'global_step': 0}
    for i, (images, P) in enumerate(((images0, None), (images1, 36))):
        pre = f'DGP/layers/{i}/'
        M, R = 384, 10
        q_sqrt = 0.05 * np.tril(rng.randn(R, M, M), -1) + 0.3 * np.eye(M)
        params[pre + 'feature/Z'] = patches_of(rng, images, M, 5)
        params[pre + 'q_mu'] = 0.5 * rng.randn(M, R)
        params[pre + 'q_sqrt'] = q_sqrt
        params[pre + 'kern/base_kernel/variance'] = np.float64(5.0)
        params[pre + 'kern/base_kernel/lengthscales'] = np.float64(
            LENGTHSCALES[i])
        if P:
            params[pre + 'kern/patch_weights'] = np.ones(P)
    return params


def write_run(root: str, params: dict, flags: dict = FLAGSHIP,
              name: str = 'flagship') -> str:
    """A run directory as the Experiment CLI leaves it: <root>/<name>.npy
    beside <root>/<name>/options.toml."""
    np.save(os.path.join(root, name + '.npy'), np.asarray(params, dtype=object))
    run = os.path.join(root, name)
    os.makedirs(run)
    lines = [f'name = "{name}"']
    for k, v in flags.items():
        lines.append(f'{k} = {str(v).lower()}' if isinstance(v, bool)
                     else f'{k} = "{v}"')
    with open(os.path.join(run, 'options.toml'), 'w') as f:
        f.write('\n'.join(lines) + '\n')
    return run



def f32_agrees(card_vs_cpu: dict, card_vs_f64: dict, cpu_vs_f64: dict,
               tol: float) -> dict:
    """Per leaf: the card within ``tol`` of the CPU's float32 result, or no
    farther from the float64 result than ``tol`` plus twice the CPU
    float32's own distance from it (a state whose float32 gradient is
    ill-conditioned leaves the two float32 sides that far apart)."""
    return {k: card_vs_cpu[k] <= tol
            or card_vs_f64[k] <= tol + 2 * cpu_vs_f64[k] for k in card_vs_cpu}


ADAM_STEP_TOLERANCE = (
    'loss 1e-4 relative; each gradient within 1e-2 of its leaf\'s largest '
    "magnitude of the CPU's float32 (float32 in other summation orders "
    'through the GP layers and the Cholesky backward), or within 1e-2 plus '
    "twice the CPU float32's own distance of the float64 gradient where "
    'float32 itself is that far off')


def adam_step_vs_cpu(torch, state, config, Xd, Yd, batch: int, rng,
                     floor: float | None = None):
    """One step's loss and gradients, the card against the same model on
    the CPU (plain versions) with the same batch and noise, float64 on the
    CPU as the reference (``f32_agrees``).  With ``floor``, layer 1's
    leaves whose float64 gradient is below it in magnitude (too small for
    float32 to resolve on either side) are left out of the rule and
    reported with their readings.  Returns (the phase line's fields, None
    or what disagreed)."""
    from deepcgp_tpu_torch.training import trainer
    model = state.model
    noise = [rng.randn(model.num_samples, batch, layer.num_outputs)
             for layer in model.layers]
    xb, yb = Xd[:batch], Yd[:batch]
    loss_g, grads_g = trainer.loss_and_grads(state, xb, yb, noise)
    cpu_states = {}
    for name, dtype in (('f32', torch.float32), ('f64', torch.float64)):
        cpu_model = copy.deepcopy(model).to('cpu', dtype)
        cpu_states[name] = trainer.loss_and_grads(
            trainer.init_state(cpu_model, config), xb.cpu().to(dtype),
            yb.cpu(), noise)
    loss_c, grads_c = cpu_states['f32']
    loss_d, grads_d = cpu_states['f64']
    grad_err = {k: rel(g.cpu(), grads_c[k]) for k, g in grads_g.items()}
    grad_err_f64 = {k: rel(g.cpu().double(), grads_d[k])
                    for k, g in grads_g.items()}
    cpu_err_f64 = {k: rel(g.double(), grads_d[k]) for k, g in grads_c.items()}
    loss_err = abs(float(loss_g) - float(loss_c)) / abs(float(loss_c))
    grads_ok = f32_agrees(grad_err, grad_err_f64, cpu_err_f64, 1e-2)
    excluded = {}
    if floor is not None:
        excluded = {k: float(g.abs().max()) for k, g in grads_d.items()
                    if k.startswith('layers.1.') and float(g.abs().max()) < floor}
        grads_ok = {k: v for k, v in grads_ok.items() if k not in excluded}
    fields = {'card_vs_cpu': {'loss_rel_err': loss_err,
                              'grad_rel_err_of_leaf_max': grad_err},
              'card_vs_cpu_f64_grad_rel_err': grad_err_f64,
              'cpu_f32_vs_cpu_f64_grad_rel_err': cpu_err_f64,
              'loss_rel_err_vs_cpu_f64': {
                  'card': abs(float(loss_g) - float(loss_d)) / abs(float(loss_d)),
                  'cpu_f32': abs(float(loss_c) - float(loss_d))
                  / abs(float(loss_d))},
              'tolerance': ADAM_STEP_TOLERANCE}
    if floor is not None:
        fields.update(
            excluded_leaves_f64_grad_max_abs=excluded,
            exclusion_rule=f'layer 1 leaves whose float64 gradient max |.| '
                           f'< {floor} are read, not held to the tolerance',
            f64_grad_max_abs={k: float(g.abs().max())
                              for k, g in grads_d.items()})
    failure = None
    if not (loss_err <= 1e-4 and all(grads_ok.values())):
        failure = (f'card vs CPU step: loss {loss_err}, gradients {grad_err}, '
                   f'vs float64 {grad_err_f64}, CPU float32 vs float64 '
                   f'{cpu_err_f64}')
    return fields, failure


def spd_batch(torch, rng, b: int, P: int, dev):
    """[b, P, P] well-conditioned SPD float32 matrices from ``rng``."""
    A = rng.randn(b, P, P)
    S = A @ np.swapaxes(A, 1, 2) / P + 2.0 * np.eye(P)
    return torch.as_tensor(S, dtype=torch.float32, device=dev)


def finite(torch, x) -> bool:
    return bool(torch.isfinite(x).all())


K1K3_TOLERANCE = ('relative to max|.|: K1 (factor, diagonal-block inverses) '
                  'and K3 (inverse, with and without K1\'s inverses) <= 1e-5 '
                  'of the plain version on the same inputs, reconstruction '
                  '<= 5e-6; the route (K1 then K3) <= 1e-4 of float64')
# K1's and K3's shapes: the old base cases' ([3, 64, 64] the flagship's Kuu
# slice, [1, 128, 128], [8, 128, 128]), the two Kuu route shapes
# ([3, 384, 384] flagship, [1, 1024, 1024] M=1024 and MNIST ConvKernel) and
# the NatGrad solve's ([20, 384, 384] flagship at 4 blocks a matrix,
# [10, 1024, 1024] M=1024 at 8; their inputs come from the ``aux``
# generator, see main) and depth 3's Kuu batch ([5, 384, 384]: two hidden
# layers' Kuu and KL prior, the last layer's Kuu; from the ``deep``
# generator).
K1K3_SOLVE_SHAPES = ((20, 384), (10, 1024))
K1K3_DEEP3_SHAPES = ((5, 384),)
K1K3_SHAPES = ((3, 64), (1, 128), (8, 128), (3, 384), (1, 1024)) + \
    K1K3_SOLVE_SHAPES + K1K3_DEEP3_SHAPES


def k1_k3_phases(torch, dev, card: dict, rng, aux, deep, Kuu) -> list:
    """K1 (the whole blocked factor, one cluster a matrix) and K3 (the whole
    inverse by column strips) at K1K3_SHAPES: each against its plain
    version on the same inputs, the route against float64, a non-PD
    element (K1) and a zero pivot (K3) non-finite in that element only;
    each timed by the profiler beside its call, its plain version, one
    library call and its bound, and the route beside the library's pair.
    Returns the kernels-line entries of K1 and K3, at [1, 1024, 1024]."""
    from deepcgp_tpu_torch.ops import cuda_linalg as cl
    k1 = {'name': 'chol_inv_base', 'route': 'cuda',
          'source': 'deepcgp_tpu_torch/csrc/chol_inv.cu',
          'replaces': 'deepcgp_tpu/ops/pallas_linalg.py:80', 'max_abs_err': 0.0}
    k3 = {'name': 'tri_inv_base', 'route': 'cuda',
          'source': 'deepcgp_tpu_torch/csrc/tri_inv.cu',
          'replaces': 'deepcgp_tpu/ops/pallas_linalg.py:165', 'max_abs_err': 0.0}
    for b, M in K1K3_SHAPES:
        g_rng = (deep if (b, M) in K1K3_DEEP3_SHAPES else
                 aux if (b, M) in K1K3_SOLVE_SHAPES else rng)
        D = (Kuu[:, :M, :M].contiguous() if M == 64
             else spd_batch(torch, g_rng, b, M, dev))
        L, Dinv = cl.chol_factor_blocked(D)
        X = cl.tri_inv_blocked(L, Dinv)
        X0 = cl.tri_inv_blocked(L)
        torch.cuda.synchronize()
        Lp, Dinvp = cl.chol_factor_blocked_plain(D)
        Xp, X0p = cl.tri_inv_blocked_plain(L, Dinv), cl.tri_inv_blocked_plain(L)
        err = {'L': rel(L, Lp), 'Dinv': rel(Dinv, Dinvp), 'X': rel(X, Xp),
               'X_without_Dinv': rel(X0, X0p)}
        recon = float(torch.linalg.matrix_norm(L @ L.transpose(1, 2) - D).max()
                      / torch.linalg.matrix_norm(D).min())
        lower = bool((torch.triu(L, 1) == 0).all() and (torch.triu(X, 1) == 0).all())
        Lr = torch.linalg.cholesky(D.double().cpu())
        eyeM = torch.eye(M, device=dev).expand(b, M, M)
        Xr = torch.linalg.solve_triangular(Lr, eyeM.double().cpu(), upper=False)
        f64 = {'L': rel(L.double().cpu(), Lr), 'X': rel(X.double().cpu(), Xr)}
        # A second element where the batch has one: element 1 non-PD (K1),
        # a zero pivot in element 1's factor (K3 without K1's inverses).
        pair = D if b > 1 else D.expand(2, M, M)
        bad = pair.clone()
        bad[1] = -torch.eye(M, device=dev)
        Lb, Db = cl.chol_factor_blocked(bad)
        Xb = cl.tri_inv_blocked(Lb, Db)
        Lz = (L if b > 1 else L.expand(2, M, M)).clone()
        Lz[1, 5, 5] = 0.0
        Xz = cl.tri_inv_blocked(Lz)
        rest = [i for i in range(bad.shape[0]) if i != 1]
        nan_ok = (not finite(torch, Lb[1]) and not finite(torch, Xb[1])
                  and finite(torch, Lb[rest]) and finite(torch, Xb[rest]))
        zero_ok = not finite(torch, Xz[1]) and finite(torch, Xz[rest])
        check(max(err.values()) <= 1e-5 and recon <= 5e-6 and lower
              and max(f64.values()) <= 1e-4 and nan_ok and zero_ok,
              f'K1/K3 [{b},{M},{M}]: vs plain {err}, recon {recon}, lower '
              f'{lower}, route vs float64 {f64}, non-PD NaN in its element '
              f'only {nan_ok}, zero pivot {zero_ok}')

        def library_factor(D=D):
            return torch.linalg.cholesky(D)

        def library_inverse(L=L, eyeM=eyeM):
            return torch.linalg.solve_triangular(L, eyeM, upper=False)

        def library_pair(D=D, eyeM=eyeM):
            return torch.linalg.solve_triangular(torch.linalg.cholesky(D),
                                                 eyeM, upper=False)
        # Cholesky M^3/3 and the triangular inverse M^3/3 per matrix; each
        # reads its input once and writes its output once.
        bnd, by = bound_ms(8 * b * M * M, b * M ** 3 / 3)
        plain_iters = 2 if M == 1024 else 5
        line = {'phase': 'K1/K3 blocked', **card, 'shape': [b, M, M],
                'input': 'flagship Kuu[:, :64, :64]' if M == 64 else 'spd',
                'cluster_blocks': cl._cluster(M, b),
                'rel_err_vs_plain': err, 'recon_rel_err': recon,
                'lower_triangular': lower, 'route_rel_err_vs_f64': f64,
                'non_pd_gives_nan': nan_ok,
                'zero_pivot_gives_non_finite': zero_ok,
                'tolerance': K1K3_TOLERANCE,
                'k1_ms': kernel_ms(torch, lambda: cl.chol_factor_blocked(D),
                                   'chol_factor_cluster_kernel'),
                'k1_call_ms': cuda_ms(torch, lambda: cl.chol_factor_blocked(D), 50),
                'k1_plain_ms': cuda_ms(
                    torch, lambda: cl.chol_factor_blocked_plain(D), plain_iters),
                'k1_library_ms': cuda_ms(torch, library_factor, 50),
                'k3_ms': kernel_ms(torch, lambda: cl.tri_inv_blocked(L, Dinv),
                                   'tri_inv_strip_kernel'),
                'k3_without_dinv_ms': kernel_ms(
                    torch, lambda: cl.tri_inv_blocked(L), 'tri_inv_strip_kernel'),
                'k3_call_ms': cuda_ms(torch, lambda: cl.tri_inv_blocked(L, Dinv), 50),
                'k3_plain_ms': cuda_ms(
                    torch, lambda: cl.tri_inv_blocked_plain(L, Dinv), plain_iters),
                'k3_library_ms': cuda_ms(torch, library_inverse, 50),
                'bound_ms': bnd, 'bound_by': by,
                'route_ms': cuda_ms(torch, lambda: cl.chol_inv_batched(D), 50),
                'route_library_ms': cuda_ms(torch, library_pair, 50),
                'library_call': 'torch.linalg.cholesky (K1), '
                                'solve_triangular(L, I) (K3), both (route)'}
        emit(line)
        k1['max_abs_err'] = max(k1['max_abs_err'], float(max(
            (L - Lp).abs().max(), (Dinv - Dinvp).abs().max())))
        k3['max_abs_err'] = max(k3['max_abs_err'], float(max(
            (X - Xp).abs().max(), (X0 - X0p).abs().max())))
        if (b, M) == (1, 1024):
            for k, pre in ((k1, 'k1_'), (k3, 'k3_')):
                k.update({key: line[pre + key] for key in (
                    'ms', 'plain_ms', 'library_ms')},
                    bound_ms=bnd, bound_by=by, shape=[b, M, M])
    return [k1, k3]


# K2's whole-factor shapes: the NatGrad solve's G on the flagship
# ([20, 384, 384]), M=1024 ([10, 1024, 1024]) and M=1088 ([10, 1088, 1088])
# paths, and [2, 1088, 1088] and [2, 2048, 2048] beyond K1's largest
# matrix (inputs from the ``aux`` generator); then depth 3's
# ([30, 384, 384]: three layers of 10 GPs, inputs and the garbage above
# the diagonal from the ``deep`` generator).
K2_DEEP3_SHAPES = ((30, 384),)
K2_SHAPES = ((20, 384), (10, 1024), (2, 1088), (10, 1088), (2, 2048)) + \
    K2_DEEP3_SHAPES
K2_TOLERANCE = ('relative to max|.|: factor and Dinv <= 1e-5 of the plain '
                'version on the same inputs; R R^T against G and the solve '
                'W R^-T against float64 <= 1e-4; bit-equal with garbage '
                'above the diagonal, and to K1 on J G J (M <= 1024)')


def k2_phases(torch, dev, card: dict, rng, aux, deep) -> list:
    """K2 (the whole upper factor, one cluster a matrix, from G's lower
    triangle) at K2_SHAPES: against its plain version and float64, bit-equal
    with garbage above G's diagonal and to K1 on J G J, a non-PD element NaN
    in that element only; timed by the profiler beside its plain version,
    ``torch.linalg.cholesky`` of the flipped matrix and its bound; K3 at
    [2, 2048, 2048] against its plain version.  Then the upper base case
    (K2 then K3 on a block, the JAX signature the panel driver calls) at
    [20, 64, 64] and [10, 128, 128].  Returns the kernels-line entry of K2,
    at [10, 1024, 1024]."""
    from deepcgp_tpu_torch.ops import cuda_linalg as cl
    k2 = {'name': 'chol_inv_base_upper', 'route': 'cuda',
          'source': 'deepcgp_tpu_torch/csrc/chol_inv.cu',
          'replaces': 'deepcgp_tpu/ops/pallas_linalg.py:135', 'max_abs_err': 0.0}
    for b, M in K2_SHAPES:
        g_rng = deep if (b, M) in K2_DEEP3_SHAPES else aux
        D = spd_batch(torch, g_rng, b, M, dev)
        G = torch.tril(D)
        noise = (torch.as_tensor(deep.randn(b, M, M), dtype=G.dtype, device=dev)
                 if g_rng is deep else torch.randn(b, M, M, device=dev))
        Gg = G + torch.triu(noise * 1e3, 1)
        X = torch.tril(spd_batch(torch, g_rng, b, M, dev))
        Lf, Dv = cl.chol_upper_blocked(G)
        torch.cuda.synchronize()
        Lp, Dp = cl.chol_upper_blocked_plain(G)
        err = {'Lf': rel(Lf, Lp), 'Dinv': rel(Dv, Dp)}
        garbage = all(torch.equal(a, c) for a, c in zip(
            cl.chol_upper_blocked(Gg), (Lf, Dv)))
        k1_equal = None
        if M <= cl.MAX_M:
            k1_equal = all(torch.equal(a, c) for a, c in zip(
                cl.chol_factor_blocked(cl.reversed_sym_from_tril(G)), (Lf, Dv)))
        R = Lf.double().flip(-1, -2)
        Dd = D.double().cpu()
        recon = rel((R @ R.transpose(-1, -2)).cpu(), Dd)
        Rd = torch.linalg.cholesky(Dd.flip(-1, -2)).flip(-1, -2)
        Yref = torch.linalg.solve_triangular(Rd.transpose(-1, -2),
                                             X.double().cpu(), upper=False,
                                             left=False)
        solve = rel(cl.chol_right_solve_reversed(G, X).double().cpu(), Yref)
        pair = G if b > 1 else G.expand(2, M, M)
        bad = pair.clone()
        bad[1] = -torch.eye(M, device=dev)
        Lb, Db = cl.chol_upper_blocked(bad)
        rest = [i for i in range(bad.shape[0]) if i != 1]
        alone = Lf if b > 1 else Lf.expand(2, M, M)
        nan_ok = (not finite(torch, Lb[1]) and not finite(torch, Db[1])
                  and bool(torch.equal(Lb[rest], alone[rest])))
        check(max(err.values()) <= 1e-5 and recon <= 1e-4 and solve <= 1e-4
              and garbage and k1_equal in (None, True) and nan_ok,
              f'K2 [{b},{M},{M}]: vs plain {err}, R R^T vs float64 {recon}, '
              f'solve vs float64 {solve}, garbage above the diagonal '
              f'changes nothing {garbage}, equal to K1 on J G J {k1_equal}, '
              f'non-PD NaN in its element only {nan_ok}')
        Gf = D.flip(-1, -2)
        bnd, by = k2_bound_ms(b, M)
        line = {'phase': 'K2 chol_upper_blocked', **card, 'shape': [b, M, M],
                'cluster_blocks': cl._upper_cluster(M, b),
                'smem_bytes': cl.upper_plan(
                    M, cl._upper_cluster(M, b))['smem_bytes'],
                'rel_err_vs_plain': err, 'recon_rel_err_vs_f64': recon,
                'solve_rel_err_vs_f64': solve,
                'garbage_above_diagonal_bit_equal': garbage,
                'bit_equal_to_k1_on_reversed': k1_equal,
                'non_pd_gives_nan': nan_ok, 'tolerance': K2_TOLERANCE,
                'ms': kernel_ms(torch, lambda: cl.chol_upper_blocked(G),
                                'chol_upper_cluster_kernel'),
                'call_ms': cuda_ms(torch, lambda: cl.chol_upper_blocked(G), 20),
                'plain_ms': cuda_ms(
                    torch, lambda: cl.chol_upper_blocked_plain(G), 2),
                'library_ms': cuda_ms(
                    torch, lambda: torch.linalg.cholesky(Gf), 20),
                'library_call': 'torch.linalg.cholesky of the flipped matrix',
                'bound_ms': bnd, 'bound_by': by}
        if (b, M) == (2, 2048):
            # K3 at its new largest matrix, with and without K2's Dinv.
            Xi, X0 = cl.tri_inv_blocked(Lf, Dv), cl.tri_inv_blocked(Lf)
            torch.cuda.synchronize()
            k3_err = {'X': rel(Xi, cl.tri_inv_blocked_plain(Lf, Dv)),
                      'X_without_Dinv': rel(X0, cl.tri_inv_blocked_plain(Lf))}
            check(max(k3_err.values()) <= 1e-5, f'K3 [2,2048,2048]: {k3_err}')
            line.update(k3_rel_err_vs_plain=k3_err, k3_ms=kernel_ms(
                torch, lambda: cl.tri_inv_blocked(Lf, Dv),
                'tri_inv_strip_kernel'))
        emit(line)
        k2['max_abs_err'] = max(k2['max_abs_err'], float(max(
            (Lf - Lp).abs().max(), (Dv - Dp).abs().max())))
        if (b, M) == (10, 1024):
            k2.update({key: line[key] for key in (
                'ms', 'plain_ms', 'library_ms', 'bound_ms', 'bound_by')},
                shape=[b, M, M])

    # The upper base case of the JAX signature, [b, P, P] -> (R, R^-1):
    # K2 then K3 on the block, at the old base shapes.
    for b, P in ((20, 64), (10, 128)):
        D = spd_batch(torch, rng, b, P, dev)
        R, Ri = cl.chol_inv_base_upper(D)
        torch.cuda.synchronize()
        Lp, Dp = cl.chol_upper_blocked_plain(D)
        Rp, Rip = Lp.flip(-1, -2), cl.tri_inv_blocked_plain(Lp, Dp).flip(-1, -2)
        eR, eRi = rel(R, Rp), rel(Ri, Rip)
        recon = float(torch.linalg.matrix_norm(R @ R.transpose(1, 2) - D).max()
                      / torch.linalg.matrix_norm(D).min())
        upper = bool((torch.tril(R, -1) == 0).all()
                     and (torch.tril(Ri, -1) == 0).all())
        bad = D.clone()
        bad[1] = -torch.eye(P, device=dev)
        Rb, Rib = cl.chol_inv_base_upper(bad)
        rest = [i for i in range(b) if i != 1]
        nan_ok = (not finite(torch, Rb[1]) and not finite(torch, Rib[1])
                  and finite(torch, Rb[rest]) and finite(torch, Rib[rest]))
        check(eR <= 1e-5 and eRi <= 1e-5 and recon <= 5e-6 and upper and nan_ok,
              f'K2 + K3 base [{b},{P},{P}]: dR {eR}, dRinv {eRi}, recon '
              f'{recon}, upper {upper}, non-PD NaN in its element only {nan_ok}')
        Df = D.flip(-1, -2)
        eyeb = torch.eye(P, device=dev).expand(b, P, P)
        bnd, by = k2_bound_ms(b, P)        # 'ms' times K2 alone
        emit({'phase': 'K2 chol_inv_base_upper', **card, 'shape': [b, P, P],
              'max_rel_err_R': eR, 'max_rel_err_Rinv': eRi,
              'recon_rel_err': recon, 'non_pd_gives_nan': nan_ok,
              'tolerance': 'relative to max|.|: R and R^-1 <= 1e-5 of the '
                           'plain versions, reconstruction <= 5e-6',
              'ms': kernel_ms(torch, lambda: cl.chol_upper_blocked(D),
                              'chol_upper_cluster_kernel'),
              'call_ms': cuda_ms(torch, lambda: cl.chol_inv_base_upper(D), 200),
              'plain_ms': cuda_ms(
                  torch, lambda: cl.chol_upper_blocked_plain(D), 5),
              'library_ms': cuda_ms(torch, lambda: torch.linalg.solve_triangular(
                  torch.linalg.cholesky(Df), eyeb, upper=False), 50),
              'library_call': 'torch.linalg.cholesky of the index-reversed '
                              'matrix + solve_triangular (call_ms: K2 + K3)',
              'bound_ms': bnd, 'bound_by': by})
    return [k2]


def driver_phases(torch, dev, card: dict, rng, aux) -> None:
    """The NatGrad solve W R^-T against float64 at the main paths' shapes
    ([20, 384, 384] flagship, [10, 1024, 1024] M=1024) and beyond K1's
    largest matrix ([2, 1088, 1088], [2, 2048, 2048], and [1, 3072, 3072]
    beyond K2's, by the panel driver at panel 1024): by its route, by the
    other kernel routes where they take the shape (K1 on J G J, the panel
    driver called explicitly) and by two library forms, each timed in
    turns (forward, then backward) in the same call; G passed as its lower
    triangle and with garbage above the diagonal.  Then ``chol_with_inv``
    (K1 then K3) at [1024, 1024] and [3, 384, 384] beside the library."""
    from deepcgp_tpu_torch.ops import cuda_linalg as cl
    from deepcgp_tpu_torch.ops import linalg
    drivers = {}
    for b, M, panel, gen in ((20, 384, 64, rng), (10, 1024, 128, rng),
                             (2, 1088, 64, rng), (2, 2048, None, aux),
                             (1, 3072, 1024, aux)):
        G = spd_batch(torch, gen, b, M, dev)
        Gt = torch.tril(G)
        Gg = Gt + torch.triu(torch.randn(b, M, M, device=dev) * 1e3, 1)
        W = torch.tril(spd_batch(torch, gen, b, M, dev))
        Gd, Wd = G.double().cpu(), W.double().cpu()
        Rd = torch.linalg.cholesky(Gd.flip(-1, -2)).flip(-1, -2)
        Yref = torch.linalg.solve_triangular(Rd.transpose(-1, -2), Wd,
                                             upper=False, left=False)
        Gf = G.flip(-1, -2)
        eyeM = torch.eye(M, device=dev).expand(b, M, M)

        def route(G=Gt, W=W):
            return cl.chol_right_solve_upper(G, W)

        def reversed_route(G=Gt, W=W):
            # The route up to M = 1024 before K2 took the whole matrix:
            # J G J built first, then K1, K3 and the product.
            Lf, Dinv = cl.chol_factor_blocked(cl.reversed_sym_from_tril(G))
            Lfinv = cl.tri_inv_blocked(Lf, Dinv)
            return W @ Lfinv.flip(-1, -2).transpose(-1, -2)

        def panels(G=Gt, W=W, p=panel):
            return cl.chol_right_solve_upper_panels(G, W, panel=p)

        def library_inverse(Gf=Gf, eyeM=eyeM, W=W):
            Lf = torch.linalg.cholesky(Gf)
            Rinv = torch.linalg.solve_triangular(Lf, eyeM, upper=False).flip(-1, -2)
            return W @ Rinv.transpose(-1, -2)

        def library_solve(Gf=Gf, W=W):
            Lf = torch.linalg.cholesky(Gf)          # R^T = J Lf^T J, lower
            return torch.linalg.solve_triangular(
                Lf.transpose(-1, -2).flip(-1, -2), W, upper=False, left=False)
        kind = cl.upper_route(M)[0]
        forms = {kind: route}
        if M <= cl.MAX_M:
            forms['reversed'] = reversed_route
        if panel and kind != 'panels':
            forms['panels'] = panels
        forms.update(library_inverse=library_inverse, library_solve=library_solve)
        entry = {'shape': [b, M, M], 'route': kind, 'panel': panel,
                 'rel_err_vs_f64': {}, 'launches_per_call': {},
                 'tril_only_equals_garbage': {}}
        for name, fn in forms.items():
            before = (cl.chol_inv_base.launches, cl.tri_inv_base.launches,
                      cl.chol_inv_base_upper.launches)
            Y = fn()
            torch.cuda.synchronize()
            after = (cl.chol_inv_base.launches, cl.tri_inv_base.launches,
                     cl.chol_inv_base_upper.launches)
            entry['launches_per_call'][name] = dict(zip(
                ('K1', 'K3', 'K2'), (a - b0 for a, b0 in zip(after, before))))
            entry['rel_err_vs_f64'][name] = rel(Y.double().cpu(), Yref)
            if not name.startswith('library'):
                entry['tril_only_equals_garbage'][name] = bool(torch.equal(
                    fn(G=Gg), Y))
        # Each form timed twice, in turns: forward order, then backward.
        iters = 10 if M < 1024 else 5
        order = list(forms)
        for name in order + order[::-1]:
            entry.setdefault(f'{name}_ms_runs', []).append(
                cuda_ms(torch, forms[name], iters))
        for name in order:
            entry[f'{name}_ms'] = float(np.mean(entry[f'{name}_ms_runs']))
        entry['library_ms'] = min(entry['library_inverse_ms'],
                                  entry['library_solve_ms'])
        entry['route_over_library'] = entry[f'{kind}_ms'] / entry['library_ms']
        if 'reversed' in forms:
            entry['route_over_reversed'] = (entry[f'{kind}_ms']
                                            / entry['reversed_ms'])
        # What the function needs: the factor B M^3 / 3 and the solve
        # B N M^2 (N = M); G's lower triangle and W read once, the output
        # written once.
        entry['bound_ms'], entry['bound_by'] = bound_ms(
            4 * b * (M * (M + 1) // 2 + 2 * M * M), b * M ** 3 / 3 + b * M ** 3)
        label = f'natgrad solve {b}x{M}'
        drivers[label] = entry
        expected = {'upper': {'K1': 0, 'K3': 1, 'K2': 1},
                    'reversed': {'K1': 1, 'K3': 1, 'K2': 0},
                    'panels': {'K1': 0, 'K3': M // (panel or M),
                               'K2': M // (panel or M)}}
        check(max(entry['rel_err_vs_f64'].values()) <= 1e-4
              and all(entry['tril_only_equals_garbage'].values())
              and all(entry['launches_per_call'][k] == v
                      for k, v in expected.items() if k in forms),
              f'{label}: {entry}')
    # chol_with_inv at the two route shapes (two launches each), beside
    # the library's factor plus inverse timed in the same call.
    for label, K in (('chol_with_inv 1x1024', spd_batch(torch, rng, 1, 1024, dev)[0]),
                     ('chol_with_inv 3x384', spd_batch(torch, rng, 3, 384, dev))):
        M = K.shape[-1]
        L, Li = linalg.chol_with_inv(K)
        Lref = torch.linalg.cholesky(K.double().cpu())
        Liref = torch.linalg.solve_triangular(
            Lref, torch.eye(M, dtype=torch.float64).expand(Lref.shape),
            upper=False)
        eL, eLi = rel(L.double().cpu(), Lref), rel(Li.double().cpu(), Liref)
        check(eL <= 1e-4 and eLi <= 1e-4, f'{label}: {eL}, {eLi}')
        eyeK = torch.eye(M, device=dev).expand(K.shape)
        ms = cuda_ms(torch, lambda K=K: linalg.chol_with_inv(K), 20)
        lib = cuda_ms(torch, lambda K=K, e=eyeK: torch.linalg.solve_triangular(
            torch.linalg.cholesky(K), e, upper=False), 20)
        drivers[label] = {'rel_err_vs_f64': [eL, eLi], 'ms': ms,
                          'library_ms': lib, 'ms_over_library_ms': ms / lib}
    emit({'phase': 'linalg drivers', **card, 'drivers': drivers,
          'tolerance': 'relative to max|.| of the float64 result: 1e-4; '
                       'the kernel routes bit-equal with G tril-only and '
                       'with garbage above the diagonal; launches per call '
                       'exactly 1 K2 + 1 K3 (upper), 1 K1 + 1 K3 '
                       '(reversed), M/panel K2 and K3 (panels)',
          'library_call': 'torch.linalg.cholesky of J G J, then '
                          'solve_triangular(L, I) and the product W R^-T '
                          '(library_inverse) or solve_triangular on W '
                          '(library_solve); library_ms is the faster'})


NATGRAD_STEP_TOLERANCE = (
    'ELBO 1e-4 relative; q_mu and q_sqrt after the step within 1e-4 of '
    "their largest magnitude, the step's change within 5e-2 of its largest "
    '(the gradients behind it agree to 1e-2 in float32) or, where float32 '
    "itself is that far off, within 5e-2 plus twice the CPU float32's "
    'distance of the float64 change')


def natgrad_step_vs_cpu(torch, model, config, Xd, Yd, batch: int, seed: int,
                        rng):
    """One NatGrad step's proposal from ``model``, the card against the
    same model on the CPU (plain versions), float64 on the CPU as the
    reference: the same parameters, batch and noise (drawn from ``rng``),
    every side from step 0 and steps_back 0.  Returns (the phase line's
    fields, None or what disagreed)."""
    from deepcgp_tpu_torch.training import trainer
    noise = [rng.randn(model.num_samples, batch, layer.num_outputs)
             for layer in model.layers]
    xb, yb = Xd[:batch], Yd[:batch]
    dev = xb.device
    sides = {}
    for side, device, dtype in (('card', dev, torch.float32),
                                ('cpu', torch.device('cpu'), torch.float32),
                                ('f64', torch.device('cpu'), torch.float64)):
        st = trainer.init_state(copy.deepcopy(model).to(device, dtype), config,
                                seed=seed)
        before = {k: p.detach().clone() for k, p in st.params.items()
                  if k.endswith(('q_mu', 'q_sqrt'))}
        elbo = trainer.train_step(st, config, xb.to(device, dtype),
                                  yb.to(device), noise=noise)
        sides[side] = (float(elbo), {
            k: (st.params[k].detach().double().cpu(),
                (st.params[k] - before[k]).detach().double().cpu())
            for k in before})

    def errs(a, b, i):
        return {k: rel(v[i], sides[b][1][k][i]) for k, v in sides[a][1].items()}
    elbo_err = abs(sides['card'][0] - sides['cpu'][0]) / abs(sides['cpu'][0])
    param_err = errs('card', 'cpu', 0)
    delta_err = errs('card', 'cpu', 1)
    delta_f64 = {'card': errs('card', 'f64', 1), 'cpu': errs('cpu', 'f64', 1)}
    delta_ok = f32_agrees(delta_err, delta_f64['card'], delta_f64['cpu'], 5e-2)
    fields = {'card_vs_cpu': {'elbo_rel_err': elbo_err,
                              'param_rel_err': param_err,
                              'step_change_rel_err': delta_err},
              'step_change_rel_err_vs_f64': delta_f64,
              'elbo_card_cpu_f64': [sides[k][0] for k in ('card', 'cpu', 'f64')],
              'tolerance': NATGRAD_STEP_TOLERANCE}
    failure = None
    if not (elbo_err <= 1e-4 and max(param_err.values()) <= 1e-4
            and all(delta_ok.values())
            and all(np.isfinite(sides[k][0]) for k in sides)):
        failure = (f'NatGrad step, card vs CPU: elbo {elbo_err}, parameters '
                   f'{param_err}, their change {delta_err}, vs float64 '
                   f'{delta_f64}')
    return fields, failure


def natgrad_training(torch, label: str, flags, image, batch: int, seed: int,
                     rng, dev, card: dict, reset_counts, read_counts,
                     warmup: int, chunk: int, window_seconds: float,
                     noise_rng=None):
    """NatGrad training from a fresh build on TRAIN_IMAGES synthetic images:
    ``warmup`` steps, then ``chunk``-step ``run_chunk`` calls for
    ``window_seconds`` (one at least), with the launch counters checked
    per step and per chunk; then one step on the card against the same
    model on the CPU, same batch and noise (drawn from ``noise_rng``,
    default ``rng``).  Returns (state, config, Xd, Yd, launches, the
    freshly built model)."""
    import copy
    from deepcgp_tpu_torch.models import builder as mbuilder
    from deepcgp_tpu_torch.training import trainer
    X = rng.randn(TRAIN_IMAGES, *image).astype(np.float32)
    Y = rng.randint(0, 10, size=(TRAIN_IMAGES, 1))
    t = time.perf_counter()
    model = mbuilder.build_model(
        flags, image, images=X, generator=torch.Generator().manual_seed(seed),
        device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t
    fresh = copy.deepcopy(model)
    config = trainer.TrainConfig(optimizer='NatGrad', lr=0.01,
                                 batch_size=batch, gamma=0.001)
    state = trainer.init_state(model, config, seed=seed)
    Xd = torch.as_tensor(X.reshape(TRAIN_IMAGES, -1), device=dev)
    Yd = torch.as_tensor(Y, device=dev)
    warm = trainer.run_chunk(state, config, Xd, Yd, warmup)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    traces = []
    t_window = time.perf_counter()
    while not traces or time.perf_counter() - t_window < window_seconds:
        traces.append(trainer.run_chunk(state, config, Xd, Yd, chunk))
        torch.cuda.synchronize()
    window = time.perf_counter() - t_window
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    steps = chunk * len(traces)
    WINDOW_STEPS_PER_S[label] = steps / window
    expected = launches_of(**{
        k: n * steps + NATGRAD_PER_CHUNK[label].get(k, 0) * len(traces)
        for k, n in NATGRAD_PER_STEP[label].items()})
    trace = torch.cat([warm] + traces).cpu().numpy()
    check(bool(np.isfinite(trace).all()), f'{label} NatGrad: an ELBO is not finite')
    check(launches == expected, f'{label} NatGrad: launches {launches} for '
          f'{steps} steps in {len(traces)} chunks, expected {expected}')

    fields, failure = natgrad_step_vs_cpu(torch, model, config, Xd, Yd,
                                          batch, seed, noise_rng or rng)
    emit({'phase': f'natgrad training {label}', **card, 'config': dict(flags.__dict__),
          'image': list(image), 'optimizer': 'NatGrad', 'lr': config.lr,
          'gamma': config.gamma, 'batch_size': batch,
          'num_samples': model.num_samples, 'build_seconds': build_s,
          'warmup_steps': warmup, 'chunk_steps': chunk, 'window_chunks': len(traces),
          'window_steps': steps, 'window_seconds': window,
          'steps_per_s': steps / window, 'launches': launches,
          'elbo_first': float(trace[0]), 'elbo_window_start': float(trace[warmup]),
          'elbo_last': float(trace[-1]), 'steps_back': float(state.steps_back),
          'max_memory_allocated_bytes': peak, **fields})
    check(failure is None, f'{label} {failure}')
    return state, config, Xd, Yd, launches, fresh


def m1024_adam(torch, model, seed: int, rng, dev, card: dict, reset_counts,
               read_counts) -> dict:
    """A short Adam run of the M=1024 configuration (two 10-step chunks after
    5 warm-up steps): the q_sqrt moments stored in bf16 by stochastic
    rounding, 1 K1 + 1 K3 launches per step, finite ELBOs; and the
    rounding on the card bit-identical to the CPU on the same input and
    salt.  Returns the launches."""
    from deepcgp_tpu_torch.training import optim, trainer
    X = rng.randn(TRAIN_IMAGES, *M1024_IMAGE).astype(np.float32)
    Xd = torch.as_tensor(X.reshape(TRAIN_IMAGES, -1), device=dev)
    Yd = torch.as_tensor(rng.randint(0, 10, size=(TRAIN_IMAGES, 1)), device=dev)
    config = trainer.TrainConfig(optimizer='Adam', lr=0.01, batch_size=M1024_BATCH)
    state = trainer.init_state(model, config, seed=seed)
    stores = {k: str(v.dtype) for k, v in state.opt_state['mu'].items()}
    check(stores['layers.0.q_sqrt'] == 'torch.bfloat16'
          and stores['layers.0.Z'] == 'torch.float32',
          f'M=1024 Adam moment storage {stores}')
    warm = trainer.run_chunk(state, config, Xd, Yd, 5)
    torch.cuda.synchronize()
    reset_counts()
    t = time.perf_counter()
    traces = [trainer.run_chunk(state, config, Xd, Yd, 10) for _ in range(2)]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t
    launches = read_counts()
    trace = torch.cat([warm] + traces).cpu().numpy()
    check(bool(np.isfinite(trace).all()), 'M=1024 Adam: an ELBO is not finite')
    expected = launches_of(chol_inv_base=20, tri_inv_base=20)
    check(launches == expected, f'M=1024 Adam: launches {launches}, expected {expected}')
    x = torch.as_tensor(rng.randn(10, 1024, 1024) * np.exp(rng.uniform(
        -20, 20, (10, 1024, 1024))), dtype=torch.float32)
    salt = (7 * 0x9E3779B9 + 2 * 0x85EBCA77) & 0xFFFFFFFF
    on_card = optim._sr_to_bf16(x.to(dev), salt).cpu()
    on_cpu = optim._sr_to_bf16(x, salt)
    same = bool(torch.equal(on_card.view(torch.int16), on_cpu.view(torch.int16)))
    check(same, '_sr_to_bf16 differs between the card and the CPU')
    emit({'phase': 'm1024 adam', **card, 'config': M1024, 'batch_size': M1024_BATCH,
          'steps': 20, 'seconds': seconds, 'steps_per_s': 20 / seconds,
          'launches': launches, 'moment_dtypes': stores,
          'elbo_first': float(trace[0]), 'elbo_last': float(trace[-1]),
          'sr_to_bf16_card_equals_cpu_bits': same,
          'sr_to_bf16_elements': x.numel()})
    return launches


def k4_trace(torch, img, Z, variance, gamma, u, wkd, f, s, d,
             with_kdiag) -> dict:
    """SM clock cycles of K4's setup, k-loop and epilogue in the middle
    block of each item kind (a 128-column tile of M, or the Kdiag gram)
    (``conv_rbf_cross_traced``), the second of two launches."""
    from deepcgp_tpu_torch.ops import cuda_build, cuda_cross
    N, H, W, C = img.shape
    M = Z.shape[0]
    Zp = cuda_cross._padded_z(Z)
    Mpad, Lpad = Zp.shape
    kzx = torch.empty(N, M, device=img.device)
    kd = torch.empty(N, device=img.device)
    scal = torch.stack([variance, gamma]).float()
    trace = torch.zeros(32, dtype=torch.int64, device=img.device)
    fn = cuda_build.function(
        'conv_rbf_cross', 'conv_rbf_cross_traced',
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 12 + [ctypes.c_void_p] * 2)
    for _ in range(2):
        trace.zero_()
        cuda_build.check(fn(
            img.data_ptr(), Zp.data_ptr(), scal.data_ptr(), u.data_ptr(),
            wkd.data_ptr(), kzx.data_ptr(), kd.data_ptr(), N, H, W, C, f, s,
            d, M, Mpad, Lpad, cuda_cross.fwd_group(u.shape[0]),
            int(with_kdiag), trace.data_ptr(),
            torch.cuda.current_stream().cuda_stream), 'traced')
    torch.cuda.synchronize()
    t = trace.cpu().tolist()
    items = cuda_cross.fwd_grid(N, u.shape[0], M, with_kdiag)[1]
    return {('gram' if with_kdiag and y == items - 1 else f'columns {y}'):
            dict(zip(('setup', 'loop', 'epilogue'), t[3 * y:3 * y + 3]))
            for y in range(min(items, 8))}


K5_PHASES = ('setup', 'gram', 'cross', 'T', 'TZ', 'cluster_sync_1',
             'reduce', 'cluster_sync_2', 'col2im')


def k5_image_trace(torch, img, Z, variance, gamma, u, wkd, f, s, d,
                   with_kdiag, dkzx, dkd) -> dict:
    """SM clock cycles of the K5 image side's phases in its middle block
    (thread 0's clock64() at each boundary, ``conv_rbf_cross_bwd_image_traced``),
    the second of two launches."""
    from deepcgp_tpu_torch.ops import cuda_build, cuda_cross
    N, H, W, C = img.shape
    M = Z.shape[0]
    P = u.shape[0]
    Zt, Zp = cuda_cross._padded_zt(Z), cuda_cross._padded_z(Z)
    zn = cuda_cross._padded_zn(Z)
    Mpad = Zt.shape[1]
    T = torch.empty(N, P, Mpad, device=img.device)
    part = torch.empty(N, cuda_cross.bwd_cluster(M), 2 * P + 2, device=img.device)
    dimg = torch.empty_like(img)
    scal = torch.stack([variance, gamma]).float()
    trace = torch.zeros(10, dtype=torch.int64, device=img.device)
    fn = cuda_build.function(
        'conv_rbf_cross_bwd', 'conv_rbf_cross_bwd_image_traced',
        [ctypes.c_void_p] * 12 + [ctypes.c_int] * 10 + [ctypes.c_void_p] * 2)
    for _ in range(2):
        cuda_build.check(fn(
            img.data_ptr(), Zt.data_ptr(), Zp.data_ptr(), zn.data_ptr(),
            scal.data_ptr(),
            u.data_ptr(), wkd.data_ptr(), dkzx.data_ptr(), dkd.data_ptr(),
            T.data_ptr(), part.data_ptr(), dimg.data_ptr(), N, H, W, C, f, s,
            d, M, Mpad, int(with_kdiag), trace.data_ptr(),
            torch.cuda.current_stream().cuda_stream), 'traced')
    torch.cuda.synchronize()
    t = trace.cpu().tolist()
    return {name: t[i + 1] - t[i] for i, name in enumerate(K5_PHASES)}


# K6's split as the launcher computes it (csrc/patches.cu
# ``extract_patches_plan``), in the order of its plan[10].
K6_PLAN_KEYS = ('sms', 'vec', 'kc', 'kr', 'tasks_y', 'tasks_per_image', 'bh',
                'bw', 'staged', 'tasks')


def k6_plan_on_card(img, out, f, s, d, grid) -> dict:
    """K6's split for these tensors, from the library itself."""
    from deepcgp_tpu_torch.ops import cuda_build
    fn = cuda_build.function('patches', 'extract_patches_plan',
                             [ctypes.c_void_p] * 2 + [ctypes.c_int] * 9
                             + [ctypes.c_void_p])
    plan = (ctypes.c_longlong * len(K6_PLAN_KEYS))()
    cuda_build.check(fn(img.data_ptr(), out.data_ptr(), img.shape[0],
                        *img.shape[1:], f, s, d, *grid, plan),
                     'extract_patches_plan')
    return dict(zip(K6_PLAN_KEYS, plan))


def patches_phases(torch, dev, card: dict, rng, new_rng, deep) -> list:
    """K6 and K7 against their plain versions on the card, at the MNIST
    last layer ([32, 28, 28, 1], f5 s1 -> [32, 576, 25]), the CIFAR fm32
    last layer ([320, 10, 10, 32], f5 s1 -> [320, 36, 800]) and an odd
    shape with stride and dilation 2 ([7, 9, 11, 3], f3), then, from
    ``new_rng`` so that every earlier check keeps its inputs, the CIFAR
    strides 2,1 last layer ([320, 14, 14, 10] -> [320, 100, 250]), MNIST
    serving ([128, 28, 28, 1]), an image beyond a block's shared memory
    ([4, 40, 40, 40], 256 KB) and fm32's geometry at N = 64 with both
    tensors one float past 16-byte alignment (the kernels then move single
    floats), then, from ``deep``, depth 3's second hidden layer
    ([320, 14, 14, 10], f3 s1 -> [320, 144, 90]: its extraction's backward
    is K7) and its unfused last layer ([320, 12, 12, 10] -> [320, 100, 90]).
    K6 must equal its plain version bit for bit (it moves values
    untouched), K7 lie within 1e-6 of the largest magnitude (float32 sums
    in another order) and give the same bits in two launches; K6's split,
    as the launcher computes it, must equal ``cuda_patches.extract_plan``.
    Each is timed by the profiler, back to back and with the L2
    overwritten before each launch, beside its plain version, its bytes
    bound and the nearest library route: ``F.unfold`` / ``F.fold`` with
    the permutes that make their result equal to K6's / K7's (several
    calls, not one).  Returns the kernels-line entries of K6 and K7, at
    the fm32 shape."""
    import torch.nn.functional as F
    from deepcgp_tpu_torch.ops import cuda_patches as cp
    from deepcgp_tpu_torch.ops.patches import out_size
    shapes = (('mnist', 32, 28, 28, 1, 5, 1, 1),
              ('fm32', 320, 10, 10, 32, 5, 1, 1),
              ('odd', 7, 9, 11, 3, 3, 2, 2),
              ('strides21', 320, 14, 14, 10, 5, 1, 1),
              ('mnist serving', 128, 28, 28, 1, 5, 1, 1),
              ('beyond smem', 4, 40, 40, 40, 5, 1, 1),
              ('unaligned', 64, 10, 10, 32, 5, 1, 1),
              ('deep3 hidden', 320, 14, 14, 10, 3, 1, 1),
              ('deep3 last layer', 320, 12, 12, 10, 3, 1, 1))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    flush = torch.empty(2 ** 25, dtype=torch.float32, device=dev)  # 128 MiB
    k6 = {'name': 'extract_patches_transposed', 'route': 'cuda',
          'source': 'deepcgp_tpu_torch/csrc/patches.cu',
          'replaces': 'deepcgp_tpu/ops/pallas_patches.py:67',
          'max_abs_err': 0.0}
    k7 = {'name': 'col2im_transposed', 'route': 'cuda',
          'source': 'deepcgp_tpu_torch/csrc/patches.cu',
          'replaces': 'deepcgp_tpu/ops/pallas_patches.py:201',
          'max_abs_err': 0.0}
    for i, (label, N, H, W, C, f, s, d) in enumerate(shapes):
        g_rng = rng if i < 3 else new_rng if i < 7 else deep
        Hout, Wout = out_size(H, f, s, d), out_size(W, f, s, d)
        P, L = Hout * Wout, f * f * C
        lead = 1 if label == 'unaligned' else 0

        def tensor(*shape, g_rng=g_rng, lead=lead):
            flat = torch.as_tensor(g_rng.randn(lead + int(np.prod(shape))),
                                   dtype=torch.float32, device=dev)
            return flat[lead:].view(*shape)

        img, g = tensor(N, H, W, C), tensor(N, P, L)
        a6, a7 = (img, f, s, d), (g, (H, W, C), f, s, d)
        out = cp.extract_patches_transposed(*a6)
        back = cp.col2im_transposed(*a7)
        again = cp.col2im_transposed(*a7)
        torch.cuda.synchronize()
        out_p = cp.extract_patches_transposed_plain(*a6)
        back_p = cp.col2im_transposed_plain(*a7)
        k6_equal = bool(torch.equal(out, out_p))
        k7_err = rel(back, back_p)
        k7_same = bool(torch.equal(again, back))
        plan = k6_plan_on_card(img, out, f, s, d, (Hout, Wout))
        model = cp.extract_plan(N, (H, W, C), f, s, d, sms, cp.vector_width(
            C, img.data_ptr(), out.data_ptr()))
        plan_equal = all(plan[k] == model[k] for k in K6_PLAN_KEYS)

        def unfold(img=img, f=f, s=s, d=d, N=N, C=C, Hout=Hout, Wout=Wout):
            cols = F.unfold(img.permute(0, 3, 1, 2), f, dilation=d, stride=s)
            return (cols.reshape(N, C, f, f, Hout, Wout)
                    .permute(0, 5, 4, 2, 3, 1).reshape(N, Hout * Wout, -1))

        def fold(g=g, f=f, s=s, d=d, N=N, H=H, W=W, C=C, Hout=Hout,
                 Wout=Wout):
            cols = (g.reshape(N, Wout, Hout, f, f, C)
                    .permute(0, 5, 3, 4, 2, 1).reshape(N, C * f * f, -1))
            return F.fold(cols, (H, W), f, dilation=d,
                          stride=s).permute(0, 2, 3, 1).contiguous()

        lib_equal = bool(torch.equal(unfold(), out_p))
        lib_err = rel(fold(), back_p)
        check(k6_equal and k7_err <= 1e-6 and k7_same and plan_equal
              and lib_equal and lib_err <= 1e-6,
              f'K6/K7 {label}: K6 bit-equal {k6_equal}, K7 rel err {k7_err}, '
              f'K7 bit-equal in two launches {k7_same}, K6 split {plan} vs '
              f'the model {model}, unfold route equal {lib_equal}, fold '
              f'route rel err {lib_err}')
        nbytes = 4 * (N * H * W * C + N * P * L)
        b6 = bound_ms(nbytes, 0)
        b7 = bound_ms(nbytes, N * P * L)          # one add per element
        k6_ms = kernel_ms(torch, lambda: cp.extract_patches_transposed(*a6),
                          'extract_transposed_kernel')
        k7_ms = kernel_ms(torch, lambda: cp.col2im_transposed(*a7),
                          'col2im_transposed_kernel')
        # The same with the 50 MB L2 overwritten before every launch: fm32's
        # and strides 2,1's working sets fit in it, so back-to-back launches
        # read part of their input from L2.
        k6_cold = kernel_ms(torch, lambda: (
            flush.zero_(), cp.extract_patches_transposed(*a6)),
            'extract_transposed_kernel')
        k7_cold = kernel_ms(torch, lambda: (
            flush.zero_(), cp.col2im_transposed(*a7)),
            'col2im_transposed_kernel')
        line = {'phase': f'K6/K7 patches {label}', **card,
                'geometry': dict(N=N, H=H, W=W, C=C, f=f, stride=s,
                                 dilation=d, P=P, L=L),
                'unaligned_by_bytes': 4 * lead,
                'k6_split': plan,
                'k6_bit_equal': k6_equal,
                'k7_max_rel_err': k7_err,
                'k7_max_abs_err': float((back - back_p).abs().max()),
                'k7_bit_equal_two_launches': k7_same,
                'tolerance': 'K6 bit-equal; K7 within 1e-6 of max|.| and '
                             'bit-equal run to run',
                'k6_ms': k6_ms,
                'k6_plain_ms': cuda_ms(
                    torch, lambda: cp.extract_patches_transposed_plain(*a6), 20),
                'k6_library_ms': cuda_ms(torch, unfold, 20),
                'k6_bound_ms': b6[0], 'k6_bound_by': b6[1],
                'k6_fraction_of_bound': b6[0] / k6_ms,
                'k6_cold_l2_ms': k6_cold,
                'k7_ms': k7_ms,
                'k7_plain_ms': cuda_ms(
                    torch, lambda: cp.col2im_transposed_plain(*a7), 20),
                'k7_library_ms': cuda_ms(torch, fold, 20),
                'k7_bound_ms': b7[0], 'k7_bound_by': b7[1],
                'k7_fraction_of_bound': b7[0] / k7_ms,
                'k7_cold_l2_ms': k7_cold,
                'library_call': 'F.unfold + permute (K6), permute + F.fold + '
                                'permute (K7): several calls, not one'}
        emit(line)
        k6['max_abs_err'] = max(k6['max_abs_err'],
                                float((out - out_p).abs().max()))
        k7['max_abs_err'] = max(k7['max_abs_err'], line['k7_max_abs_err'])
        if label == 'fm32':
            for k, pre in ((k6, 'k6_'), (k7, 'k7_')):
                k.update({key: line[pre + key] for key in (
                    'ms', 'plain_ms', 'library_ms', 'bound_ms', 'bound_by')},
                    shape=f'N={N} {H}x{W}x{C} f={f} -> [{N}, {P}, {L}]')
    return [k6, k7]


def learnable_data(rng, image):
    """TRAIN_IMAGES seeded images and labels that depend on them (the
    argmax of a fixed random projection), so training moves the answers."""
    X = rng.randn(TRAIN_IMAGES, *image).astype(np.float32)
    proj = rng.randn(int(np.prod(image)), 10)
    Y = (X.reshape(TRAIN_IMAGES, -1) @ proj).argmax(1)[:, None]
    return X, Y


def unfused_adam(torch, label: str, flags: dict, image, seed: int, rng, dev,
                 card: dict, reset_counts, read_counts, loaded=None):
    """Adam training of an unfused-route configuration from a fresh build
    (``loaded``: per-layer parameters the build takes instead of its
    defaults): UNFUSED_WARMUP_STEPS steps, then UNFUSED_CHUNK-step
    ``run_chunk`` calls for UNFUSED_WINDOW_SECONDS, the launch counters
    checked against UNFUSED_PER_STEP; one step's loss and gradients against
    the CPU; then 16 steps under the profiler.  Returns (state, launches)."""
    from deepcgp_tpu_torch.models import builder as mbuilder
    from deepcgp_tpu_torch.ops import cuda_cross
    from deepcgp_tpu_torch.training import trainer
    X, Y = learnable_data(rng, image)
    t = time.perf_counter()
    model = mbuilder.build_model(
        types.SimpleNamespace(**flags, num_samples=TRAIN_SAMPLES), image,
        loaded, images=X, generator=torch.Generator().manual_seed(seed),
        device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t
    last = model.layers[-1].kernel
    check(not cuda_cross.fused_fits(last),
          f'{label}: the last layer would take the fused route')
    config = trainer.TrainConfig(optimizer='Adam', lr=0.01,
                                 batch_size=TRAIN_BATCH)
    state = trainer.init_state(model, config, seed=seed)
    stores = {k: str(v.dtype) for k, v in state.opt_state['mu'].items()}
    check(label != 'mnist_conv' or stores['layers.0.q_sqrt'] == 'torch.bfloat16',
          f'{label}: Adam moment storage {stores}')
    Xd = torch.as_tensor(X.reshape(TRAIN_IMAGES, -1), device=dev)
    Yd = torch.as_tensor(Y, device=dev)
    warm = trainer.run_chunk(state, config, Xd, Yd, UNFUSED_WARMUP_STEPS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    traces = []
    t_window = time.perf_counter()
    while time.perf_counter() - t_window < UNFUSED_WINDOW_SECONDS:
        traces.append(trainer.run_chunk(state, config, Xd, Yd, UNFUSED_CHUNK))
        torch.cuda.synchronize()
    window = time.perf_counter() - t_window
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    steps = UNFUSED_CHUNK * len(traces)
    trace = torch.cat([warm] + traces).cpu().numpy()
    check(bool(np.isfinite(trace).all()), f'{label} Adam: an ELBO is not finite')
    expected = launches_of(**{k: n * steps
                              for k, n in UNFUSED_PER_STEP[label].items()})
    check(launches == expected, f'{label} Adam: launches {launches} for '
          f'{steps} steps, expected {expected}')
    fields, failure = adam_step_vs_cpu(torch, state, config, Xd, Yd,
                                       TRAIN_BATCH, rng)
    view = last.view
    emit({'phase': f'adam training {label}', **card, 'config': flags,
          'image': list(image), 'loaded_parameters': loaded or {},
          'last_layer_P_L': [view.patch_count, view.patch_length],
          'optimizer': 'Adam', 'lr': config.lr, 'batch_size': TRAIN_BATCH,
          'num_samples': TRAIN_SAMPLES, 'build_seconds': build_s,
          'warmup_steps': UNFUSED_WARMUP_STEPS, 'chunk_steps': UNFUSED_CHUNK,
          'window_steps': steps, 'window_seconds': window,
          'steps_per_s': steps / window, 'launches': launches,
          'launches_per_step': UNFUSED_PER_STEP[label],
          'moment_dtypes': stores, 'elbo_first': float(trace[0]),
          'elbo_window_start': float(trace[UNFUSED_WARMUP_STEPS]),
          'elbo_last': float(trace[-1]),
          'max_memory_allocated_bytes': peak, **fields})
    check(failure is None, f'{label} {failure}')
    wall_ms, busy_ms, top, rounds = profile_device(
        torch, lambda: trainer.run_chunk(state, config, Xd, Yd, 16),
        reset_counts, read_counts)
    emit({'phase': f'adam training profile {label}', **card, 'steps': 16,
          'wall_ms': wall_ms, 'device_busy_ms': busy_ms,
          'device_busy_share': busy_ms / wall_ms, 'profile_rounds': rounds,
          'top_device_ms': top})
    return state, launches


FM32_DEFAULT_FLOOR = 1e-8


def fm32_default_init_step(torch, seed: int, rng, dev, card: dict) -> None:
    """One Adam step of CIFAR fm32 from the builder's default init (last
    layer lengthscale 5, where the timed window starts at 25), the card
    against the CPU under the same rule as every path, with layer 1's
    leaves whose float64 gradient is below FM32_DEFAULT_FLOOR read and not
    held to it (float32 cannot resolve them on either side)."""
    from deepcgp_tpu_torch.models import builder as mbuilder
    from deepcgp_tpu_torch.training import trainer
    X, Y = learnable_data(rng, IMAGE)
    model = mbuilder.build_model(
        types.SimpleNamespace(**FM32, num_samples=TRAIN_SAMPLES), IMAGE,
        images=X, generator=torch.Generator().manual_seed(seed), device=dev)
    lengthscale = float(model.layers[1].kernel.base_kernel.lengthscales.max())
    config = trainer.TrainConfig(optimizer='Adam', lr=0.01,
                                 batch_size=TRAIN_BATCH)
    state = trainer.init_state(model, config, seed=seed)
    Xd = torch.as_tensor(X.reshape(TRAIN_IMAGES, -1), device=dev)
    Yd = torch.as_tensor(Y, device=dev)
    fields, failure = adam_step_vs_cpu(torch, state, config, Xd, Yd,
                                       TRAIN_BATCH, rng,
                                       floor=FM32_DEFAULT_FLOOR)
    emit({'phase': 'fm32 default init step', **card, 'config': FM32,
          'last_layer_lengthscale': lengthscale, 'agrees': failure is None,
          **fields})
    check(failure is None, f'fm32 at the default init: {failure}')


def mnist_conv_serving(torch, model, step: int, dev, card: dict, rng,
                       reset_counts, read_counts) -> dict:
    """The trained MNIST ConvKernel snapshot served through
    ``Predictor.from_run_dir`` at batch BATCH, S=SAMPLES: a window of
    batch-sized requests with 1 K1 + 1 K3 + 1 K6 per predict_y, and the
    probabilities of 32 rows against the same snapshot on the CPU in
    float32 and float64 with the same noise.  Returns the launches."""
    from deepcgp_tpu_torch.serving import Predictor
    from deepcgp_tpu_torch.utils import checkpoint
    X = rng.randn(1024, *MNIST_IMAGE).astype(np.float32)
    with tempfile.TemporaryDirectory() as root:
        run = write_run(root, checkpoint.model_parameters(model, step),
                        MNIST_CONV, 'mnist_conv')
        pred = Predictor.from_run_dir(run, MNIST_IMAGE, batch_size=BATCH,
                                      num_samples=SAMPLES)
        cpu = {dtype: Predictor.from_run_dir(
            run, MNIST_IMAGE, dtype=dtype, device='cpu').model
            for dtype in (torch.float32, torch.float64)}
    chunks = len(X) // BATCH
    for r in range(5):
        pred.predict_proba(X[BATCH * (r % chunks):][:BATCH])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    calls0 = pred._calls
    latency = []
    t_window = time.perf_counter()
    while time.perf_counter() - t_window < 2.0:
        rows = X[BATCH * (len(latency) % chunks):][:BATCH]
        t = time.perf_counter()
        probs = pred.predict_proba(rows)
        latency.append(time.perf_counter() - t)
    window = time.perf_counter() - t_window
    calls = pred._calls - calls0
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    check(probs.shape == (BATCH, 10) and bool(np.isfinite(probs).all()),
          'MNIST ConvKernel serving: probabilities')
    expected = launches_of(**{k: n * calls
                              for k, n in MNIST_SERVING_PER_CALL.items()})
    check(launches == expected, f'MNIST ConvKernel serving: launches '
          f'{launches} for {calls} predict_y calls, expected {expected}')
    n = 32
    noise = [rng.randn(SAMPLES, n, 10)]
    xb = torch.as_tensor(X[:n].reshape(n, -1))
    p_card = pred.model.predict_y(xb.to(dev), SAMPLES, noise=noise)[0].cpu()
    p32 = cpu[torch.float32].predict_y(xb, SAMPLES, noise=noise)[0]
    p64 = cpu[torch.float64].predict_y(xb.double(), SAMPLES, noise=noise)[0]
    err = {'probs': float((p_card - p32).abs().max())}
    err64 = {'probs': float((p_card.double() - p64).abs().max())}
    cpu64 = {'probs': float((p32.double() - p64).abs().max())}
    ok = f32_agrees(err, err64, cpu64, 1e-4)['probs']
    lat_ms = np.sort(np.asarray(latency)) * 1e3
    emit({'phase': 'serving mnist_conv', **card, 'config': MNIST_CONV,
          'image': list(MNIST_IMAGE), 'global_step': step,
          'batch_size': BATCH, 'num_samples': SAMPLES,
          'predict_y_calls': calls, 'launches': launches,
          'window_seconds': window, 'requests_per_s': len(latency) / window,
          'images_per_s': BATCH * len(latency) / window,
          'latency_ms': {q: float(np.percentile(lat_ms, v)) for q, v in
                         (('p50', 50), ('p99', 99))},
          'max_memory_allocated_bytes': peak, 'compared_rows': n,
          'card_vs_cpu_max_abs_prob': err['probs'],
          'card_vs_cpu_f64_max_abs_prob': err64['probs'],
          'cpu_f32_vs_cpu_f64_max_abs_prob': cpu64['probs'],
          'prob_std': float(p64.std()),
          'tolerance': 'probabilities atol 1e-4 of the CPU float32, or of '
                       "the float64 plus twice the CPU float32's distance "
                       'from it'})
    check(ok, f'MNIST ConvKernel serving, card vs CPU: {err}, vs float64 '
          f'{err64}, CPU float32 vs float64 {cpu64}')
    return launches


def expected_launches(*terms) -> dict:
    """launches_of the sum of (count, {kernel: launches}) terms."""
    total = {}
    for count, per in terms:
        for k, n in per.items():
            total[k] = total.get(k, 0) + count * n
    return launches_of(**total)


def minus(a: dict, b: dict) -> dict:
    return {k: a[k] - b[k] for k in a}


@contextlib.contextmanager
def data_dir_set(path: str):
    """DEEPCGP_DATA_DIR set to ``path`` inside the block."""
    old = os.environ.get('DEEPCGP_DATA_DIR')
    os.environ['DEEPCGP_DATA_DIR'] = path
    try:
        yield
    finally:
        if old is None:
            os.environ.pop('DEEPCGP_DATA_DIR', None)
        else:
            os.environ['DEEPCGP_DATA_DIR'] = old


def log_rows(run_dir: str):
    """(log.csv's first line, its entry rows as dicts): the header repeats
    on every open of the log, and those lines are left out."""
    with open(os.path.join(run_dir, 'log.csv')) as f:
        lines = list(csv.reader(f))
    return lines[0], [dict(zip(lines[0], r)) for r in lines[1:]
                      if r[0] != 'Entry']


def drive_cli(torch, fn, read_counts):
    """Run fn() -- an entry point's main or an Experiment's lifecycle --
    with its printed lines captured, the launch counts read just after
    each model build (the Experiment's build_model) and the wall time.
    Returns (fn(), the printed lines, the counts after each build,
    seconds)."""
    from deepcgp_tpu_torch.training import experiment
    real_build, marks = experiment.build_model, []

    def build(*a, **k):
        model = real_build(*a, **k)
        marks.append(read_counts())
        return model
    out = io.StringIO()
    experiment.build_model = build
    try:
        with contextlib.redirect_stdout(out):
            t = time.perf_counter()
            result = fn()
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t
    finally:
        experiment.build_model = real_build
    return result, out.getvalue().splitlines(), marks, seconds


def state_values(state) -> dict:
    """Copies of every tensor of a TrainState, and its generator state."""
    out = {f'param/{k}': p.detach().clone() for k, p in state.params.items()}
    out.update({f'buffer/{k}': b.clone()
                for k, b in state.model.named_buffers()})
    if state.opt_state:
        out['count'] = state.opt_state['count'].clone()
        for moment in ('mu', 'nu'):
            out.update({f'{moment}/{k}': v.clone()
                        for k, v in state.opt_state[moment].items()})
    out['step'] = state.step.clone()
    if state.steps_back is not None:
        out['steps_back'] = state.steps_back.clone()
        out.update({f'prev/{k}': v.clone() for k, v in state.prev.items()})
    out['generator'] = state.generator.get_state()
    return out


def restore_values(torch, state, values: dict) -> None:
    """``state_values`` copied back into the state's own tensors (their
    storage, which the state's graphs read, kept) and its generator."""
    with torch.no_grad():
        for k, p in state.params.items():
            p.copy_(values[f'param/{k}'])
        for k, b in state.model.named_buffers():
            b.copy_(values[f'buffer/{k}'])
        if state.opt_state:
            state.opt_state['count'].copy_(values['count'])
            for moment in ('mu', 'nu'):
                for k, v in state.opt_state[moment].items():
                    v.copy_(values[f'{moment}/{k}'])
        state.step.copy_(values['step'])
        if state.steps_back is not None:
            state.steps_back.copy_(values['steps_back'])
            for k, v in state.prev.items():
                v.copy_(values[f'prev/{k}'])
    state.generator.set_state(values['generator'])


def bit_diff(torch, a: dict, b: dict) -> dict:
    """{name: max |a - b|} of the entries of two ``state_values`` (or
    traces) that are not bit-equal."""
    out = {}
    for k in a:
        if not torch.equal(a[k], b[k]):
            x, y = a[k].double(), b[k].double()
            out[k] = float((x - y).abs().max()) if x.is_floating_point() \
                else 'differs'
    return out


def cli_phases(torch, dev, card: dict, seed: int, reset_counts,
               read_counts) -> dict:
    """The entry points a user runs, in process, on the synthetic fallback
    (DEEPCGP_DATA_DIR an empty directory): the flagship CIFAR run with
    Adam, the same run stopped after 2 chunks and resumed from its
    full-state snapshot, the M=1024 MNIST run with NatGrad after an Adam
    warm start, and the flagship's argv on learnable blobs for held-out
    accuracy.  Each checks its log.csv, its ELBOs and its exact launches
    after the build (each chunk's steps, NatGrad's verifying ELBO, the
    eval batches).  Returns each path's launches, the build included."""
    rng = np.random.RandomState(seed + 4)
    with tempfile.TemporaryDirectory() as empty, \
            tempfile.TemporaryDirectory() as root, data_dir_set(empty):
        return cli_paths(torch, dev, card, rng, root, reset_counts,
                         read_counts)


def cli_paths(torch, dev, card: dict, rng, root: str, reset_counts,
              read_counts) -> dict:
    """The four CLI paths of ``cli_phases``, their files under ``root``."""
    exp, rows, adam = cli_cifar_adam(torch, dev, card, rng, root,
                                     reset_counts, read_counts)
    resume = cli_cifar_resume(torch, card, root, exp, rows, reset_counts,
                              read_counts)
    del exp
    return {'cli_cifar_adam': adam, 'cli_cifar_resume': resume,
            'cli_mnist_m1024_natgrad': cli_m1024_natgrad(
                torch, card, root, reset_counts, read_counts),
            'cli_blobs_accuracy': cli_blobs_accuracy(
                torch, card, root, reset_counts, read_counts),
            **cli_new_model_paths(torch, dev, card, rng, root, reset_counts,
                                  read_counts)}


def cli_new_model_paths(torch, dev, card: dict, rng, root: str, reset_counts,
                        read_counts) -> dict:
    """The depth-3 and ArcCosine CLI paths.  Returns each path's
    launches."""
    deep3, deep3_resume = cli_deep3_adam(torch, dev, card, rng, root,
                                         reset_counts, read_counts)
    return {'cli_deep3_adam': deep3, 'cli_deep3_resume': deep3_resume,
            'train_deep3_natgrad': cli_deep3_natgrad(
                torch, dev, card, rng, root, reset_counts, read_counts),
            'cli_acos_identity': cli_acos_identity(
                torch, dev, card, rng, root, reset_counts, read_counts)}


def cli_cifar_adam(torch, dev, card: dict, rng, root: str, reset_counts,
                   read_counts):
    """``cifar.main`` on the flagship: its log.csv, ELBOs and launches,
    then its run dir served on raw test images.  Returns (the experiment,
    its log rows, its launches)."""
    from deepcgp_tpu_torch import cifar
    from deepcgp_tpu_torch.serving import Predictor
    from deepcgp_tpu_torch.training import data
    from deepcgp_tpu_torch.training.arguments import train_steps
    argv = CLI_FLAGSHIP + ['--log-dir', os.path.join(root, 'adam')]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    exp, printed, marks, seconds = drive_cli(
        torch, lambda: cifar.main(argv), read_counts)
    total = read_counts()
    peak = torch.cuda.max_memory_allocated()
    run_dir = os.path.join(root, 'adam', 'flagship')
    header, rows = log_rows(run_dir)
    chunks = train_steps(exp.flags)
    steps = chunks * exp.flags.test_every
    evals = chunks * -(-exp.flags.test_size // EVAL_BATCH)
    elbos = [float(r['train_elbo']) for r in rows]
    check(header == ['Entry', 'global_step', 'lr', 'test_accuracy',
                     'train_elbo', 'steps_per_sec'],
          f'cli cifar: log.csv header {header}')
    check([int(r['global_step']) for r in rows] == [20, 40, 60, 80, 100]
          and chunks == 5, f'cli cifar: rows {rows}')
    check(all(np.isfinite(elbos)) and elbos[-1] > elbos[0],
          f'cli cifar: train_elbo {elbos}')
    after_build = minus(total, marks[0])
    want = expected_launches((steps, ADAM_PER_STEP['flagship']),
                             (evals, EVAL_PER_BATCH['flagship']))
    check(len(marks) == 1 and after_build == want,
          f'cli cifar: launches after the build {after_build}, '
          f'expected {want}')
    # The run served: Predictor.from_run_dir on raw test images (the
    # synthetic fallback's, selected as cifar_data selects them).
    pred = Predictor.from_run_dir(run_dir, IMAGE, batch_size=BATCH,
                                  num_samples=SAMPLES)
    x_tr, _, x_te, _ = data.load_dataset('cifar10')
    raw = np.concatenate([x_tr[exp.flags.N:], x_te]).transpose(0, 2, 3, 1)
    chosen = np.random.RandomState(exp.flags.seed).choice(
        len(raw), exp.flags.test_size, replace=False)
    prepared = pred._prepare(raw[chosen], raw=True)
    d_prep = float(np.abs(prepared - exp.X_test.reshape(len(chosen), -1))
                   .max())
    noise = [rng.randn(SAMPLES, BATCH, layer.num_outputs)
             for layer in exp.model.layers]
    xb = torch.as_tensor(prepared[:BATCH], device=dev)
    with torch.no_grad():
        p_served = pred.model.predict_y(xb, SAMPLES, noise=noise)[0]
        p_trained = exp.model.predict_y(xb, SAMPLES, noise=noise)[0]
    d_served = float((p_served - p_trained).abs().max())
    probs = pred.predict_proba(raw[chosen][:2 * BATCH], raw=True)
    emit({'phase': 'cli cifar flagship adam', **card, 'argv': argv,
          'entry': 'deepcgp_tpu_torch.cifar.main', 'chunks': chunks,
          'steps': steps, 'eval_batches': evals, 'seconds': seconds,
          'log_csv': rows, 'printed': printed,
          'steps_per_sec_column': [float(r['steps_per_sec']) for r in rows],
          'launches': total, 'launches_in_build': marks[0],
          'launches_after_build': after_build,
          'max_memory_allocated_bytes': peak,
          'raw_prepared_vs_test_set_max_abs': d_prep,
          'served_vs_trained_max_abs_prob': d_served,
          'served_raw_probs_finite': bool(np.isfinite(probs).all()),
          'tolerance': 'raw test images prepared by the served run within '
                       '1e-6 of the test set; served vs trained '
                       'probabilities on the same noise 1e-4'})
    check(d_prep <= 1e-6, f'cli cifar: prepared raw images {d_prep}')
    check(d_served <= 1e-4 and probs.shape == (2 * BATCH, 10)
          and bool(np.isfinite(probs).all()),
          f'cli cifar: served vs trained {d_served}')
    return exp, rows, total


def stop_and_resume(argv, chunks: int):
    """A ``Cifar`` of ``argv`` (with --full-state-ckpt) stopped after
    ``chunks`` chunks, and a new one that resumes from its snapshot and
    runs the rest.  Returns (the stopped state's tensors, the restored
    state's, the resumed experiment)."""
    from deepcgp_tpu_torch import cifar
    first = cifar.Cifar(cifar.read_args(argv))
    for _ in range(chunks):
        first.train_step()
    first.conclude()
    saved = state_values(first.state)
    del first
    resumed = cifar.Cifar(cifar.read_args(argv))
    restored = state_values(resumed.state)
    resumed.run()
    return saved, restored, resumed


def cli_cifar_resume(torch, card: dict, root: str, unbroken, unbroken_rows,
                     reset_counts, read_counts) -> dict:
    """The flagship's CLI run stopped after 2 chunks and resumed from its
    full-state snapshot by a new ``Cifar``, against the unbroken run.
    Returns the launches."""
    argv = CLI_FLAGSHIP + ['--log-dir', os.path.join(root, 'resume')]
    reset_counts()
    (saved, restored, resumed), printed, _, seconds = drive_cli(
        torch, lambda: stop_and_resume(argv, 2), read_counts)
    launches = read_counts()
    restore_equal = saved.keys() == restored.keys() and all(
        saved[k].dtype == restored[k].dtype
        and bool(torch.equal(saved[k], restored[k])) for k in saved)
    _, rows = log_rows(os.path.join(root, 'resume', 'flagship'))
    resumed_elbos = [float(r['train_elbo']) for r in rows[2:]]
    unbroken_elbos = [float(r['train_elbo']) for r in unbroken_rows[2:]]
    elbo_rel = [abs(a - b) / abs(b)
                for a, b in zip(resumed_elbos, unbroken_elbos)]
    final = state_values(resumed.state)
    whole = state_values(unbroken.state)
    cols = ('global_step', 'test_accuracy', 'train_elbo')
    emit({'phase': 'cli cifar flagship resume', **card, 'argv': argv,
          'seconds': seconds, 'printed': printed, 'log_csv': rows,
          'restored_state_bit_equal': restore_equal,
          'resumed_at_step': int(saved['step']),
          'final_global_step': resumed.global_step,
          'train_elbo_resumed': resumed_elbos,
          'train_elbo_unbroken': unbroken_elbos,
          'train_elbo_rel_diff': elbo_rel,
          'rows_bit_equal_to_unbroken': [
              [r[c] for c in cols] == [u[c] for c in cols]
              for r, u in zip(rows, unbroken_rows)],
          'final_state_bit_equal_to_unbroken': all(
              bool(torch.equal(final[k], whole[k])) for k in final),
          'launches': launches,
          'tolerance': 'restored state bit-equal to the saved one; the '
                       "resumed rows' train_elbo within 1e-3 relative of "
                       "the unbroken run's"})
    check(restore_equal and int(saved['step']) == 40,
          'cli cifar resume: the restored state differs from the saved')
    check(resumed.global_step == 100 and len(rows) == 5,
          f'cli cifar resume: ended at {resumed.global_step}, '
          f'{len(rows)} rows')
    check(len(elbo_rel) == 3 and max(elbo_rel) <= 1e-3,
          f'cli cifar resume: train_elbo {resumed_elbos} against '
          f'{unbroken_elbos}')
    return launches


def cli_m1024_natgrad(torch, card: dict, root: str, reset_counts,
                      read_counts) -> dict:
    """``mnist.main`` on the M=1024 configuration with NatGrad after an
    Adam warm start.  Returns the launches."""
    from deepcgp_tpu_torch import mnist
    from deepcgp_tpu_torch.training.arguments import train_steps
    argv = CLI_M1024 + ['--log-dir', os.path.join(root, 'm1024')]
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    exp, printed, marks, seconds = drive_cli(
        torch, lambda: mnist.main(argv), read_counts)
    total = read_counts()
    peak = torch.cuda.max_memory_allocated()
    _, rows = log_rows(os.path.join(root, 'm1024', 'm1024'))
    chunks = train_steps(exp.flags)
    steps = chunks * exp.flags.test_every
    evals = chunks * -(-exp.flags.test_size // EVAL_BATCH)
    warm = exp.flags.natgrad_warm_steps
    elbos = [float(r['train_elbo']) for r in rows]
    after_build = minus(total, marks[0])
    want = expected_launches((warm, ADAM_PER_STEP['m1024']),
                             (steps, NATGRAD_PER_STEP['m1024']),
                             (chunks, NATGRAD_PER_CHUNK['m1024']),
                             (evals, EVAL_PER_BATCH['m1024']))
    emit({'phase': 'cli mnist m1024 natgrad', **card, 'argv': argv,
          'entry': 'deepcgp_tpu_torch.mnist.main', 'warm_steps': warm,
          'chunks': chunks, 'steps': steps, 'eval_batches': evals,
          'seconds': seconds, 'log_csv': rows, 'printed': printed,
          'steps_back': float(exp.state.steps_back),
          'steps_per_sec_column': [float(r['steps_per_sec']) for r in rows],
          'launches': total, 'launches_in_build': marks[0],
          'launches_after_build': after_build,
          'max_memory_allocated_bytes': peak})
    check(f'natgrad warm start: {warm} Adam steps' in printed,
          f'cli mnist: no warm-start line in {printed}')
    check(len(rows) == 5 and chunks == 5 and all(np.isfinite(elbos)),
          f'cli mnist: rows {rows}')
    check(len(marks) == 1 and after_build == want,
          f'cli mnist: launches after the build {after_build}, '
          f'expected {want}')
    return total


def blobs_cifar(argv):
    """A ``Cifar`` of ``argv`` whose data are learnable blobs: rows
    0 .. BLOB_TRAIN - 1 train, the rest held out."""
    from deepcgp_tpu_torch import cifar
    from deepcgp_tpu_torch.training import data

    class Blobs(cifar.Cifar):
        def _load_data(self):
            X, y = data.learnable_blobs(BLOB_IMAGES, IMAGE, 10, 0)
            self.X_train, self.Y_train = X[:BLOB_TRAIN], y[:BLOB_TRAIN]
            self.X_test, self.Y_test = X[BLOB_TRAIN:], y[BLOB_TRAIN:]

    return Blobs(cifar.read_args(argv))


def window_and_profile(torch, label: str, exp, card: dict, reset_counts,
                       read_counts) -> None:
    """After a CLI run, its state's bare speed: WINDOW_CHUNKS run_chunk
    calls of WINDOW_CHUNK steps (steps/s, peak memory over them), then
    WINDOW_PROFILE_STEPS steps under the profiler (device busy ms)."""
    from deepcgp_tpu_torch.training import trainer
    state, config = exp.state, exp.config
    Xd, Yd = exp.X_train_dev, exp.Y_train_dev
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    trace = torch.cat([trainer.run_chunk(state, config, Xd, Yd, WINDOW_CHUNK)
                       for _ in range(WINDOW_CHUNKS)])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated()
    wall_ms, busy_ms, top, rounds = profile_device(
        torch, lambda: trainer.run_chunk(state, config, Xd, Yd,
                                         WINDOW_PROFILE_STEPS),
        reset_counts, read_counts)
    steps = WINDOW_CHUNKS * WINDOW_CHUNK
    emit({'phase': f'{label} window', **card, 'optimizer': config.optimizer,
          'batch_size': config.batch_size,
          'num_samples': exp.model.num_samples, 'steps': steps,
          'seconds': seconds, 'steps_per_s': steps / seconds,
          'elbo_first': float(trace[0]), 'elbo_last': float(trace[-1]),
          'max_memory_allocated_bytes': peak,
          'profile_steps': WINDOW_PROFILE_STEPS, 'wall_ms': wall_ms,
          'device_busy_ms': busy_ms, 'device_busy_share': busy_ms / wall_ms,
          'profile_rounds': rounds, 'top_device_ms': top})
    check(finite(torch, trace), f'{label} window: an ELBO is not finite')


def resolvable_copy(torch, model):
    """A copy of a trained depth-3 model whose last layer's lengthscale is
    LENGTHSCALES[1], as the flagship snapshot's and fm32's.  At the
    builder's 5, the last layer's 90-element patches of the hidden layers'
    samples sit so far apart that the gradients through its
    cross-covariances (its Z, patch weights and lengthscale, and every
    hidden layer's Z) are below float32's resolution in float64, and a
    check there holds rounding noise to rounding noise."""
    from deepcgp_tpu_torch.utils.transforms import positive_backward
    copied = copy.deepcopy(model)
    base = copied.layers[-1].kernel.base_kernel
    with torch.no_grad():
        base.raw_lengthscales.fill_(float(positive_backward(LENGTHSCALES[1])))
    return copied


def natgrad_solve_batches(model) -> list:
    """[B, M, M] of each NatGrad solve of a step: the layers' GPs stacked
    by (M, R), as ``optim.natgrad_step_with_backoff`` stacks them."""
    groups: dict = {}
    for layer in model.layers:
        M, R = layer.q_mu.shape
        groups[(M, R)] = groups.get((M, R), 0) + R
    return [[b, M, M] for (M, _), b in groups.items()]


def cli_deep3_adam(torch, dev, card: dict, rng, root: str, reset_counts,
                   read_counts):
    """``cifar.main`` on the depth-3 identity-mean configuration with Adam:
    its log.csv, ELBOs and exact launches after the build, the run served
    from its run dir; the same run stopped after a chunk and resumed, bit
    for bit the unbroken one; one step on the card against the CPU; then
    its window.  Returns (the run's launches, the resumed run's)."""
    from deepcgp_tpu_torch import cifar
    from deepcgp_tpu_torch.serving import Predictor
    from deepcgp_tpu_torch.training import trainer
    from deepcgp_tpu_torch.training.arguments import train_steps
    argv = CLI_DEEP3 + ['--log-dir', os.path.join(root, 'deep3')]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    exp, printed, marks, seconds = drive_cli(
        torch, lambda: cifar.main(argv), read_counts)
    total = read_counts()
    peak = torch.cuda.max_memory_allocated()
    run_dir = os.path.join(root, 'deep3', 'deep3')
    _, rows = log_rows(run_dir)
    chunks = train_steps(exp.flags)
    steps = chunks * exp.flags.test_every
    evals = chunks * -(-exp.flags.test_size // EVAL_BATCH)
    elbos = [float(r['train_elbo']) for r in rows]
    after_build = minus(total, marks[0])
    want = expected_launches((steps, ADAM_PER_STEP['deep3']),
                             (evals, EVAL_PER_BATCH['deep3']))
    layers = exp.model.layers
    geometry = {'hidden_patches': [l.view.patch_count for l in layers[:-1]],
                'last_layer_P_L': [layers[-1].kernel.view.patch_count,
                                   layers[-1].kernel.view.patch_length],
                'kuu_batch': [5, 384, 384]}
    pred = Predictor.from_run_dir(run_dir, IMAGE, batch_size=BATCH,
                                  num_samples=SAMPLES)
    xb = exp.X_test_dev[:EVAL_BATCH]
    noise = [rng.randn(SAMPLES, EVAL_BATCH, layer.num_outputs)
             for layer in layers]
    with torch.no_grad():
        p_served = pred.model.predict_y(xb, SAMPLES, noise=noise)[0]
        p_trained = exp.model.predict_y(xb, SAMPLES, noise=noise)[0]
    d_served = float((p_served - p_trained).abs().max())
    del pred
    emit({'phase': 'cli cifar deep3 identity adam', **card, 'argv': argv,
          'entry': 'deepcgp_tpu_torch.cifar.main', 'geometry': geometry,
          'chunks': chunks, 'steps': steps, 'eval_batches': evals,
          'seconds': seconds, 'log_csv': rows, 'printed': printed,
          'steps_per_sec_column': [float(r['steps_per_sec']) for r in rows],
          'launches': total, 'launches_in_build': marks[0],
          'launches_after_build': after_build,
          'max_memory_allocated_bytes': peak,
          'served_vs_trained_max_abs_prob': d_served,
          'tolerance': 'served vs trained probabilities on the same noise '
                       '1e-4'})
    check(geometry['hidden_patches'] == [196, 144]
          and geometry['last_layer_P_L'] == [100, 90],
          f'cli deep3: geometry {geometry}')
    check(len(rows) == chunks == 3 and all(np.isfinite(elbos)),
          f'cli deep3: rows {rows}')
    check(len(marks) == 1 and after_build == want,
          f'cli deep3: launches after the build {after_build}, '
          f'expected {want}')
    check(d_served <= 1e-4, f'cli deep3: served vs trained {d_served}')

    rargv = CLI_DEEP3 + ['--log-dir', os.path.join(root, 'deep3_resume')]
    reset_counts()
    (saved, restored, resumed), rprinted, _, rseconds = drive_cli(
        torch, lambda: stop_and_resume(rargv, 1), read_counts)
    resume_launches = read_counts()
    restore_equal = saved.keys() == restored.keys() and all(
        saved[k].dtype == restored[k].dtype
        and bool(torch.equal(saved[k], restored[k])) for k in saved)
    _, rrows = log_rows(os.path.join(root, 'deep3_resume', 'deep3'))
    cols = ('global_step', 'test_accuracy', 'train_elbo')
    rows_equal = [[r[c] for c in cols] == [u[c] for c in cols]
                  for r, u in zip(rrows, rows)]
    final = state_values(resumed.state)
    whole = state_values(exp.state)
    final_equal = final.keys() == whole.keys() and all(
        bool(torch.equal(final[k], whole[k])) for k in final)
    emit({'phase': 'cli cifar deep3 identity resume', **card, 'argv': rargv,
          'seconds': rseconds, 'printed': rprinted, 'log_csv': rrows,
          'restored_state_bit_equal': restore_equal,
          'resumed_at_step': int(saved['step']),
          'final_global_step': resumed.global_step,
          'rows_bit_equal_to_unbroken': rows_equal,
          'final_state_bit_equal_to_unbroken': final_equal,
          'launches': resume_launches,
          'tolerance': 'restored state, resumed rows and final state bit '
                       'for bit the unbroken run\'s'})
    check(restore_equal and int(saved['step']) == exp.flags.test_every,
          'cli deep3 resume: the restored state differs from the saved')
    check(len(rrows) == len(rows) and all(rows_equal) and final_equal,
          f'cli deep3 resume: rows equal {rows_equal}, final state equal '
          f'{final_equal}')
    del resumed

    fields, failure = adam_step_vs_cpu(torch, exp.state, exp.config,
                                       exp.X_train_dev, exp.Y_train_dev,
                                       DEEP3_CHECK_BATCH, rng)
    wide = trainer.init_state(resolvable_copy(torch, exp.model), exp.config)
    wide_fields, wide_failure = adam_step_vs_cpu(
        torch, wide, exp.config, exp.X_train_dev, exp.Y_train_dev,
        DEEP3_CHECK_BATCH, rng)
    del wide
    emit({'phase': 'cli cifar deep3 identity adam step vs cpu', **card,
          'batch_size': DEEP3_CHECK_BATCH, 'cli_state': fields,
          'last_lengthscale_25': wide_fields})
    check(failure is None and wide_failure is None,
          f'deep3: {failure}; at lengthscale 25: {wide_failure}')
    window_and_profile(torch, 'cli cifar deep3 identity adam', exp, card,
                       reset_counts, read_counts)
    return total, resume_launches


def cli_deep3_natgrad(torch, dev, card: dict, rng, root: str, reset_counts,
                      read_counts) -> dict:
    """``cifar.main`` on the depth-3 configuration with NatGrad after an
    Adam warm start: exact launches (K2 on the three layers' [30, 384,
    384] solve), ``steps_back``, one NatGrad step on the card against the
    CPU, then its window.  Returns the launches."""
    from deepcgp_tpu_torch import cifar
    from deepcgp_tpu_torch.training import optim
    from deepcgp_tpu_torch.training.arguments import train_steps
    argv = CLI_DEEP3_NATGRAD + ['--log-dir', os.path.join(root, 'deep3ng')]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    exp, printed, marks, seconds = drive_cli(
        torch, lambda: cifar.main(argv), read_counts)
    total = read_counts()
    peak = torch.cuda.max_memory_allocated()
    _, rows = log_rows(os.path.join(root, 'deep3ng', 'deep3ng'))
    chunks = train_steps(exp.flags)
    steps = chunks * exp.flags.test_every
    evals = chunks * -(-exp.flags.test_size // EVAL_BATCH)
    warm = exp.flags.natgrad_warm_steps
    elbos = [float(r['train_elbo']) for r in rows]
    after_build = minus(total, marks[0])
    want = expected_launches((warm, ADAM_PER_STEP['deep3']),
                             (steps, NATGRAD_PER_STEP['deep3']),
                             (chunks, NATGRAD_PER_CHUNK['deep3']),
                             (evals, EVAL_PER_BATCH['deep3']))
    solves = natgrad_solve_batches(exp.model)
    emit({'phase': 'train deep3 natgrad', **card, 'argv': argv,
          'entry': 'deepcgp_tpu_torch.cifar.main', 'warm_steps': warm,
          'chunks': chunks, 'steps': steps, 'eval_batches': evals,
          'natgrad_solve_batches': solves,
          'natgrad_route': optim.natgrad_route(torch.float32, 384),
          'seconds': seconds, 'log_csv': rows, 'printed': printed,
          'steps_back': float(exp.state.steps_back),
          'steps_per_sec_column': [float(r['steps_per_sec']) for r in rows],
          'launches': total, 'launches_after_build': after_build,
          'max_memory_allocated_bytes': peak})
    check(f'natgrad warm start: {warm} Adam steps' in printed,
          f'train deep3 natgrad: no warm-start line in {printed}')
    check(solves == [[30, 384, 384]]
          and optim.natgrad_route(torch.float32, 384) == 'upper',
          f'train deep3 natgrad: solves {solves}')
    check(len(rows) == chunks == 3 and all(np.isfinite(elbos)),
          f'train deep3 natgrad: rows {rows}')
    check(len(marks) == 1 and after_build == want,
          f'train deep3 natgrad: launches after the build {after_build}, '
          f'expected {want}')
    checks = {name: natgrad_step_vs_cpu(
        torch, model, exp.config, exp.X_train_dev, exp.Y_train_dev,
        DEEP3_CHECK_BATCH, exp.flags.seed, rng)
        for name, model in (('cli_state', exp.model),
                            ('last_lengthscale_25',
                             resolvable_copy(torch, exp.model)))}
    emit({'phase': 'train deep3 natgrad step vs cpu', **card,
          'batch_size': DEEP3_CHECK_BATCH,
          **{name: fields for name, (fields, _) in checks.items()}})
    check(all(failure is None for _, failure in checks.values()),
          f'deep3 NatGrad: {[failure for _, failure in checks.values()]}')
    window_and_profile(torch, 'train deep3 natgrad', exp, card, reset_counts,
                       read_counts)
    return total


def cli_acos_identity(torch, dev, card: dict, rng, root: str, reset_counts,
                      read_counts) -> dict:
    """The flagship's geometry with an ArcCosine hidden layer and the
    identity mean, on learnable blobs through a ``Cifar``: Adam warm
    steps, then NatGrad; exact launches, the held-out accuracy (read, not
    held), ``train_elbo`` rising; one step on the card against the CPU
    (Adam's loss and gradients, NatGrad's step), then its window.  Returns
    the launches."""
    argv = CLI_ACOS + ['--log-dir', os.path.join(root, 'acos')]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()

    def run():
        experiment = blobs_cifar(argv)
        for _ in range(ACOS_CHUNKS):
            experiment.train_step()
        experiment.conclude()
        return experiment
    exp, printed, marks, seconds = drive_cli(torch, run, read_counts)
    total = read_counts()
    peak = torch.cuda.max_memory_allocated()
    _, rows = log_rows(os.path.join(root, 'acos', 'acos'))
    accuracy = [float(r['test_accuracy']) for r in rows]
    elbos = [float(r['train_elbo']) for r in rows]
    warm = exp.flags.natgrad_warm_steps
    steps = ACOS_CHUNKS * exp.flags.test_every
    evals = ACOS_CHUNKS * -(-(BLOB_IMAGES - BLOB_TRAIN) // EVAL_BATCH)
    after_build = minus(total, marks[0])
    want = expected_launches((warm, ADAM_PER_STEP['flagship']),
                             (steps, NATGRAD_PER_STEP['flagship']),
                             (ACOS_CHUNKS, NATGRAD_PER_CHUNK['flagship']),
                             (evals, EVAL_PER_BATCH['flagship']))
    solves = natgrad_solve_batches(exp.model)
    emit({'phase': 'cli cifar acos identity', **card, 'argv': argv,
          'data': f'learnable_blobs({BLOB_IMAGES}, {IMAGE}, 10, 0): rows '
                  f'0-{BLOB_TRAIN - 1} train, the rest held out',
          'base_kernel': type(exp.model.layers[0].base_kernel).__name__,
          'mean_function': type(exp.model.layers[0].mean_function).__name__,
          'warm_steps': warm, 'steps': steps, 'seconds': seconds,
          'natgrad_solve_batches': solves,
          'test_accuracy': accuracy, 'train_elbo': elbos,
          'steps_back': float(exp.state.steps_back),
          'steps_per_sec_column': [float(r['steps_per_sec']) for r in rows],
          'launches': total, 'launches_after_build': after_build,
          'max_memory_allocated_bytes': peak,
          'gate': "train_elbo's last entry above its first; the held-out "
                  'accuracy is read, not held'})
    check(exp.model.layers[0].base_kernel.__class__.__name__ == 'ArcCosine'
          and solves == [[20, 384, 384]], f'cli acos: model {solves}')
    check(len(rows) == ACOS_CHUNKS and all(np.isfinite(elbos))
          and elbos[-1] > elbos[0], f'cli acos: train_elbo {elbos}')
    check(len(marks) == 1 and after_build == want,
          f'cli acos: launches after the build {after_build}, '
          f'expected {want}')
    adam_fields, adam_failure = adam_step_vs_cpu(
        torch, exp.state, exp.config, exp.X_train_dev, exp.Y_train_dev,
        TRAIN_BATCH, rng)
    ng_fields, ng_failure = natgrad_step_vs_cpu(
        torch, exp.model, exp.config, exp.X_train_dev, exp.Y_train_dev,
        TRAIN_BATCH, exp.flags.seed, rng)
    emit({'phase': 'cli cifar acos identity step vs cpu', **card,
          'batch_size': TRAIN_BATCH, 'adam': adam_fields,
          'natgrad': ng_fields})
    check(adam_failure is None and ng_failure is None,
          f'acos: Adam {adam_failure}; NatGrad {ng_failure}')
    window_and_profile(torch, 'cli cifar acos identity', exp, card,
                       reset_counts, read_counts)
    return total


def hidden_extraction_phase(torch, dev, card: dict, rng) -> None:
    """The depth-3 second hidden layer's patch extraction, forward and
    backward, by the two routes that do not sum with atomics: the one the
    layer runs (``cuda_patches.tf_order_patches``: a strided copy, then K7
    on the cotangent gathered into transposed order) and K6 + a transpose
    to row-major patch order (K7 after the transpose's copy in the
    backward); autograd's own backward of the strided view (``index_add_``)
    beside them.  Each backward twice, for bits; times by CUDA events
    around host-paced calls (a call's host time where it launches more
    than the device runs) and the device's own (``queued_ms``); the
    launches here are not a path's."""
    from deepcgp_tpu_torch.ops import cuda_patches, patches
    N, H, W, C, f = TRAIN_BATCH * TRAIN_SAMPLES, 14, 14, 10, 3
    Ho = Wo = H - f + 1
    X = torch.as_tensor(rng.randn(N, H, W, C), dtype=torch.float32,
                        device=dev).requires_grad_(True)
    G = torch.as_tensor(rng.randn(N, Ho * Wo, f * f * C), dtype=torch.float32,
                        device=dev)

    def via_kernels(X):
        tp = cuda_patches.transposed_patches(X, f)
        return tp.reshape(N, Wo, Ho, -1).transpose(1, 2).reshape(N, Ho * Wo, -1)
    routes = {'strided_k7': lambda X: cuda_patches.tf_order_patches(X, f),
              'k6_k7_transpose': via_kernels,
              'autograd_index_add': lambda X: patches.extract_patches(X, f)}
    out, grads, fwd_ms, fwd_bwd_ms, device_ms = {}, {}, {}, {}, {}
    for name, fn in routes.items():
        out[name] = fn(X).detach()
        grads[name] = [torch.autograd.grad(fn(X), X, G)[0] for _ in range(2)]
        with torch.no_grad():
            fwd_ms[name] = cuda_ms(torch, lambda: fn(X), 20)
        fwd_bwd_ms[name] = cuda_ms(
            torch, lambda: torch.autograd.grad(fn(X), X, G), 20)
        device_ms[name] = queued_ms(
            torch, lambda: torch.autograd.grad(fn(X), X, G), 20)
    ref = grads['strided_k7'][0]
    emit({'phase': 'hidden extraction backward', **card,
          'image': [N, H, W, C], 'filter': f, 'stride': 1,
          'forward_ms': fwd_ms, 'forward_backward_ms': fwd_bwd_ms,
          'forward_backward_device_ms': device_ms,
          'forward_bit_equal_to_layer': {
              k: bool(torch.equal(v, out['strided_k7'])) for k, v in out.items()},
          'backward_bit_equal_run_to_run': {
              k: bool(torch.equal(*v)) for k, v in grads.items()},
          'backward_rel_err_vs_layer': {k: rel(v[0], ref)
                                        for k, v in grads.items()},
          'chosen': 'strided_k7',
          'tolerance': 'forwards bit-equal; the two routes without atomics '
                       'bit-equal run to run, each backward within 1e-6 of '
                       "the layer's"})
    check(all(torch.equal(v, out['strided_k7']) for v in out.values()),
          'hidden extraction: the forwards differ')
    check(all(torch.equal(*grads[k]) for k in ('strided_k7',
                                                'k6_k7_transpose')),
          'hidden extraction: a backward without atomics changed run to run')
    check(all(rel(v[0], ref) <= 1e-6 for v in grads.values()),
          'hidden extraction: the backwards disagree')


def cli_blobs_accuracy(torch, card: dict, root: str, reset_counts,
                       read_counts) -> dict:
    """The flagship's CLI argv on learnable blobs, through a ``Cifar``
    whose data are the blobs, driven by ``train_step``: held-out accuracy.
    Returns the launches."""
    argv = CLI_BLOBS + ['--log-dir', os.path.join(root, 'blobs')]
    reset_counts()

    def blobs():
        experiment = blobs_cifar(argv)
        for _ in range(BLOB_CHUNKS):
            experiment.train_step()
        experiment.conclude()
        return experiment
    exp, _, marks, seconds = drive_cli(torch, blobs, read_counts)
    total = read_counts()
    _, rows = log_rows(os.path.join(root, 'blobs', 'blobs'))
    accuracy = [float(r['test_accuracy']) for r in rows]
    elbos = [float(r['train_elbo']) for r in rows]
    steps = BLOB_CHUNKS * exp.flags.test_every
    evals = BLOB_CHUNKS * -(-(BLOB_IMAGES - BLOB_TRAIN) // EVAL_BATCH)
    after_build = minus(total, marks[0])
    want = expected_launches((steps, ADAM_PER_STEP['flagship']),
                             (evals, EVAL_PER_BATCH['flagship']))
    emit({'phase': 'cli blobs flagship accuracy', **card, 'argv': argv,
          'data': f'learnable_blobs({BLOB_IMAGES}, {IMAGE}, 10, 0): rows '
                  f'0-{BLOB_TRAIN - 1} train, the rest held out',
          'steps': steps, 'seconds': seconds, 'test_accuracy': accuracy,
          'train_elbo': elbos,
          'steps_per_sec_column': [float(r['steps_per_sec']) for r in rows],
          'launches': total, 'launches_after_build': after_build,
          'min_final_accuracy': BLOB_MIN_ACCURACY})
    check(len(rows) == BLOB_CHUNKS and all(np.isfinite(elbos)),
          f'cli blobs: train_elbo {elbos}')
    check(len(marks) == 1 and after_build == want,
          f'cli blobs: launches after the build {after_build}, '
          f'expected {want}')
    check(accuracy[-1] >= BLOB_MIN_ACCURACY,
          f'cli blobs: held-out accuracy {accuracy}')
    return total


# -- the rest of the JAX package's single-device surface --------------------
# The flagship CLI with its TensorBoard log on: 2 chunks of 20 Adam steps
# (lr decay 17 steps: train_steps gives 2), an eval of 256 test images and a
# TensorBoard entry after each.  Each entry evaluates the minibatch ELBO on
# the first min(5000, N) training rows in batches of 64 and layer 0's
# output on one test image.
TB_ARGV = [a for a in CLI_FLAGSHIP
           if a not in ('--no-tensorboard', '--full-state-ckpt')] + [
    '--name', 'tb', '--lr-decay-steps', '17', '--test-size', '256']
TB_ELBO_BATCH, TB_ELBO_ROWS = 64, 5000
# The JAX logger's tags for the flagship's leaves, cleaned as tensorboardX
# stores them ('model.layers[0].Z' -> 'model.layers_0_.Z').
FLAGSHIP_TB_TAGS = frozenset(
    [f'model.layers_0_.{n}' for n in ('base_kernel.raw_variance',
                                      'base_kernel.raw_lengthscales', 'Z',
                                      'q_mu', 'q_sqrt', 'Z0')]
    + [f'model.layers_1_.{n}' for n in (
        'kernel.base_kernel.raw_variance', 'kernel.base_kernel.raw_lengthscales',
        'kernel.patch_weights', 'Z', 'q_mu', 'q_sqrt')])
TB_IMAGE_TAGS = ('conv_sample', 'conv_mean', 'conv_var')
# Full-covariance sampling: the flagship's layer 0 and last layer at
# N = 16, the MNIST ConvKernel's (M = 1024, P = 576) at N = 128, whose
# whole evaluation stays under 1 GiB (ConvKernel.K in blocks).
FULL_COV_N, FULL_COV_MNIST_N, FULL_COV_BOUND_BYTES = 16, 128, 1 << 30
FULL_COV_TOL = {'mean': 1e-4, 'cov': 1e-4, 'sample': 1e-3}
# The partial-view model: 28x28x1, a RandomPartialView hidden layer (filter
# 5, 144 positions read as a 12x12 image, seed 0) with the patchwise mean,
# M = 384, one GP; an SVGP ConvKernel last layer over 12x12x1 (filter 5:
# P = 64, L = 25), M = 384, 10 outputs.  The flagship's widths on the
# geometry of tests/test_trajectory_parity.py's partial-view model.
PV_IMAGE, PV_PATCHES, PV_M, PV_IMAGES = (28, 28, 1), 144, 384, 2048
PV_PER_STEP = ADAM_PER_STEP['flagship']
# Regression: the port's examples/regression.py (its width, M = 32), 5
# chunks of REGRESSION_CHUNK Adam steps (the example's default is 400: its
# host-bound steps were the script's longest phase); the JAX example's
# train RMSE on the CPU (jax 0.9.0, 2000 steps) for reference.
REGRESSION_MAX_RMSE, JAX_REGRESSION_RMSE = 0.10, 0.0527
REGRESSION_CHUNK = 240
# Diagnostics and the trace: one chunk of flagship steps under the
# profiler (host and card activity: ~0.9 s a step), the noise sweep's
# default levels on the test set.
TRACE_STEPS, ROBUSTNESS_LEVELS = 2, 4
# The upper base case at blocks that are not multiples of 32.
UPPER_ANY_P = ((4, 48), (2, 100))


def surface_phases(torch, dev, card: dict, seed: int, reset_counts,
                   read_counts) -> dict:
    """The modules of the JAX package's single-device surface beyond the
    training CLI: the TensorBoard log of the flagship CLI, full-covariance
    sampling, a partial-view model trained with Adam, the regression
    example, the diagnostics, a trace, and the upper base case at any
    block.  Returns each path's launches."""
    rng = np.random.RandomState(seed + 6)
    paths = {}
    with tempfile.TemporaryDirectory() as empty, \
            tempfile.TemporaryDirectory() as root:
        with data_dir_set(empty):
            exp, paths['tensorboard_cli'] = tensorboard_cli(
                torch, card, root, reset_counts, read_counts)
        paths['full_cov'] = full_cov_phase(torch, dev, card, exp.model, rng,
                                           reset_counts, read_counts)
        paths['diagnostics_trace'] = diagnostics_phase(
            torch, card, exp, seed, root, reset_counts, read_counts)
    del exp
    paths['partial_view_adam'] = partial_view_adam(
        torch, dev, card, rng, seed, reset_counts, read_counts)
    paths['regression'] = regression_phase(torch, card, reset_counts,
                                           read_counts)
    paths['upper_any_p'] = upper_any_p_phase(torch, dev, card, rng,
                                             reset_counts, read_counts)
    return paths


def tensorboard_cli(torch, card: dict, root: str, reset_counts, read_counts):
    """``cifar.main`` on the flagship's argv with the TensorBoard log on,
    its events read back by the port's reader.  Returns (the experiment,
    its launches)."""
    from deepcgp_tpu_torch import cifar
    from deepcgp_tpu_torch.training.arguments import train_steps
    from deepcgp_tpu_torch.training.optim import jax_keystr, jax_leaf_order
    from deepcgp_tpu_torch.utils import events, tensorboard
    tb_dir = os.path.join(root, 'tensorboard')
    argv = TB_ARGV + ['--log-dir', os.path.join(root, 'tb'),
                      '--tensorboard-dir', tb_dir]
    entries = []            # (seconds, launches) of each TensorBoard entry
    real_entry = tensorboard.TensorBoardLog.write_entry

    def timed_entry(self, experiment):
        torch.cuda.synchronize()
        before, t = read_counts(), time.perf_counter()
        real_entry(self, experiment)
        torch.cuda.synchronize()
        entries.append((time.perf_counter() - t, minus(read_counts(), before)))

    tensorboard.TensorBoardLog.write_entry = timed_entry
    reset_counts()
    try:
        exp, printed, marks, seconds = drive_cli(
            torch, lambda: cifar.main(argv), read_counts)
    finally:
        tensorboard.TensorBoardLog.write_entry = real_entry
    total = read_counts()
    flags = exp.flags
    chunks = train_steps(flags)
    steps = chunks * flags.test_every
    evals = chunks * -(-flags.test_size // EVAL_BATCH)
    elbos = -(-min(TB_ELBO_ROWS, flags.N) // TB_ELBO_BATCH)
    per_entry = expected_launches((elbos, EVAL_PER_BATCH['flagship']),
                                  (1, {'chol_inv_base': 1, 'tri_inv_base': 1}))
    want = expected_launches((steps, ADAM_PER_STEP['flagship']),
                             (evals, EVAL_PER_BATCH['flagship']),
                             (chunks, per_entry))
    after_build = minus(total, marks[0])
    check(chunks == 2 and len(entries) == chunks,
          f'tensorboard cli: {chunks} chunks, {len(entries)} entries')
    check(all(e[1] == per_entry for e in entries),
          f'tensorboard cli: entry launches {[e[1] for e in entries]}, '
          f'expected {per_entry} each')
    check(len(marks) == 1 and after_build == want,
          f'tensorboard cli: launches after the build {after_build}, '
          f'expected {want}')
    # The events file, read back: every CRC (read_events raises on one that
    # does not match), the JAX logger's tags at every entry's step.
    run_tb = os.path.join(tb_dir, flags.name)
    (name,) = [n for n in os.listdir(run_tb)
               if n.startswith('events.out.tfevents.')]
    evs = events.read_events(os.path.join(run_tb, name))
    check(evs[0].get('file_version') == events.FILE_VERSION,
          f'tensorboard cli: first record {evs[0]}')
    sizes = {events.clean_tag('model' + jax_keystr(n)): t.numel()
             for n, t in jax_leaf_order(exp.model)}
    check(set(sizes) == FLAGSHIP_TB_TAGS,
          f'tensorboard cli: parameter tags {sorted(sizes)}')
    layer0 = exp.model.layers[0]
    h, w = layer0.view.out_image_height, layer0.view.out_image_width
    fm = layer0.gp_count
    image_shapes = {'conv_sample': (4 * h, fm * w, 3),
                    'conv_mean': (h, fm * w, 3), 'conv_var': (h, fm * w, 3)}
    by_step = {}
    for ev in evs[1:]:
        for v in ev['summary']:
            by_step.setdefault(ev['step'], []).append(v)
    check(sorted(by_step) == [flags.test_every * (i + 1) for i in range(chunks)],
          f'tensorboard cli: entry steps {sorted(by_step)}')
    lls = []
    for step, values in sorted(by_step.items()):
        tags = [v['tag'] for v in values]
        check(sorted(tags) == sorted(set(tags)) and set(tags) == set(sizes)
              | {'train_log_likelihood', *TB_IMAGE_TAGS},
              f'tensorboard cli: tags at step {step}: {sorted(tags)}')
        at = {v['tag']: v for v in values}
        lls.append(at['train_log_likelihood']['simple_value'])
        for tag, size in sizes.items():
            check(('simple_value' in at[tag]) if size == 1
                  else at[tag]['histo']['num'] == size,
                  f'tensorboard cli: {tag} at step {step}: {at[tag]}')
        for tag, shape in image_shapes.items():
            img = at[tag]['image']
            px = events.decode_png(img['png'])
            check(px.shape == shape and (img['height'], img['width'])
                  == shape[:2], f'tensorboard cli: {tag} is {px.shape}, '
                  f'expected {shape}')
    check(all(np.isfinite(lls)), f'tensorboard cli: train_log_likelihood {lls}')
    emit({'phase': 'tensorboard cli', **card, 'argv': argv,
          'entry': 'deepcgp_tpu_torch.cifar.main', 'chunks': chunks,
          'steps': steps, 'eval_batches': evals, 'seconds': seconds,
          'events_file_bytes': os.path.getsize(os.path.join(run_tb, name)),
          'records': len(evs), 'entry_seconds': [e[0] for e in entries],
          'entry_launches': per_entry, 'elbos_per_entry': elbos,
          'train_log_likelihood': lls, 'parameter_tags': sorted(sizes),
          'image_shapes': image_shapes, 'launches': total,
          'launches_after_build': after_build, 'printed': printed,
          'checks': 'every CRC; one finite train_log_likelihood, every '
                    'parameter tag (histogram num = leaf size) and the '
                    'three layer-0 images at each entry'})
    return exp, total


def full_cov_vs_cpu(torch, layer, ND, z):
    """sample_from_conditional(full_cov=True) of ``layer`` on the card and
    on the CPU in float32 and float64, on the same inputs and z.  Returns
    (card results, CPU float64 results, {quantity: [card vs CPU float32,
    card vs float64, CPU float32 vs float64]})."""
    card = layer.sample_from_conditional(ND, True, noise=z)
    cpu = {}
    for name, dtype in (('f32', torch.float32), ('f64', torch.float64)):
        cpu_layer = copy.deepcopy(layer).to('cpu', dtype)
        cpu[name] = cpu_layer.sample_from_conditional(ND.cpu().to(dtype), True,
                                                      noise=z)
    errs = {}
    for i, q in enumerate(('sample', 'mean', 'cov')):
        c = card[i].cpu()
        errs[q] = [rel(c, cpu['f32'][i]), rel(c.double(), cpu['f64'][i]),
                   rel(cpu['f32'][i].double(), cpu['f64'][i])]
    return card, cpu['f64'], errs


def full_cov_phase(torch, dev, card: dict, flagship, rng, reset_counts,
                   read_counts) -> dict:
    """Full-covariance sampling on the card, held to the CPU under
    ``f32_agrees``: the trained flagship's layer 0 and last layer at
    N = 16, and the MNIST ConvKernel's last layer at N = 16 and at
    N = 128, whose peak memory is held under 1 GiB and whose leading
    16 x 16 block (a covariance entry depends on its two rows' inputs
    alone) against the CPU's N = 16 float64."""
    from deepcgp_tpu_torch.models import builder as mbuilder
    from deepcgp_tpu_torch.models.conv_kernels import gram_block_rows
    mflags = types.SimpleNamespace(**MNIST_CONV, num_samples=TRAIN_SAMPLES)
    images = rng.randn(512, *MNIST_IMAGE).astype(np.float32)
    mnist = mbuilder.build_model(mflags, MNIST_IMAGE, images=images,
                                 generator=torch.Generator().manual_seed(1),
                                 device=dev)
    X = torch.as_tensor(rng.randn(FULL_COV_N, *IMAGE).reshape(FULL_COV_N, -1),
                        dtype=torch.float32, device=dev)
    Xm = torch.as_tensor(images[:FULL_COV_MNIST_N].reshape(
        FULL_COV_MNIST_N, -1), device=dev)
    torch.cuda.synchronize()
    reset_counts()
    with torch.no_grad():
        lines, ND = [], X
        for label, layer in (('flagship layer 0', flagship.layers[0]),
                             ('flagship last layer', flagship.layers[1]),
                             ('mnist conv last layer', mnist.layers[-1])):
            if layer is mnist.layers[-1]:
                ND = Xm[:FULL_COV_N]
            z = rng.randn(layer.num_outputs, FULL_COV_N)
            res, ref64, errs = full_cov_vs_cpu(torch, layer, ND, z)
            ok = {q: f32_agrees({q: e[0]}, {q: e[1]}, {q: e[2]},
                                FULL_COV_TOL[q])[q] for q, e in errs.items()}
            lines.append({'layer': label, 'N': FULL_COV_N,
                          'outputs': layer.num_outputs,
                          'card_vs_cpu_f32': {q: e[0] for q, e in errs.items()},
                          'card_vs_cpu_f64': {q: e[1] for q, e in errs.items()},
                          'cpu_f32_vs_cpu_f64': {q: e[2]
                                                 for q, e in errs.items()},
                          'finite': all(finite(torch, t) for t in res)})
            check(all(ok.values()) and lines[-1]['finite'],
                  f'full cov {label}: {errs}')
            ND = res[0]              # the last layer reads layer 0's sample
        # The N = 128 call, its peak memory above what was allocated.
        z = rng.randn(mnist.layers[-1].num_outputs, FULL_COV_MNIST_N)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        big = mnist.layers[-1].sample_from_conditional(Xm, True, noise=z)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t
        peak = torch.cuda.max_memory_allocated() - base
    launches = read_counts()
    n = FULL_COV_N
    # ref64 and errs are the MNIST layer's at N = 16, the loop's last.
    lead = {'mean': rel(big[1][:n].cpu().double(), ref64[1]),
            'cov': rel(big[2][:n, :n].cpu().double(), ref64[2])}
    cpu_own = {q: errs[q][2] for q in lead}
    # A K1 + K3 pair per layer's precompute (4 calls); 2 K6 per last-layer
    # call (Kzx and the gram of ConvKernel.K, 3 calls).
    want = launches_of(chol_inv_base=4, tri_inv_base=4,
                       extract_patches_transposed=6)
    emit({'phase': 'full cov', **card, 'layers': lines,
          'mnist_conv_N128': {
              'seconds': seconds, 'peak_bytes_above_allocated': peak,
              'bound_bytes': FULL_COV_BOUND_BYTES,
              'gram_block_rows': gram_block_rows(
                  mnist.layers[-1].kernel.view.patch_count, FULL_COV_MNIST_N,
                  4),
              'leading_16_block_vs_cpu_f64_N16': lead,
              'finite': all(finite(torch, t) for t in big)},
          'launches': launches,
          'tolerance': f'{FULL_COV_TOL} of max|.| card vs CPU float32, or '
                       'within that plus twice the CPU float32\'s own distance '
                       'of the CPU float64 (f32_agrees)'})
    check(all(finite(torch, t) for t in big), 'full cov N = 128: not finite')
    check(peak < FULL_COV_BOUND_BYTES,
          f'full cov N = 128: peak {peak} bytes above what was allocated')
    check(all(lead[q] <= FULL_COV_TOL[q] + 2 * cpu_own[q] for q in lead),
          f'full cov N = 128: leading block vs CPU float64 {lead}')
    check(launches == want, f'full cov: launches {launches}, expected {want}')
    return launches


def diagnostics_phase(torch, card: dict, exp, seed: int, root: str,
                      reset_counts, read_counts) -> dict:
    """The diagnostics on the trained flagship of the tensorboard phase,
    one chunk of its training inside ``profiling.trace`` with an
    ``annotate`` region, and the noise sweep on its test set."""
    from deepcgp_tpu_torch.training import trainer
    from deepcgp_tpu_torch.utils import diagnostics, inspect, profiling
    model = exp.model
    torch.cuda.synchronize()
    reset_counts()
    t = time.perf_counter()
    health = diagnostics.param_health(model)
    chol = diagnostics.cholesky_health(model)
    xb = exp.X_train_dev[:TRAIN_BATCH].cpu().numpy()
    yb = exp.Y_train_dev[:TRAIN_BATCH].cpu().numpy()
    drift = diagnostics.elbo_drift(model, xb, yb, seed=seed)
    diag_s = time.perf_counter() - t
    trace_dir = os.path.join(root, 'trace')
    t = time.perf_counter()
    with profiling.trace(trace_dir):
        with profiling.annotate('flagship_chunk'):
            trainer.run_chunk(exp.state, exp.config, exp.X_train_dev,
                              exp.Y_train_dev, TRACE_STEPS)
    trace_s = time.perf_counter() - t
    (name,) = os.listdir(trace_dir)
    trace_bytes = os.path.getsize(os.path.join(trace_dir, name))
    with open(os.path.join(trace_dir, name)) as f:
        names = {e.get('name', '') for e in json.load(f)['traceEvents']}
    kernels = {k: any(any(n in e for n in profiling.KERNEL_NAMES[k])
                      for e in names)
               for k in ('chol_inv_base', 'tri_inv_base', 'conv_rbf_cross',
                         'conv_rbf_cross_bwd')}
    bwd_sides = {n: any(n in e for e in names)
                 for n in profiling.KERNEL_NAMES['conv_rbf_cross_bwd']}
    t = time.perf_counter()
    robust = inspect.noise_robustness(model, exp.X_test_dev, exp.Y_test_dev)
    robust_s = time.perf_counter() - t
    launches = read_counts()
    batches = -(-min(512, exp.X_test_dev.shape[0]) // EVAL_BATCH)
    want = expected_launches(
        (2, {'chol_inv_base': 1, 'tri_inv_base': 1}),      # cholesky_health
        (1, EVAL_PER_BATCH['flagship']),                   # elbo_drift's card ELBO
        (TRACE_STEPS, ADAM_PER_STEP['flagship']),
        (ROBUSTNESS_LEVELS * batches, EVAL_PER_BATCH['flagship']))
    emit({'phase': 'diagnostics and trace', **card,
          'param_health': health, 'cholesky_health': chol,
          'elbo_drift': drift, 'diagnostics_seconds': diag_s,
          'trace': {'steps': TRACE_STEPS, 'seconds': trace_s,
                    'chrome_trace_bytes': trace_bytes,
                    'names_annotate_region': 'flagship_chunk' in names,
                    'names_kernel': kernels, 'names_k5_side': bwd_sides},
          'noise_robustness': robust, 'noise_robustness_seconds': robust_s,
          'launches': launches,
          'tolerance': 'no non-finite leaf; every Cholesky finite; float32 '
                       'ELBO within 1e-3 of the float64 one (relative)'})
    check(health == {} and all(c['cholesky_ok'] for c in chol),
          f'diagnostics: {health} {chol}')
    check(drift['rel_drift'] <= 1e-3, f'diagnostics: elbo drift {drift}')
    check('flagship_chunk' in names and all(kernels.values())
          and all(bwd_sides.values()),
          f'trace: region {"flagship_chunk" in names}, kernels {kernels}, '
          f'K5 sides {bwd_sides}')
    check(list(robust) == [0.0, 0.25, 0.5, 1.0]
          and all(0.0 <= v <= 1.0 for v in robust.values()),
          f'noise robustness {robust}')
    check(launches == want, f'diagnostics and trace: launches {launches}, '
          f'expected {want}')
    return launches


def partial_view_model(torch, images: np.ndarray, seed: int, dev):
    """The partial-view model of PV_*, fresh: layer 1's Z from k-means of
    sampled image patches, the last layer's from patches of the images'
    centre pixels at the chosen positions (the patchwise mean's output),
    q_mu zero, q_sqrt 1e-5 chol(Kuu) (hidden) and chol(Kuu) (last)."""
    from deepcgp_tpu_torch import config
    from deepcgp_tpu_torch.models.base_kernels import RBF
    from deepcgp_tpu_torch.models.conv_kernels import (ConvKernel,
                                                       MultiOutputConvKernel)
    from deepcgp_tpu_torch.models.dgp import DGP
    from deepcgp_tpu_torch.models.inducing import patch_inducing_points
    from deepcgp_tpu_torch.models.layers import (ConvLayer, SVGPLayer,
                                                 fresh_q_sqrt, kernel_gram)
    from deepcgp_tpu_torch.models.likelihoods import MultiClass
    from deepcgp_tpu_torch.models.mean_functions import PatchwiseConv2d, Zero
    from deepcgp_tpu_torch.models.views import FullView, RandomPartialView
    from deepcgp_tpu_torch.ops.linalg import add_jitter
    g = torch.Generator().manual_seed(seed)
    H, W, C = PV_IMAGE
    view = RandomPartialView(input_size=(H, W), filter_size=5, feature_maps=C,
                             patch_count=PV_PATCHES, seed=0)
    Z1 = patch_inducing_points(images, PV_M, 5, generator=g, device=dev)
    base = RBF.create(device=dev)
    hidden = ConvLayer(
        base, Z1, torch.zeros(PV_M, 1, device=dev),
        fresh_q_sqrt(MultiOutputConvKernel(base, 1).Kuu(Z1), 1, 1e-5),
        PatchwiseConv2d.create(5, C, device=dev), view)
    centres = images[:, 2:H - 2, 2:W - 2, 0].reshape(len(images), -1)
    side = view.out_image_height
    H2 = centres[:, list(view.patch_indices)].reshape(-1, side, side, 1)
    Z2 = patch_inducing_points(H2, PV_M, 5, generator=g, device=dev)
    kernel = ConvKernel.create(RBF.create(device=dev),
                               FullView(input_size=(side, side),
                                        filter_size=5, feature_maps=1),
                               device=dev)
    last = SVGPLayer(kernel, Z2, torch.zeros(PV_M, 10, device=dev),
                     fresh_q_sqrt(add_jitter(kernel_gram(kernel, Z2),
                                             config.JITTER), 10),
                     Zero(10), num_outputs=10)
    return DGP([hidden, last], MultiClass(10), num_data=len(images),
               num_samples=TRAIN_SAMPLES)


def partial_view_adam(torch, dev, card: dict, rng, seed: int, reset_counts,
                      read_counts) -> dict:
    """The partial-view model trained with Adam (batch 32, S = 10) for a
    5 s window after 10 warm-up steps, one step against the CPU."""
    from deepcgp_tpu_torch.ops import cuda_cross
    from deepcgp_tpu_torch.training import trainer
    X = rng.randn(PV_IMAGES, *PV_IMAGE).astype(np.float32)
    Y = rng.randint(0, 10, size=(PV_IMAGES, 1))
    t = time.perf_counter()
    model = partial_view_model(torch, X, seed, dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t
    check(cuda_cross.fused_fits(model.layers[1].kernel),
          'partial view: the last layer is not on the fused route')
    config = trainer.TrainConfig(optimizer='Adam', lr=0.01,
                                 batch_size=TRAIN_BATCH)
    state = trainer.init_state(model, config, seed=seed)
    Xd = torch.as_tensor(X.reshape(PV_IMAGES, -1), device=dev)
    Yd = torch.as_tensor(Y, device=dev)
    warm = trainer.run_chunk(state, config, Xd, Yd, TRAIN_WARMUP_STEPS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    traces = []
    t_window = time.perf_counter()
    while time.perf_counter() - t_window < UNFUSED_WINDOW_SECONDS:
        traces.append(trainer.run_chunk(state, config, Xd, Yd, TRAIN_CHUNK))
        torch.cuda.synchronize()
    window = time.perf_counter() - t_window
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    steps = TRAIN_CHUNK * len(traces)
    trace = torch.cat([warm] + traces).cpu().numpy()
    fields, failure = adam_step_vs_cpu(torch, state, config, Xd, Yd,
                                       TRAIN_BATCH, rng)
    emit({'phase': 'partial view adam', **card, 'image': PV_IMAGE,
          'hidden': {'view': 'RandomPartialView', 'filter_size': 5,
                     'patch_count': PV_PATCHES, 'seed': 0, 'M': PV_M,
                     'gp_count': 1, 'mean': 'PatchwiseConv2d'},
          'last': {'kernel': 'ConvKernel', 'input': [12, 12, 1],
                   'filter_size': 5, 'P': 64, 'L': 25, 'M': PV_M,
                   'outputs': 10},
          'batch_size': TRAIN_BATCH, 'num_samples': TRAIN_SAMPLES,
          'build_seconds': build_s, 'warmup_steps': TRAIN_WARMUP_STEPS,
          'window_steps': steps, 'window_seconds': window,
          'steps_per_s': steps / window, 'launches': launches,
          'elbo_first': float(trace[0]), 'elbo_last': float(trace[-1]),
          'max_memory_allocated_bytes': peak, **fields})
    check(bool(np.isfinite(trace).all()), 'partial view: an ELBO is not finite')
    check(launches == expected_launches((steps, PV_PER_STEP)),
          f'partial view: launches {launches} for {steps} steps')
    check(failure is None, f'partial view {failure}')
    return launches


def regression_phase(torch, card: dict, reset_counts, read_counts) -> dict:
    """``python -m deepcgp_tpu_torch.examples.regression --steps-per-chunk
    REGRESSION_CHUNK`` in process: 5 chunks of Adam steps on the card, its
    train RMSE gated."""
    from deepcgp_tpu_torch.examples import regression
    reset_counts()
    out = io.StringIO()
    steps = 5 * REGRESSION_CHUNK
    with contextlib.redirect_stdout(out):
        t = time.perf_counter()
        rmse = regression.main(['--steps-per-chunk', str(REGRESSION_CHUNK)])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t
    launches = read_counts()
    emit({'phase': 'regression', **card,
          'entry': 'deepcgp_tpu_torch.examples.regression.main',
          'steps': steps, 'seconds': seconds, 'steps_per_s': steps / seconds,
          'printed': out.getvalue().splitlines(), 'train_rmse': rmse,
          'gate': f'train RMSE <= {REGRESSION_MAX_RMSE}',
          'jax_example_train_rmse': JAX_REGRESSION_RMSE,
          'jax_example_note': 'examples/regression.py on the CPU, jax 0.9.0; '
                              'its random streams differ from the port\'s',
          'launches': launches,
          'launches_note': 'M = 32 Kuu grams take the library Cholesky; the '
                           'path runs no kernel of the port'})
    check(rmse <= REGRESSION_MAX_RMSE, f'regression: train RMSE {rmse}')
    check(launches == launches_of(), f'regression: launches {launches}')
    return launches


def upper_any_p_phase(torch, dev, card: dict, rng, reset_counts,
                      read_counts) -> dict:
    """The upper base case at blocks that are not a multiple of 32, by
    the identity padding: against the plain version on the CPU (1e-5) and
    float64 (1e-4)."""
    from deepcgp_tpu_torch.ops import cuda_linalg
    rows, total = [], launches_of()
    for b, P in UPPER_ANY_P:
        D = spd_batch(torch, rng, b, P, dev)
        reset_counts()
        R, Ri = cuda_linalg.chol_inv_base_upper(D)
        torch.cuda.synchronize()
        launches = read_counts()
        total = {k: total[k] + launches[k] for k in total}
        Rp, Rip = cuda_linalg.chol_inv_base_upper(D.cpu())
        R64, Ri64 = cuda_linalg.chol_inv_base_upper(D.cpu().double())
        errs = {'R_vs_plain': rel(R.cpu(), Rp), 'Rinv_vs_plain': rel(Ri.cpu(), Rip),
                'R_vs_f64': rel(R.cpu().double(), R64),
                'Rinv_vs_f64': rel(Ri.cpu().double(), Ri64)}
        call = lambda: cuda_linalg.chol_inv_base_upper(D)  # noqa: E731
        rows.append({'shape': [b, P, P], 'padded_to': -(-P // 32) * 32,
                     **errs, 'call_ms': cuda_ms(torch, call, 20),
                     'device_ms': queued_ms(torch, call, 20),
                     'launches': launches})
        check(errs['R_vs_plain'] <= 1e-5 and errs['Rinv_vs_plain'] <= 1e-5
              and errs['R_vs_f64'] <= 1e-4 and errs['Rinv_vs_f64'] <= 1e-4
              and bool((torch.tril(R, -1) == 0).all()),
              f'upper base case [{b}, {P}, {P}]: {errs}')
        check(launches == launches_of(chol_inv_base_upper=1, tri_inv_base=1),
              f'upper base case [{b}, {P}, {P}]: launches {launches}')
    emit({'phase': 'upper base case, any P', **card, 'rows': rows,
          'route': 'the block padded with an identity tail to the next '
                   'multiple of 32, K2 + K3, the corner sliced',
          'timing': 'call_ms: host-paced calls by CUDA events; device_ms: '
                    'the calls queued behind a device spin (queued_ms), the '
                    'padding copy and the slices included',
          'tolerance': 'relative to max|.|: 1e-5 of the plain version (CPU '
                       'float32, unpadded), 1e-4 of float64'})
    return total


# -- the last of the JAX surface: native data path, FLOPs, examples, digits
# The native host data path at MNIST scale (a 60000 x 784 float64 fit, its
# float32 standardisation and a gather of its rows) and on 10000
# CIFAR-shaped images (extraction at f = 5, s = 3, and the flagship's
# k-means draw of 384 x 100 patches), each held bit for bit against its
# numpy version.
NATIVE_MNIST, NATIVE_CIFAR, NATIVE_DRAW = (60000, 784), 10000, 38400
# The example scripts on the synthetic fallback (or learnable blobs for the
# parity scripts) at cut schedules: the flags that change, and nothing else.
# Two chunks of 50 steps (train_steps of these flags); the parity scripts'
# verdicts on blobs at this schedule are read, not held: their thresholds
# are for the real data at the full schedule.
EXAMPLE_CUTS = {'-N': '2000', '--test-every': '50', '--lr-decay-steps': '40',
                '--test-size': '256'}
FM_SWEEP_ARGV = ['--feature-maps', '1', '2', '--chunks', '1',
                 '--test-every', '20']
# Learnable blobs written in the reference's layouts (uint8-scale pixels;
# MNIST flat, CIFAR NCHW): train and test rows.
PARITY_BLOBS = {'mnist': (2500, 500), 'cifar10': (2400, 600)}
# bench.py's _digits_probe configuration (bench.py:165-214) through the
# digits CLI's flags: 2 chunks of 500 Adam steps on the real UCI scans
# (the port's bundled copy where scikit-learn is absent), held-out accuracy
# on the 359 test scans gated at DIGITS_MIN_ACCURACY, beside the JAX
# package's reading (BENCH_r05.json).
DIGITS_ARGV = ['--name', 'digits', '-M', '64,64', '--feature-maps', '10',
               '--filter-sizes', '3,3', '--strides', '1,1', '--batch-size',
               '64', '--lr-decay-steps', '7000', '--test-every', '500',
               '--no-tensorboard']
DIGITS_CHUNKS, DIGITS_MIN_ACCURACY, DIGITS_JAX_ACCURACY = 2, 0.97, 0.9889
# The steps/s of the windows the FLOP accounting reads, by path.
WINDOW_STEPS_PER_S = {}


def native_phase(card: dict, seed: int) -> None:
    """Build the native library (g++) and hold each function against its
    numpy version, bit for bit, with both times."""
    from deepcgp_tpu_torch import native
    build_s = native.build()
    rng = np.random.RandomState(seed + 7)
    rows = []

    def pair(name, fn, plain, *args):
        t = time.perf_counter()
        out = fn(*args)
        native_ms = (time.perf_counter() - t) * 1e3
        t = time.perf_counter()
        ref = plain(*args)
        numpy_ms = (time.perf_counter() - t) * 1e3
        outs = out if isinstance(out, tuple) else (out,)
        refs = ref if isinstance(ref, tuple) else (ref,)
        equal = all(a.dtype == b.dtype and np.array_equal(a, b)
                    for a, b in zip(outs, refs))
        rows.append({'function': name, 'out_shape': list(outs[0].shape),
                     'native_ms': native_ms, 'numpy_ms': numpy_ms,
                     'bit_equal': equal})
        check(equal, f'native {name} differs from its numpy version')
        return out

    X = rng.randint(0, 256, size=NATIVE_MNIST).astype(np.float64)
    X[:, :40] = 0.0                          # constant columns: scale 1.0
    mean, std = pair('fit_scaler', native.fit_scaler, native.fit_scaler_numpy,
                     X)
    Xs = pair('standardize', native.standardize, native.standardize_numpy,
              X.astype(np.float32), mean, std)
    pair('gather_rows', native.gather_rows, native.gather_rows_numpy, Xs,
         rng.randint(0, len(Xs), size=len(Xs)))
    images = rng.randn(NATIVE_CIFAR, *IMAGE).astype(np.float32)
    pair('extract_patches', native.extract_patches,
         native.extract_patches_numpy, images, 5, 3)
    offsets = [rng.randint(0, hi, size=NATIVE_DRAW)
               for hi in (NATIVE_CIFAR, IMAGE[0] - 5, IMAGE[1] - 5)]
    pair('sample_patches', native.sample_patches, native.sample_patches_numpy,
         images, *offsets, 5)
    emit({'phase': 'native', **card, 'build_seconds': build_s,
          'library': str(native.library_path().relative_to(
              native.BUILD_DIR.parents[1])),
          'compiler': ['g++', *native.GXX_FLAGS], 'functions': rows,
          'tolerance': 'bit-equal to the numpy version'})


def flop_reading(model, batch: int, steps_per_s: float, peak: float) -> dict:
    """utils/flops' counts of one step of ``model`` at ``batch`` and the
    rates a window's steps/s gives them."""
    from deepcgp_tpu_torch.utils import flops
    model_flop = flops.training_step_flops(model, batch)
    hardware_flop = flops.training_step_hardware_flops(model, batch)
    return {'batch_size': batch, 'num_samples': model.num_samples,
            'model_gflop_per_step': model_flop / 1e9,
            'hardware_gflop_per_step': hardware_flop / 1e9,
            'min_bytes_per_step': flops.training_step_min_bytes(model, batch),
            'steps_per_s': steps_per_s,
            'model_tflops': model_flop * steps_per_s / 1e12,
            'hardware_tflops': hardware_flop * steps_per_s / 1e12,
            'mfu': model_flop * steps_per_s / peak,
            'hardware_share_of_peak': hardware_flop * steps_per_s / peak}


def flops_phase(torch, dev, card: dict, readings: dict) -> None:
    """The windows' FLOP readings beside the table's peak, and a measured
    torch.matmul rate at 8192^3 in BF16 and in FP32 (TF32 off)."""
    from deepcgp_tpu_torch.utils import flops
    check(not torch.backends.cuda.matmul.allow_tf32,
          'float32 products would run in TF32')
    n = 8192
    matmul = {}
    for name, dtype in (('bf16', torch.bfloat16), ('fp32', torch.float32)):
        a = torch.randn(n, n, device=dev, dtype=dtype)
        b = torch.randn(n, n, device=dev, dtype=dtype)
        ms = cuda_ms(torch, lambda: a @ b, 10)
        matmul[name] = {'ms': ms, 'tflops': 2 * n ** 3 / ms / 1e9}
        del a, b
    peak = flops.device_peak_flops(dev)
    emit({'phase': 'flops', **card, 'device_name': torch.cuda.get_device_name(0),
          'peak_tflops_bf16_dense': peak / 1e12,
          'peak_source': 'utils/flops.GPU_PEAK_FLOPS (NVIDIA H100 data sheet)',
          'matmul_8192': matmul,
          'matmul_bf16_share_of_peak': matmul['bf16']['tflops'] * 1e12 / peak,
          'windows': readings})
    check(all(np.isfinite(r['model_gflop_per_step']) and r['steps_per_s'] > 0
              for r in readings.values()), f'flops readings {readings}')


def cut_argv(argv: list, cuts: dict) -> list:
    """``argv`` with the value after each flag of ``cuts`` replaced (and a
    flag it lacks appended with its value)."""
    out = list(argv)
    for flag, value in cuts.items():
        if flag in out:
            out[out.index(flag) + 1] = value
        else:
            out += [flag, value]
    return out


def run_counted(torch, fn, read_counts):
    """fn() with its printed lines captured; the launches of every model
    build (``Experiment`` builds) kept apart.  Returns (fn(), printed
    lines, launches outside the builds, the builds' launches, the number of
    builds, seconds).  The caller resets the counters first."""
    from deepcgp_tpu_torch.training import experiment
    real, builds = experiment.build_model, []

    def build(*a, **k):
        before = read_counts()
        model = real(*a, **k)
        builds.append(minus(read_counts(), before))
        return model
    out = io.StringIO()
    experiment.build_model = build
    try:
        with contextlib.redirect_stdout(out):
            t = time.perf_counter()
            result = fn()
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t
    finally:
        experiment.build_model = real
    in_builds = launches_of()
    for b in builds:
        in_builds = {k: in_builds[k] + b[k] for k in in_builds}
    return (result, out.getvalue().splitlines(),
            minus(read_counts(), in_builds), in_builds, len(builds), seconds)


def write_blob_npz(path: str, name: str, seed: int) -> None:
    """Learnable blobs in the reference's file layout: uint8-scale pixels,
    MNIST flat [n, 784], CIFAR NCHW [n, 3, 32, 32]."""
    from deepcgp_tpu_torch.training import data
    n_train, n_test = PARITY_BLOBS[name]
    shape = MNIST_IMAGE if name == 'mnist' else IMAGE
    X, y = data.learnable_blobs(n_train + n_test, shape, 10, seed)
    pixels = np.clip(np.rint(128.0 + 48.0 * X), 0, 255).astype(np.uint8)
    pixels = (pixels.reshape(len(X), -1) if name == 'mnist'
              else pixels.transpose(0, 3, 1, 2))
    np.savez(path, x_train=pixels[:n_train], y_train=y[:n_train, 0],
             x_test=pixels[n_train:], y_test=y[n_train:, 0])


def decoded_pngs(paths: list) -> dict:
    """{file name: (shape, tEXt chunks)} of each PNG, decoded."""
    from deepcgp_tpu_torch.utils import events
    out = {}
    for p in paths:
        if p.endswith('.png'):
            with open(p, 'rb') as f:
                raw = f.read()
            out[os.path.basename(p)] = (list(events.decode_png(raw).shape),
                                        events.png_text(raw))
    return out


def example_phases(torch, card: dict, seed: int, reset_counts,
                   read_counts) -> dict:
    """The example scripts, each an Adam path: train_mnist (then serve and
    inspect_model on its run), fm_sweep, both parity scripts (refused
    without data, then on blobs) and the digits probe on the real scans.
    Each holds its exact launches; returns each path's launches."""
    paths = {}
    with tempfile.TemporaryDirectory() as empty, \
            tempfile.TemporaryDirectory() as root:
        with data_dir_set(empty):
            paths.update(example_mnist_paths(torch, card, root, reset_counts,
                                              read_counts))
            paths['example_fm_sweep'] = example_fm_sweep(
                torch, card, root, reset_counts, read_counts)
        paths.update(example_parity(torch, card, seed, empty, root,
                                    reset_counts, read_counts))
        paths['digits_real_data'] = digits_phase(torch, card, root,
                                                 reset_counts, read_counts)
    return paths


def example_mnist_paths(torch, card: dict, root: str, reset_counts,
                        read_counts) -> dict:
    """train_mnist's ARGV at EXAMPLE_CUTS, then serve.main and
    inspect_model.main on its run dir."""
    from deepcgp_tpu_torch.examples import inspect_model, serve, train_mnist
    from deepcgp_tpu_torch.training.arguments import train_steps
    # Its files go under ``root``: the run and the TensorBoard log, which
    # the ARGV leaves on.
    cuts = dict(EXAMPLE_CUTS, **{'--log-dir': os.path.join(root, 'results'),
                                 '--tensorboard-dir': os.path.join(root, 'tb')})
    argv = cut_argv(train_mnist.ARGV, cuts)
    reset_counts()
    exp, printed, launches, in_builds, builds, seconds = run_counted(
        torch, lambda: train_mnist.main(argv), read_counts)
    chunks = train_steps(exp.flags)
    steps = chunks * exp.flags.test_every
    evals = chunks * -(-exp.flags.test_size // EVAL_BATCH)
    # A TensorBoard entry a chunk: the minibatch ELBO over the first
    # min(5000, N) rows in batches of 64, and layer 0 on one test image.
    tb_elbos = -(-min(TB_ELBO_ROWS, exp.flags.N) // TB_ELBO_BATCH)
    want = expected_launches((steps, ADAM_PER_STEP['flagship']),
                             (evals, EVAL_PER_BATCH['flagship']),
                             (chunks * tb_elbos, EVAL_PER_BATCH['flagship']),
                             (chunks, {'chol_inv_base': 1, 'tri_inv_base': 1}))
    run_dir = os.path.join(root, 'results', 'mnist_example')
    _, rows = log_rows(run_dir)
    elbos = [float(r['train_elbo']) for r in rows]
    total = read_counts()
    emit({'phase': 'example train_mnist', **card,
          'entry': 'deepcgp_tpu_torch.examples.train_mnist.main',
          'cuts': cuts, 'argv': argv, 'chunks': chunks, 'steps': steps,
          'eval_batches': evals, 'seconds': seconds, 'log_csv': rows,
          'printed': printed, 'launches': total,
          'launches_in_builds': in_builds, 'launches_outside_builds': launches})
    check(builds == 1 and launches == want,
          f'train_mnist: launches {launches} outside {builds} builds, '
          f'expected {want}')
    check(len(rows) == chunks and all(np.isfinite(elbos)),
          f'train_mnist: log rows {rows}')
    paths = {'example_train_mnist': total}

    reset_counts()
    t = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as out:
        acc, dens = serve.main(run_dir)
    seconds = time.perf_counter() - t
    launches = read_counts()
    # A warm request of 128 rows, 1000 rows in batches of 128, 32 rows'
    # log-densities: one predict_y a batch.
    calls = 1 + -(-1000 // 128) + 1
    want = expected_launches((calls, EVAL_PER_BATCH['flagship']))
    emit({'phase': 'example serve', **card,
          'entry': 'deepcgp_tpu_torch.examples.serve.main', 'run_dir':
          'train_mnist\'s', 'seconds': seconds, 'accuracy': acc,
          'mean_log_density': dens, 'printed': out.getvalue().splitlines(),
          'predict_y_calls': calls, 'launches': launches})
    check(launches == want, f'serve: launches {launches}, expected {want}')
    check(0.0 <= acc <= 1.0 and np.isfinite(dens) and dens <= 0.0,
          f'serve: accuracy {acc}, log-density {dens}')
    paths['example_serve'] = launches

    reset_counts()
    t = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as out:
        written = inspect_model.main(run_dir)
    seconds = time.perf_counter() - t
    launches = read_counts()
    # layer_features: one propagate of 256 rows; noise_robustness: 4 noise
    # levels x 512 rows in batches of 32.
    calls = 1 + 4 * 512 // EVAL_BATCH
    want = expected_launches((calls, EVAL_PER_BATCH['flagship']))
    pngs = decoded_pngs(written)
    names = [os.path.basename(p) for p in written]
    emit({'phase': 'example inspect_model', **card,
          'entry': 'deepcgp_tpu_torch.examples.inspect_model.main',
          'seconds': seconds, 'written': names, 'pngs': pngs,
          'printed': out.getvalue().splitlines(), 'launches': launches})
    check(launches == want, f'inspect_model: launches {launches}, '
          f'expected {want}')
    check(names == ['inducing_grid.npy', 'embedding_inducing.npy',
                    'embedding_data.npy', 'inducing_grid_layer0.png',
                    'patch_embedding_layer0.png', 'inducing_grid_layer1.png',
                    'noise_robustness.png']
          and all(s[2] == 3 and 'Title' in text for s, text in pngs.values()),
          f'inspect_model wrote {names}: {pngs}')
    paths['example_inspect_model'] = launches
    return paths


def example_fm_sweep(torch, card: dict, root: str, reset_counts,
                     read_counts) -> dict:
    """fm_sweep.main over feature maps 1 and 2, one 20-step chunk each."""
    from deepcgp_tpu_torch.examples import fm_sweep
    argv = FM_SWEEP_ARGV + ['--log-dir', os.path.join(root, 'fm_sweep')]
    reset_counts()
    rows, printed, launches, in_builds, builds, seconds = run_counted(
        torch, lambda: fm_sweep.main(argv), read_counts)
    # Per point: 20 steps, an eval of the 1000 test images in the chunk's
    # log entry and one more for the summary.
    evals = 2 * -(-1000 // EVAL_BATCH)
    want = expected_launches((2 * 20, ADAM_PER_STEP['flagship']),
                             (2 * evals, EVAL_PER_BATCH['flagship']))
    with open(os.path.join(root, 'fm_sweep', 'fm_sweep_summary.csv')) as f:
        summary = list(csv.reader(f))
    total = read_counts()
    emit({'phase': 'example fm_sweep', **card,
          'entry': 'deepcgp_tpu_torch.examples.fm_sweep.main', 'argv': argv,
          'seconds': seconds, 'summary_csv': summary, 'printed': printed,
          'launches': total, 'launches_in_builds': in_builds,
          'launches_outside_builds': launches})
    check(builds == 2 and launches == want,
          f'fm_sweep: launches {launches} outside {builds} builds, '
          f'expected {want}')
    check(summary[0] == ['feature_maps', 'test_accuracy', 'train_elbo']
          and [r[0] for r in summary[1:]] == ['1', '2']
          and all(np.isfinite(float(r[2])) for r in summary[1:]),
          f'fm_sweep summary {summary}')
    return total


def example_parity(torch, card: dict, seed: int, empty: str, root: str,
                   reset_counts, read_counts) -> dict:
    """Each parity script refused (2) against an empty data dir, then its
    ``parity_argv`` at EXAMPLE_CUTS (mnist: --fast) through ``main`` on a
    learnable-blobs file in the reference's layout."""
    from deepcgp_tpu_torch.examples import cifar_parity, mnist_parity
    from deepcgp_tpu_torch.training.arguments import train_steps
    paths = {}
    with tempfile.TemporaryDirectory() as blobs:
        for name, module, args, per_step, per_eval in (
                ('mnist', mnist_parity, ['--fast'],
                 UNFUSED_PER_STEP['mnist_conv'], MNIST_SERVING_PER_CALL),
                ('cifar', cifar_parity, [], ADAM_PER_STEP['flagship'],
                 EVAL_PER_BATCH['flagship'])):
            label = f'example_{name}_parity'
            file = 'mnist' if name == 'mnist' else 'cifar10'
            log_dir = os.path.join(root, label)
            with data_dir_set(empty), \
                    contextlib.redirect_stderr(io.StringIO()) as err:
                refused = module.main(args + ['--log-dir', log_dir])
            write_blob_npz(os.path.join(blobs, f'{file}.npz'), file, seed)
            real_argv = module.parity_argv
            argv = cut_argv(real_argv(log_dir, *([False, True] if args else [])),
                            EXAMPLE_CUTS)
            module.parity_argv = lambda *a, **k: cut_argv(real_argv(*a, **k),
                                                          EXAMPLE_CUTS)
            reset_counts()
            try:
                with data_dir_set(blobs):
                    code, printed, launches, in_builds, builds, seconds = \
                        run_counted(torch, lambda: module.main(
                            args + ['--log-dir', log_dir]), read_counts)
            finally:
                module.parity_argv = real_argv
            flags = module.read_args(argv)
            chunks = train_steps(flags)
            steps = chunks * flags.test_every
            n_train, n_test = PARITY_BLOBS[file]
            test_rows = n_test if name == 'mnist' else n_test + n_train - flags.N
            # An eval in each chunk's log entry, and the script's own.
            evals = (chunks + 1) * -(-min(flags.test_size, test_rows)
                                     // EVAL_BATCH)
            want = expected_launches((steps, per_step), (evals, per_eval))
            total = read_counts()
            emit({'phase': f'example {name}_parity', **card,
                  'entry': f'{module.__name__}.main', 'args': args,
                  'refused_without_data': refused,
                  'refusal': err.getvalue().splitlines(),
                  'data': f'learnable_blobs({n_train + n_test}, 10, {seed}) '
                          f'as uint8-scale {file}.npz, {n_train} train rows',
                  'cuts': EXAMPLE_CUTS, 'argv': argv, 'returned': code,
                  'printed': printed, 'steps': steps, 'eval_batches': evals,
                  'seconds': seconds, 'launches': total,
                  'launches_in_builds': in_builds,
                  'launches_outside_builds': launches})
            check(refused == 2, f'{name} parity without data returned {refused}')
            check(builds == 1 and launches == want,
                  f'{name} parity: launches {launches} outside {builds} '
                  f'builds, expected {want}')
            verdict = f'{name}-parity: final test_accuracy='
            check(code in (0, 1) and printed[-1].startswith(verdict)
                  and printed[-1].endswith(('FAIL', 'PASS')[code == 0]),
                  f'{name} parity on blobs: {code} {printed[-1:]}')
            paths[label] = total
    return paths


def digits_probe(log_dir: str, device=None):
    """DIGITS_CHUNKS chunks of the digits probe through a ``Digits``
    experiment; returns (the concluded experiment, its held-out
    accuracy).  ``device='cpu'`` runs it on the CPU."""
    from deepcgp_tpu_torch import digits
    exp = digits.Digits(digits.read_args(DIGITS_ARGV + ['--log-dir', log_dir]),
                        device=device)
    try:
        for _ in range(DIGITS_CHUNKS):
            exp.train_step()
    finally:
        exp.conclude()
    return exp, exp.test_accuracy()


def digits_phase(torch, card: dict, root: str, reset_counts,
                 read_counts) -> dict:
    """The digits probe on the real scans: held-out accuracy gated at
    DIGITS_MIN_ACCURACY, exact launches."""
    import importlib.util
    reset_counts()
    (exp, accuracy), printed, launches, in_builds, builds, seconds = \
        run_counted(torch, lambda: digits_probe(os.path.join(root, 'digits')),
                    read_counts)
    steps = DIGITS_CHUNKS * exp.flags.test_every
    # An eval of the 359 test scans in each log entry, and the probe's own.
    evals = (DIGITS_CHUNKS + 1) * -(-exp.flags.test_size // EVAL_BATCH)
    want = expected_launches((steps, ADAM_PER_STEP['flagship']),
                             (evals, EVAL_PER_BATCH['flagship']))
    total = read_counts()
    emit({'phase': 'digits real data', **card, 'argv': DIGITS_ARGV,
          'source': ('scikit-learn load_digits'
                     if importlib.util.find_spec('sklearn') else
                     'deepcgp_tpu_torch/training/digits.npz'),
          'train_rows': len(exp.X_train), 'test_rows': len(exp.X_test),
          'steps': steps, 'seconds': seconds, 'printed': printed,
          'held_out_accuracy': accuracy,
          'jax_package_accuracy': DIGITS_JAX_ACCURACY,
          'min_accuracy': DIGITS_MIN_ACCURACY, 'train_elbo': exp.last_mean_elbo,
          'launches': total, 'launches_in_builds': in_builds,
          'launches_outside_builds': launches})
    check(len(exp.X_train) + len(exp.X_test) == 1797,
          'the digits are not the 1797 UCI scans')
    check(builds == 1 and launches == want,
          f'digits: launches {launches} outside {builds} builds, '
          f'expected {want}')
    check(accuracy >= DIGITS_MIN_ACCURACY,
          f'digits held-out accuracy {accuracy} < {DIGITS_MIN_ACCURACY}')
    return total


# The measurement tools (deepcgp_tpu_torch/tools): the roofline of a
# graphed chunk of ROOFLINE_STEPS flagship Adam and M=1024 NatGrad steps
# (the buckets hold the profiler's device total to ROOFLINE_TOTAL_RTOL,
# the K buckets the launch counters, 'other' at most ROOFLINE_OTHER_MAX of
# the time, every replayed step joined to the eager one), the flagship's
# bytes audit (the hand kernels' rows at PERF.md's formulas), the flagship
# NatGrad soak cut to SOAK_STEPS in chunks of SOAK_CHUNK, and the digits
# NatGrad sweep cut to DIGITS_SWEEP at DIGITS_SWEEP_STEPS.
ROOFLINE_STEPS, ROOFLINE_TOTAL_RTOL, ROOFLINE_OTHER_MAX = 50, 1e-3, 0.05
ROOFLINE_TIMEOUT_S = 300
ROOFLINE_PATHS = (('flagship adam', 'flagship'),
                  ('m1024 natgrad', 'm1024-natgrad'))
SOAK_STEPS, SOAK_CHUNK = 1000, 500
DIGITS_SWEEP, DIGITS_SWEEP_STEPS = ('adam', 'ng-g1e-2'), 1000


def roofline_phase(torch, card: dict, label: str, config: str, root: str):
    """``python -m deepcgp_tpu_torch.tools.roofline`` on one configuration,
    as a user runs it, in a process of its own: build, the reference step
    (its capture), ROOFLINE_STEPS warm steps, a steady chunk, a traced
    chunk.  Its launches are that process's counters, reset and read
    around the traced chunk.  Returns (the roofline, the saved meta) as
    the process saved them."""
    from deepcgp_tpu_torch.tools import roofline
    trace_dir = os.path.join(root, config)
    t = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, '-m', 'deepcgp_tpu_torch.tools.roofline', '--config',
         config, '--steps', str(ROOFLINE_STEPS), '--trace-dir', trace_dir],
        capture_output=True, text=True, timeout=ROOFLINE_TIMEOUT_S,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    seconds = time.perf_counter() - t
    check(proc.returncode == 0, f'roofline {label}: exit {proc.returncode}: '
          f'{proc.stderr[-3000:]}')
    result = roofline.read_result(trace_dir)
    meta = roofline.read_meta(trace_dir)
    steps, total = result.steps, result.total_us
    other = result.buckets.get('other', 0.0) / total
    counts = {name: result.counts.get(bucket, 0)
              for name, bucket in roofline.K_BUCKETS.items()}
    emit({'phase': f'roofline {label}', **card, 'config': config,
          'steps': steps, 'seconds': seconds,
          'steps_per_s': result.steps_per_s,
          'device_ms_per_step': total / steps / 1e3,
          'profiler_device_ms_per_step': result.device_total_us / steps / 1e3,
          'buckets_ms_per_step': {b: us / steps / 1e3 for b, us in sorted(
              result.buckets.items(), key=lambda kv: -kv[1])},
          'bucket_launches': result.counts,
          'sources_ms_per_step': {b: {d: us / steps / 1e3 for d, us in v.items()}
                                  for b, v in result.sources.items()},
          'other_share': other, 'joined_steps': result.joined_steps,
          'step_events': result.step_events, 'launches': result.launches,
          'profile_rounds': result.rounds,
          'top_kernels_ms_per_step': [
              [n[:90], us / steps / 1e3] for n, us in sorted(
                  result.per_name.items(), key=lambda kv: -kv[1])[:12]],
          'tolerance': f'buckets = profiler device total within '
                       f'{ROOFLINE_TOTAL_RTOL}; K buckets = launch counters; '
                       f'other <= {ROOFLINE_OTHER_MAX}; every step joined'})
    check(abs(total - result.device_total_us)
          <= ROOFLINE_TOTAL_RTOL * result.device_total_us,
          f'roofline {label}: buckets {total} us, profiler '
          f'{result.device_total_us} us')
    check(counts == result.launches, f'roofline {label}: K buckets {counts}, '
          f'launches {result.launches}')
    check(other <= ROOFLINE_OTHER_MAX, f'roofline {label}: other {other}')
    check(result.joined_steps == steps, f'roofline {label}: joined '
          f'{result.joined_steps} of {steps} steps')
    return result, meta


def bytes_phase(torch, card: dict, label: str, result, meta) -> None:
    """``tools.bytes_audit`` on a roofline's traces: MB a step against the
    model-minimal traffic; each hand kernel's bytes at PERF.md's formula
    where it has one."""
    from deepcgp_tpu_torch.tools import bytes_audit, roofline
    audit = bytes_audit.audit(result, roofline.parse_trace(meta['reference']),
                              meta)
    hand = [{'kernel': name, 'bytes': b, 'formula_bytes': formula,
             'shapes': shapes} for name, b, formula, shapes in audit.hand]
    emit({'phase': f'bytes {label}', **card,
          'us_per_step': audit.us_step, 'mb_per_step': audit.mb_step,
          'min_mb_per_step': audit.min_bytes / 1e6,
          'ratio_to_min': audit.mb_step * 1e6 / audit.min_bytes,
          'program_tb_per_s': audit.mb_step / audit.us_step,
          'inputs_from_dispatch_log': audit.fallback,
          'events_unowned': audit.unmatched, 'hand_kernels': hand,
          'tolerance': "each hand kernel's bytes equal PERF.md's formula "
                       "where it has one (K1, K2, K3, K6, K7)"})
    check(hand and all(h['formula_bytes'] in (None, h['bytes'])
                       for h in hand), f'bytes {label}: {hand}')
    check(audit.mb_step > 0, f'bytes {label}: no bytes')


def soak_phase(torch, card: dict, reset_counts, read_counts) -> dict:
    """``tools.soak`` on the flagship with NatGrad, cut to SOAK_STEPS in
    SOAK_CHUNK-step chunks, gated SOAK OK, with its exact launches."""
    from deepcgp_tpu_torch.tools import soak
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        model, X, Y = soak.build('flagship', 0, 'cuda')
        reset_counts()
        t = time.perf_counter()
        result = soak.soak(model, X, Y, 'flagship', 'NatGrad', TRAIN_BATCH,
                           SOAK_STEPS, SOAK_CHUNK)
    seconds = time.perf_counter() - t
    launches = read_counts()
    chunks = -(-SOAK_STEPS // SOAK_CHUNK)
    want = expected_launches((SOAK_STEPS, NATGRAD_PER_STEP['flagship']),
                             (chunks, NATGRAD_PER_CHUNK['flagship']),
                             (-(-len(X) // 128), EVAL_PER_BATCH['flagship']))
    emit({'phase': 'soak flagship natgrad', **card, 'steps': SOAK_STEPS,
          'chunk': SOAK_CHUNK, 'seconds': seconds,
          'printed': out.getvalue().splitlines(), 'ok': result['ok'],
          'nan_steps': result['nan_steps'], 'steps_back': result['steps_back'],
          'train_accuracy': result['train_accuracy'],
          'steps_per_s': result['steps_per_s'],
          'elbo_first': float(result['elbos'][0]),
          'elbo_last': float(result['elbos'][-1]), 'launches': launches,
          'expected_launches': want,
          'gate': "SOAK OK: no NaN step, steps_back 0, the last ELBO finite"})
    check(result['ok'], f'soak: {out.getvalue()}')
    check(launches == want, f'soak: launches {launches}, expected {want}')
    return launches


def digits_sweep_phase(torch, card: dict, reset_counts, read_counts) -> dict:
    """``tools.natgrad_digits`` cut to DIGITS_SWEEP at DIGITS_SWEEP_STEPS:
    exit code 0, its JSON printed, exact launches."""
    from deepcgp_tpu_torch.tools import natgrad_digits
    reset_counts()
    out = io.StringIO()
    t = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = natgrad_digits.main(['--steps', str(DIGITS_SWEEP_STEPS),
                                  '--only', ','.join(DIGITS_SWEEP)])
    seconds = time.perf_counter() - t
    launches = read_counts()
    records = json.loads(out.getvalue())
    evals = DIGITS_SWEEP_STEPS // 500
    batches = evals * -(-359 // 128)
    want = expected_launches(
        (DIGITS_SWEEP_STEPS, ADAM_PER_STEP['flagship']),
        (DIGITS_SWEEP_STEPS, NATGRAD_PER_STEP['flagship']),
        (evals, NATGRAD_PER_CHUNK['flagship']),
        (2 * batches, EVAL_PER_BATCH['flagship']))
    emit({'phase': 'natgrad digits', **card, 'only': list(DIGITS_SWEEP),
          'steps': DIGITS_SWEEP_STEPS, 'seconds': seconds, 'exit_code': rc,
          'results': records, 'launches': launches,
          'expected_launches': want})
    check(rc == 0 and [r['tag'] for r in records] == list(DIGITS_SWEEP),
          f'natgrad digits: exit {rc}, {records}')
    check(launches == want, f'natgrad digits: launches {launches}, '
          f'expected {want}')
    return launches


def tool_phases(torch, card: dict, reset_counts, read_counts) -> dict:
    """The four measurement tools on the card; returns each path's
    launches."""
    paths = {}
    with tempfile.TemporaryDirectory() as root:
        for label, config in ROOFLINE_PATHS:
            result, meta = roofline_phase(torch, card, label, config, root)
            paths[f'roofline {label}'] = result.launches
            if label == 'flagship adam':
                bytes_phase(torch, card, label, result, meta)
    paths['soak flagship natgrad'] = soak_phase(torch, card, reset_counts,
                                                read_counts)
    paths['natgrad digits'] = digits_sweep_phase(torch, card, reset_counts,
                                                 read_counts)
    return paths


def kernel_counters() -> dict:
    """Every kernel wrapper, by its COUNTERS name; each counts its
    launches in ``.launches``."""
    from deepcgp_tpu_torch.utils import profiling
    return profiling.kernel_counters()


# -- the mesh: the port's torch.distributed layer on the card ---------------
# (a) The flagship CLI in one process as a one-rank NCCL group
# (``--mesh data=1 --distributed``) against the plain run of the same argv:
# 3 chunks of 10 Adam steps, an eval of 256 images after each.
MESH_CLI = CLI_FLAGSHIP[:-1] + ['--name', 'mesh', '--test-every', '10',
                                '--lr-decay-steps', '10', '--test-size', '256']
# (b) Two processes sharing the card over gloo (NCCL takes one rank a
# device): with mesh data=2, then with the group kept and the mesh
# re-formed as model=2, each case's steps against the same steps in one
# process on the card (deepcgp_tpu/parallel/train.py's float32 rule: the
# ELBO within 1e-4 of max(|ELBO|, 1)), and before them each case's
# gradients at the start, summed over the data group, against the one-
# process gradients: every leaf within MESH_GRAD_RTOL of its max |.|.  That
# checks the backward collectives, which no ELBO computed before its
# update sees.  float32 in another summation order reads up to 2.2e-3
# (fm32's last-layer variance, a sum over every patch) and a collective
# patched out 0.5 or more on the leaves it feeds, so the rule sits
# between; then Predictor(mesh='data=2') on a
# request of MESH_REQUEST rows.  The flagship starts from the seed's
# snapshot (trained-looking q_sqrt, the last layer at lengthscale 25, so
# that every gradient resolves in float32), the unfused configurations
# from a build on MESH_IMAGES seeded images with every q_mu moved off 0
# by 0.05 x a seeded normal (at q_mu = 0 all class means are 0, the
# robust-max likelihood is symmetric in them, and the gradients of the
# patch weights, Z and the kernel's parameters are float32 noise).
MESH_WORLD, MESH_IMAGES, MESH_REQUEST = 2, 256, 50
MESH_CASES = (('data=2', (('flagship', 'Adam', 2), ('flagship', 'NatGrad', 2))),
              ('model=2', (('flagship', 'Adam', 2), ('flagship', 'NatGrad', 2),
                           ('mnist_conv', 'Adam', 1), ('fm32', 'Adam', 1))))
MESH_TIMEOUT_S = 420
MESH_RTOL, MESH_GRAD_RTOL = 1e-4, 1e-2


def mesh_model(torch, label: str, seed: int, dev):
    """(model, X [MESH_IMAGES, D], Y) of a mesh case, on ``dev``."""
    from deepcgp_tpu_torch.models.builder import build_model
    from deepcgp_tpu_torch.utils.checkpoint import parse_layer_parameters
    flags, image = {'flagship': (FLAGSHIP, IMAGE),
                    'mnist_conv': (MNIST_CONV, MNIST_IMAGE),
                    'fm32': (FM32, IMAGE)}[label]
    rng = np.random.RandomState(seed + 11)
    X = rng.randn(MESH_IMAGES, *image).astype(np.float32)
    Y = rng.randint(0, 10, size=(MESH_IMAGES, 1))
    ns = types.SimpleNamespace(**flags, num_samples=TRAIN_SAMPLES)
    if label == 'flagship':
        _, loaded = parse_layer_parameters(flagship_snapshot(seed), 2)
        model = build_model(ns, image, loaded, num_data=MESH_IMAGES,
                            device=dev)
    else:
        loaded = ({1: {'base_kernel/lengthscales': LENGTHSCALES[1]}}
                  if label == 'fm32' else None)
        model = build_model(ns, image, loaded, images=X,
                            generator=torch.Generator().manual_seed(seed),
                            device=dev)
        with torch.no_grad():
            for layer in model.layers:
                layer.q_mu.add_(0.05 * torch.as_tensor(
                    rng.randn(*layer.q_mu.shape), dtype=layer.q_mu.dtype,
                    device=dev))
    return (model, torch.as_tensor(X.reshape(MESH_IMAGES, -1), device=dev),
            torch.as_tensor(Y, device=dev))


def mesh_grads(torch, mesh, model, config, seed: int, X, Y) -> dict:
    """{leaf: max |g - g1| / max |g1|}: each leaf's gradient of the loss on
    the batch (X, Y) under ``mesh`` (this rank's rows, summed over the data
    group as ``trainer.train_step`` sums them) against the one-process
    gradient g1, both from a generator seeded with ``seed``."""
    from deepcgp_tpu_torch.parallel import mesh as mesh_lib
    from deepcgp_tpu_torch.parallel import sharding
    from deepcgp_tpu_torch.training import trainer
    ref = trainer.init_state(copy.deepcopy(model), config, seed=seed)
    state = trainer.init_state(copy.deepcopy(model), config, seed=seed)
    _, want = trainer.loss_and_grads(ref, X, Y)
    with sharding.mesh_context(mesh):
        _, got = trainer.loss_and_grads(
            state, *mesh_lib.shard_batch(mesh, X, Y))
        names = list(got)
        got = dict(zip(names, sharding.sum_over_data([got[k]
                                                      for k in names])))
    return {k: rel(got[k], want[k]) for k in names}


def mesh_case(torch, mesh, label: str, optimizer: str, steps: int, seed: int,
              dev, counters: dict) -> dict:
    """The gradients at the start (:func:`mesh_grads`), then ``steps``
    sharded steps of a case against the same steps in one process, with
    this rank's launches of the sharded steps."""
    from deepcgp_tpu_torch.parallel import sharding
    from deepcgp_tpu_torch.parallel.train import make_sharded_train_fns
    from deepcgp_tpu_torch.training import trainer
    model, X, Y = mesh_model(torch, label, seed, dev)
    sharding.broadcast_module(model)
    config = trainer.TrainConfig(optimizer=optimizer, lr=0.01, gamma=0.001,
                                 batch_size=TRAIN_BATCH)
    rng = np.random.RandomState(seed + 12)
    batches = [torch.as_tensor(rng.randint(0, MESH_IMAGES, TRAIN_BATCH),
                               device=dev) for _ in range(steps)]
    grads = mesh_grads(torch, mesh, model, config, seed + 1, X[batches[0]],
                       Y[batches[0]])
    ref = trainer.init_state(copy.deepcopy(model), config, seed=seed + 1)
    state = trainer.init_state(model, config, seed=seed + 1)
    want = [float(trainer.train_step(ref, config, X[i], Y[i]))
            for i in batches]
    step_fn, _ = make_sharded_train_fns(mesh, config)
    torch.cuda.synchronize()
    for fn in counters.values():
        fn.launches = 0
    t = time.perf_counter()
    got = [float(step_fn(state, X[i], Y[i])) for i in batches]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t
    return {'elbos': got, 'single_process_elbos': want,
            'max_rel_err': max(abs(g - w) / max(abs(w), 1.0)
                               for g, w in zip(got, want)),
            'grad_rel_err': grads,
            'param_max_rel_err': max(rel(p.detach(), ref.params[k].detach())
                                     for k, p in state.params.items()),
            'launches': {n: fn.launches for n, fn in counters.items()},
            'seconds': seconds}


def mesh_serving(torch, seed: int, dev, counters: dict) -> dict:
    """Predictor(mesh='data=2') against the one-process Predictor."""
    from deepcgp_tpu_torch.serving import Predictor
    model, _, _ = mesh_model(torch, 'flagship', seed, dev)
    rng = np.random.RandomState(seed + 13)
    X = rng.randn(MESH_REQUEST, int(np.prod(IMAGE))).astype(np.float32)
    Y = rng.randint(0, 10, size=(MESH_REQUEST, 1))
    kw = dict(batch_size=TRAIN_BATCH, num_samples=SAMPLES, seed=seed,
              device=dev)
    single = Predictor(model, **kw)
    want = (single.predict_proba(X), single.log_density(X, Y))
    served = Predictor(model, mesh='data=2', **kw)
    for fn in counters.values():
        fn.launches = 0
    t = time.perf_counter()
    got = (served.predict_proba(X), served.log_density(X, Y))
    seconds = time.perf_counter() - t
    return {'shape': list(got[0].shape),
            'probs_max_rel_err': float(np.abs(got[0] - want[0]).max()
                                       / np.abs(want[0]).max()),
            'log_density_max_rel_err': float(np.abs(got[1] - want[1]).max()
                                             / np.abs(want[1]).max()),
            'launches': {n: fn.launches for n, fn in counters.items()},
            'seconds': seconds}


def mesh_child(rank: int, world: int, port: int, seed: int, out: str):
    """A rank of the gloo group on the card: every MESH_CASES case, then
    the served request; its results into ``out/rank<r>.json``."""
    import datetime
    import torch
    torch.set_num_threads(1)
    os.environ.update(MASTER_ADDR='127.0.0.1', MASTER_PORT=str(port),
                      RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank))
    from deepcgp_tpu_torch.parallel import mesh as mesh_lib
    from deepcgp_tpu_torch.parallel import multihost
    dev = multihost.initialize_distributed(
        backend='gloo', timeout=datetime.timedelta(seconds=MESH_TIMEOUT_S))
    counters = kernel_counters()
    try:
        results = {'device': str(dev),
                   'backend': torch.distributed.get_backend()}
        for spec, cases in MESH_CASES:
            mesh = mesh_lib.make_mesh(spec)
            for label, optimizer, steps in cases:
                results[f'{spec} {label} {optimizer}'] = mesh_case(
                    torch, mesh, label, optimizer, steps, seed, dev, counters)
        results['data=2 serving'] = mesh_serving(torch, seed, dev, counters)
        with open(os.path.join(out, f'rank{rank}.json'), 'w') as f:
            json.dump(results, f)
    finally:
        torch.distributed.destroy_process_group()


def mesh_expected(label: str, optimizer: str, steps: int) -> dict:
    """A rank's launches for ``steps`` train_step calls of a case: the
    single-process step's, since each rank runs every kernel of the step
    (on its rows, or replicated)."""
    per = {('flagship', 'Adam'): ADAM_PER_STEP['flagship'],
           ('flagship', 'NatGrad'): NATGRAD_PER_STEP['flagship'],
           ('mnist_conv', 'Adam'): UNFUSED_PER_STEP['mnist_conv'],
           ('fm32', 'Adam'): UNFUSED_PER_STEP['fm32']}[label, optimizer]
    return expected_launches((steps, per))


def mesh_gloo_phase(torch, card: dict, seed: int) -> dict:
    """(b): MESH_WORLD spawned processes on the card over gloo; a child's
    failure, or no result within MESH_TIMEOUT_S, fails the phase (and
    every child is stopped).  Returns rank 0's launches by path."""
    from deepcgp_tpu_torch.parallel.train import free_port, run_processes
    with tempfile.TemporaryDirectory() as out:
        t = time.perf_counter()
        run_processes(mesh_child, MESH_WORLD,
                      (MESH_WORLD, free_port(), seed, out), MESH_TIMEOUT_S)
        wall = time.perf_counter() - t
        ranks = []
        for r in range(MESH_WORLD):
            with open(os.path.join(out, f'rank{r}.json')) as f:
                ranks.append(json.load(f))
    paths = {}
    for spec, cases in MESH_CASES:
        for label, optimizer, steps in cases:
            key = f'{spec} {label} {optimizer}'
            want = mesh_expected(label, optimizer, steps)
            got = [rk[key] for rk in ranks]
            emit({'phase': f'mesh gloo {key}', **card,
                  'processes': MESH_WORLD, 'backend': ranks[0]['backend'],
                  'devices': [rk['device'] for rk in ranks], 'steps': steps,
                  'batch_size': TRAIN_BATCH, 'num_samples': TRAIN_SAMPLES,
                  'launches_per_rank': [g['launches'] for g in got],
                  'max_rel_err': max(g['max_rel_err'] for g in got),
                  'grad_rel_err': {k: max(g['grad_rel_err'][k] for g in got)
                                   for k in got[0]['grad_rel_err']},
                  'param_max_rel_err': max(g['param_max_rel_err']
                                           for g in got),
                  'elbos_rank0': got[0]['elbos'],
                  'single_process_elbos': got[0]['single_process_elbos'],
                  'seconds_per_rank': [g['seconds'] for g in got],
                  'group_wall_seconds': wall,
                  'tolerance': f'each step\'s ELBO within {MESH_RTOL} of '
                               'max(|ELBO|, 1) of the one-process step on '
                               'the card; at the start every leaf\'s '
                               'gradient, summed over the data group, '
                               f'within {MESH_GRAD_RTOL} of its max |.| of '
                               'the one-process gradient; parameters read, '
                               'not held',
                  'note': 'two processes share one H100: no speed-up is '
                          'timed'})
            for r, g in enumerate(got):
                check(g['max_rel_err'] <= MESH_RTOL,
                      f'mesh gloo {key} rank {r}: ELBOs {g["elbos"]} vs '
                      f'{g["single_process_elbos"]}')
                check(max(g['grad_rel_err'].values()) <= MESH_GRAD_RTOL,
                      f'mesh gloo {key} rank {r}: gradients '
                      f'{g["grad_rel_err"]}')
                check(g['launches'] == want,
                      f'mesh gloo {key} rank {r}: launches {g["launches"]}, '
                      f'expected {want}')
            path = f'mesh_gloo_{spec.split("=")[0]}_{label}_{optimizer}'
            paths[path.lower()] = got[0]['launches']
    served = [rk['data=2 serving'] for rk in ranks]
    emit({'phase': 'mesh gloo data=2 serving', **card,
          'entry': "Predictor(mesh='data=2')", 'rows': MESH_REQUEST,
          'batch_size': TRAIN_BATCH, 'num_samples': SAMPLES,
          'per_rank': served, 'group_wall_seconds': wall,
          'tolerance': 'probabilities and log-densities within 1e-5 of '
                       'max|.| of the one-process Predictor on the card'})
    for r, g in enumerate(served):
        check(g['shape'] == [MESH_REQUEST, 10]
              and g['probs_max_rel_err'] <= 1e-5
              and g['log_density_max_rel_err'] <= 1e-5,
              f'mesh gloo serving rank {r}: {g}')
        check(all(g['launches'][k] > 0 for k in ('chol_inv_base',
                                                  'tri_inv_base',
                                                  'conv_rbf_cross')),
              f'mesh gloo serving rank {r}: launches {g["launches"]}')
    paths['mesh_gloo_serving'] = served[0]['launches']
    return paths


def mesh_nccl_cli(torch, card: dict, root: str, reset_counts,
                  read_counts) -> dict:
    """(a): ``cifar.main`` on MESH_CLI, plain and as a one-rank NCCL group;
    rows and launches equal.  Returns the mesh run's launches."""
    import torch.distributed as dist
    from deepcgp_tpu_torch import cifar
    from deepcgp_tpu_torch.parallel.train import free_port
    runs = {}
    for label, extra in (('plain', []),
                         ('nccl', ['--mesh', 'data=1', '--distributed'])):
        argv = MESH_CLI + ['--log-dir', os.path.join(root, label), *extra]
        env = ({'MASTER_ADDR': '127.0.0.1', 'MASTER_PORT': str(free_port()),
                'RANK': '0', 'WORLD_SIZE': '1', 'LOCAL_RANK': '0'}
               if extra else {})
        saved = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        reset_counts()
        try:
            exp, _, _, seconds = drive_cli(torch, lambda: cifar.main(argv),
                                           read_counts)
            launches = read_counts()
            backend = dist.get_backend() if dist.is_initialized() else None
            mesh = None if exp.mesh is None else exp.mesh.shape
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        _, rows = log_rows(os.path.join(root, label, 'mesh'))
        runs[label] = dict(rows=rows, launches=launches, seconds=seconds,
                           backend=backend, mesh=mesh)
        del exp
    plain, nccl = runs['plain'], runs['nccl']
    exact = ('global_step', 'lr', 'test_accuracy')
    rows_equal = (len(plain['rows']) == len(nccl['rows']) == 3 and all(
        a[c] == b[c] for a, b in zip(plain['rows'], nccl['rows'])
        for c in exact))
    elbo_err = max(abs(float(a['train_elbo']) - float(b['train_elbo']))
                   / abs(float(a['train_elbo']))
                   for a, b in zip(plain['rows'], nccl['rows']))
    emit({'phase': 'mesh nccl cli', **card, 'entry': 'cifar.main',
          'argv_extra': ['--mesh', 'data=1', '--distributed'],
          'backend': nccl['backend'], 'mesh': nccl['mesh'],
          'rows': {'plain': plain['rows'], 'nccl': nccl['rows']},
          'train_elbo_max_rel_err': elbo_err,
          'train_elbo_bit_equal': elbo_err == 0.0,
          'launches': {'plain': plain['launches'], 'nccl': nccl['launches']},
          'seconds': {'plain': plain['seconds'], 'nccl': nccl['seconds']},
          'tolerance': 'global_step, lr and test_accuracy equal; train_elbo '
                       'within 1e-6 relative; launches equal'})
    check(nccl['backend'] == 'nccl' and nccl['mesh'] == {'data': 1,
                                                         'model': 1},
          f'mesh nccl cli: backend {nccl["backend"]}, mesh {nccl["mesh"]}')
    check(rows_equal and elbo_err <= 1e-6,
          f'mesh nccl cli: rows {plain["rows"]} vs {nccl["rows"]}')
    check(nccl['launches'] == plain['launches']
          and all(nccl['launches'][k] > 0 for k in COUNTERS[:5]
                  if k != 'chol_inv_base_upper'),
          f'mesh nccl cli: launches {nccl["launches"]} vs plain '
          f'{plain["launches"]}')
    return nccl['launches']


def mesh_phases(torch, card: dict, seed: int, reset_counts,
                read_counts) -> dict:
    """(a) and (b) above.  Returns each path's launches."""
    with tempfile.TemporaryDirectory() as empty, \
            tempfile.TemporaryDirectory() as root, data_dir_set(empty):
        paths = {'mesh_nccl_cli': mesh_nccl_cli(
            torch, card, root, reset_counts, read_counts)}
    paths.update(mesh_gloo_phase(torch, card, seed))
    return paths


# -- the compiled chunk: run_chunk, the eval and the Predictor as graphs --
# Each training path (every optimizer, every route) from one snapshot: a graphed chunk (its first step
# eager, then the capture, then replays), an eager chunk and a chunk of
# replays alone, each from the same restored state and generator state,
# gated bit-equal in the ELBO trace, every tensor of the state and the
# launches.  Then eager and graphed windows in turns (E G E G) on four
# paths.  GRAPH_AB_STEPS steps a chunk after GRAPH_AB_WARM eager steps;
# windows of GRAPH_WINDOW_SECONDS; GRAPH_PROFILE_STEPS steps profiled.
GRAPH_AB_STEPS, GRAPH_AB_WARM = 6, 2
# The chunks of a path's bit-equality, in order, each from one snapshot.
GRAPH_AB_MODES = ('graphed', 'eager', 'replayed', 'eager again')
GRAPH_WINDOW_SECONDS, GRAPH_PROFILE_STEPS = 1.0, 16
DEEP3 = dict(M='384,384,384', feature_maps='10,10', filter_sizes='5,3,3',
             strides='2,1,1', base_kernel='rbf', last_kernel='conv',
             white=False, identity_mean=True)
# cli cifar acos identity's model: the flagship's geometry, an order-0
# ArcCosine hidden layer and the identity mean.
ACOS_FLAGS = dict(FLAGSHIP, base_kernel='acos', identity_mean=True)
# (label, flags, image, batch, optimizer, per-step launches, per-chunk
# launches, parameters loaded into the build).
GRAPH_PATHS = (
    ('flagship adam', FLAGSHIP, IMAGE, TRAIN_BATCH, 'Adam',
     ADAM_PER_STEP['flagship'], {}, None),
    ('flagship sgd', FLAGSHIP, IMAGE, TRAIN_BATCH, 'SGD',
     ADAM_PER_STEP['flagship'], {}, None),
    ('flagship natgrad', FLAGSHIP, IMAGE, TRAIN_BATCH, 'NatGrad',
     NATGRAD_PER_STEP['flagship'], NATGRAD_PER_CHUNK['flagship'], None),
    ('m1024 natgrad', M1024, M1024_IMAGE, M1024_BATCH, 'NatGrad',
     NATGRAD_PER_STEP['m1024'], NATGRAD_PER_CHUNK['m1024'], None),
    ('mnist_conv adam', MNIST_CONV, MNIST_IMAGE, TRAIN_BATCH, 'Adam',
     UNFUSED_PER_STEP['mnist_conv'], {}, None),
    ('fm32 adam', FM32, IMAGE, TRAIN_BATCH, 'Adam', UNFUSED_PER_STEP['fm32'],
     {}, {1: {'base_kernel/lengthscales': LENGTHSCALES[1]}}),
    ('deep3 adam', DEEP3, IMAGE, TRAIN_BATCH, 'Adam', ADAM_PER_STEP['deep3'],
     {}, None),
    # The paths whose bits show the order of K5's gram row sums (ROADMAP
    # C7): cli cifar acos identity's model and the partial view (a builder
    # of its own).
    ('acos identity natgrad', ACOS_FLAGS, IMAGE, TRAIN_BATCH, 'NatGrad',
     NATGRAD_PER_STEP['flagship'], NATGRAD_PER_CHUNK['flagship'], None),
    ('acos identity adam', ACOS_FLAGS, IMAGE, TRAIN_BATCH, 'Adam',
     ADAM_PER_STEP['flagship'], {}, None),
    ('partial view adam', 'partial view', PV_IMAGE, TRAIN_BATCH, 'Adam',
     PV_PER_STEP, {}, None))
# Their data come from a generator of their own, so that every earlier
# check keeps its inputs.
GRAPH_C7 = ('acos identity natgrad', 'acos identity adam', 'partial view adam')
GRAPH_TIMED = ('flagship adam', 'flagship natgrad', 'm1024 natgrad')


def graph_build(torch, label, flags, image, loaded, seed, rng, dev):
    from deepcgp_tpu_torch.models import builder as mbuilder
    X, Y = learnable_data(rng, image)
    if flags == 'partial view':
        model = partial_view_model(torch, X, seed, dev)
    else:
        model = mbuilder.build_model(
            types.SimpleNamespace(**flags, num_samples=TRAIN_SAMPLES), image,
            loaded, images=X, generator=torch.Generator().manual_seed(seed),
            device=dev)
    Xd = torch.as_tensor(X.reshape(len(X), -1), device=dev)
    Yd = torch.as_tensor(Y, device=dev)
    return model, Xd, Yd


def graph_ab_chunk(torch, label, model, optimizer, batch, Xd, Yd, per_step,
                   per_chunk, seed, card, reset_counts, read_counts):
    """The bit-equality of one training path: from one snapshot, chunks
    run graphed (capturing), eager, graphed again (replays only) and eager
    again, each held against the first eager chunk.  Returns (state,
    config, the replayed chunk's launches)."""
    from deepcgp_tpu_torch.training import trainer
    # Plain SGD steps on the raw gradients: lr 1e-4, as the CPU tests take.
    config = trainer.TrainConfig(optimizer=optimizer, batch_size=batch,
                                 lr=1e-4 if optimizer == 'SGD' else 0.01,
                                 gamma=0.001)
    state = trainer.init_state(model, config, seed=seed)
    trainer.run_chunk(state, config, Xd, Yd, GRAPH_AB_WARM, graphed=False)
    snap = state_values(state)
    runs = {}
    for mode in GRAPH_AB_MODES:
        restore_values(torch, state, snap)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t = time.perf_counter()
        trace = trainer.run_chunk(state, config, Xd, Yd, GRAPH_AB_STEPS,
                                  graphed=mode in ('graphed', 'replayed'))
        torch.cuda.synchronize()
        runs[mode] = {'seconds': time.perf_counter() - t,
                      'trace': trace.clone(), 'state': state_values(state),
                      'launches': read_counts(),
                      'peak': torch.cuda.max_memory_allocated()}
    expected = expected_launches((GRAPH_AB_STEPS, per_step), (1, per_chunk))
    eager = runs['eager']
    diffs = {mode: {'trace': bit_diff(torch, {'trace': runs[mode]['trace']},
                                      {'trace': eager['trace']}),
                    'state': bit_diff(torch, runs[mode]['state'],
                                      eager['state'])}
             for mode in GRAPH_AB_MODES if mode != 'eager'}
    same = {mode: not d['trace'] and not d['state']
            for mode, d in diffs.items()}
    cache = state.graphs
    emit({'phase': f'graph bit-equality {label}', **card,
          'optimizer': optimizer, 'batch_size': batch,
          'num_samples': model.num_samples, 'warm_eager_steps': GRAPH_AB_WARM,
          'chunk_steps': GRAPH_AB_STEPS, 'order': list(runs),
          'bit_equal': same, 'not_bit_equal': diffs,
          'launches': {mode: r['launches'] for mode, r in runs.items()},
          'expected_launches': expected,
          'seconds': {mode: r['seconds'] for mode, r in runs.items()},
          'max_memory_allocated_bytes': {mode: r['peak']
                                         for mode, r in runs.items()},
          'captures': cache.captures, 'capture_seconds': cache.capture_seconds,
          'elbo_trace': eager['trace'].tolist()})
    check(all(same.values()), f'graph {label}: graphed and eager chunks '
          f'differ: {diffs}')
    check(all(r['launches'] == expected for r in runs.values()),
          f'graph {label}: launches {[r["launches"] for r in runs.values()]},'
          f' expected {expected}')
    check(finite(torch, eager['trace']), f'graph {label}: an ELBO is not finite')
    return state, config, runs['replayed']['launches']


def graph_eval_and_serving(torch, model, seed, rng, dev, card, reset_counts,
                           read_counts) -> dict:
    """The flagship's eval (1000 rows: 31 batches of 32 and one of 8, two
    graphs) and Predictor (300 and 200 rows, padded batches of BATCH),
    eager against graphed, bit for bit, with their launches."""
    from deepcgp_tpu_torch.serving import Predictor
    from deepcgp_tpu_torch.training import trainer
    X = rng.randn(1000, *IMAGE).astype(np.float32)
    Y = rng.randint(0, 10, size=(1000, 1))
    Xd = torch.as_tensor(X.reshape(1000, -1), device=dev)
    Yd = torch.as_tensor(Y, device=dev)
    evals = {}
    for mode in ('graphed', 'eager', 'replayed'):
        reset_counts()
        probs = trainer.predict_probs(model, Xd, seed=seed,
                                      batch_size=EVAL_BATCH,
                                      graphed=mode != 'eager')
        acc = trainer.accuracy(model, Xd, Yd, seed=seed,
                               batch_size=EVAL_BATCH,
                               graphed=mode != 'eager')
        evals[mode] = (probs, acc, read_counts())
    batches = -(-1000 // EVAL_BATCH)
    expected = expected_launches((2 * batches, EVAL_PER_BATCH['flagship']))
    eval_same = {m: bool(torch.equal(evals[m][0], evals['eager'][0]))
                 and evals[m][1] == evals['eager'][1]
                 for m in ('graphed', 'replayed')}
    served, launches = {}, {}
    preds = {'eager': Predictor(model, batch_size=BATCH, num_samples=SAMPLES,
                                seed=seed, graphed=False),
             'graphed': Predictor(model, batch_size=BATCH,
                                  num_samples=SAMPLES, seed=seed)}
    for mode, pred in preds.items():
        reset_counts()
        served[mode] = [pred.predict_proba(X[:300]), pred.predict_proba(X[:300]),
                        pred.log_density(X[:200], Y[:200])]
        launches[mode] = read_counts()
    serve_batches = 2 * -(-300 // BATCH) + -(-200 // BATCH)
    serve_expected = launches_of(chol_inv_base=serve_batches,
                                 tri_inv_base=serve_batches,
                                 conv_rbf_cross=serve_batches)
    serve_same = all(np.array_equal(a, b) for a, b in
                     zip(served['graphed'], served['eager']))
    emit({'phase': 'graph bit-equality eval and serving', **card,
          'eval': {'rows': 1000, 'batch_size': EVAL_BATCH,
                   'bit_equal': eval_same,
                   'accuracy': {m: e[1] for m, e in evals.items()},
                   'launches': {m: e[2] for m, e in evals.items()},
                   'expected_launches': expected},
          'serving': {'requests': ['predict_proba 300', 'predict_proba 300',
                                   'log_density 200'],
                      'batch_size': BATCH, 'num_samples': SAMPLES,
                      'bit_equal': serve_same, 'launches': launches,
                      'expected_launches': serve_expected,
                      'captures': preds['graphed']._graphs.captures,
                      'capture_seconds':
                          preds['graphed']._graphs.capture_seconds}})
    check(all(eval_same.values()), f'graph eval: eager and graphed differ '
          f'{eval_same}')
    check(all(e[2] == expected for e in evals.values()),
          f'graph eval launches {[e[2] for e in evals.values()]}, expected '
          f'{expected}')
    check(serve_same, 'graph serving: eager and graphed answers differ')
    check(all(n == serve_expected for n in launches.values()),
          f'graph serving launches {launches}, expected {serve_expected}')
    return launches['graphed']


def graph_windows(torch, fn, steps_each: int, rounds=('eager', 'graphed') * 2):
    """Windows of GRAPH_WINDOW_SECONDS in turns: fn(mode) runs one chunk
    or request of ``steps_each`` steps or images and synchronizes.
    Returns each window's mode, count, seconds, rate and peak memory."""
    out = []
    for mode in rounds:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        n, t = 0, time.perf_counter()
        while time.perf_counter() - t < GRAPH_WINDOW_SECONDS:
            fn(mode)
            n += steps_each
        seconds = time.perf_counter() - t
        out.append({'mode': mode, 'count': n, 'seconds': seconds,
                    'rate': n / seconds,
                    'max_memory_allocated_bytes':
                        torch.cuda.max_memory_allocated(),
                    'memory_reserved_bytes': torch.cuda.memory_reserved()})
    return out


def graph_timing_line(label, unit, windows, profiles, capture, card):
    rates = {m: [w['rate'] for w in windows if w['mode'] == m]
             for m in ('eager', 'graphed')}
    emit({'phase': f'graph timing {label}', **card, 'unit': unit,
          'order': [w['mode'] for w in windows],
          'window_seconds': GRAPH_WINDOW_SECONDS, 'windows': windows,
          f'{unit}_per_s': rates,
          'graphed_over_eager': min(rates['graphed']) / max(rates['eager']),
          'profile_steps': GRAPH_PROFILE_STEPS, **capture,
          'device_busy_share': {m: p[1] / p[0] for m, p in profiles.items()},
          'profiles': {m: {'wall_ms': p[0], 'device_busy_ms': p[1],
                           'profile_rounds': p[3], 'top_device_ms': p[2]}
                       for m, p in profiles.items()}})


def graph_phases(torch, dev, card: dict, seed: int, reset_counts,
                 read_counts) -> dict:
    """The compiled chunk: every training path's graphed chunk bit-equal
    to its eager chunk, the eval and the Predictor likewise, then eager
    and graphed windows in turns with the graphed and eager profiles'
    busy shares, capture seconds and peak memory.  Returns each path's
    launches in its chunk of replays alone."""
    from deepcgp_tpu_torch.serving import Predictor
    from deepcgp_tpu_torch.training import trainer
    rng = np.random.RandomState(seed + 6)
    c7_rng = np.random.RandomState(seed + 7)
    launches, timed = {}, {}
    for label, flags, image, batch, optimizer, per_step, per_chunk, loaded \
            in GRAPH_PATHS:
        model, Xd, Yd = graph_build(torch, label, flags, image, loaded, seed,
                                    c7_rng if label in GRAPH_C7 else rng, dev)
        state, config, launches[f'graph {label}'] = graph_ab_chunk(
            torch, label, model, optimizer, batch, Xd, Yd, per_step,
            per_chunk, seed, card, reset_counts, read_counts)
        if label in GRAPH_TIMED:
            timed[label] = (state, config, Xd, Yd)
        else:
            del state, model
    launches['graph eval and serving'] = graph_eval_and_serving(
        torch, timed['flagship adam'][0].model, seed, rng, dev, card,
        reset_counts, read_counts)

    for label, (state, config, Xd, Yd) in timed.items():
        chunk = TRAIN_CHUNK if label.startswith('flagship') else 10
        windows = graph_windows(torch, lambda mode: (trainer.run_chunk(
            state, config, Xd, Yd, chunk, graphed=mode == 'graphed'),
            torch.cuda.synchronize()), chunk)
        profiles = {mode: profile_device(torch, lambda: trainer.run_chunk(
            state, config, Xd, Yd, GRAPH_PROFILE_STEPS,
            graphed=mode == 'graphed'), reset_counts, read_counts)
            for mode in ('eager', 'graphed')}
        graph_timing_line(label, 'steps', windows, profiles, {
            'captures': state.graphs.captures,
            'capture_seconds': state.graphs.capture_seconds,
            'batch_size': config.batch_size, 'chunk_steps': chunk}, card)
    model = timed['flagship adam'][0].model
    del timed
    X = rng.randn(16 * BATCH, *IMAGE).astype(np.float32)
    preds = {'eager': Predictor(model, batch_size=BATCH, num_samples=SAMPLES,
                                seed=seed, graphed=False),
             'graphed': Predictor(model, batch_size=BATCH,
                                  num_samples=SAMPLES, seed=seed)}
    served = [0]

    def request(mode):
        r = served[0] % 16
        served[0] += 1
        preds[mode].predict_proba(X[r * BATCH:(r + 1) * BATCH])

    for mode in preds:
        request(mode)
    windows = graph_windows(torch, request, BATCH)
    profiles = {mode: profile_device(torch, lambda: [
        request(mode) for _ in range(GRAPH_PROFILE_STEPS)], reset_counts,
        read_counts) for mode in ('eager', 'graphed')}
    graph_timing_line('flagship serving', 'images', windows, profiles, {
        'captures': preds['graphed']._graphs.captures,
        'capture_seconds': preds['graphed']._graphs.capture_seconds,
        'batch_size': BATCH, 'num_samples': SAMPLES}, card)
    return launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--seed', type=int, default=0)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device; this script runs only on the card',
              file=sys.stderr)
        return 2
    from deepcgp_tpu_torch.models.base_kernels import RBF
    from deepcgp_tpu_torch.ops import (cuda_build, cuda_cross, cuda_linalg,
                                       cuda_patches)
    from deepcgp_tpu_torch.ops.linalg import add_jitter
    from deepcgp_tpu_torch.ops.patches import extract_patches
    from deepcgp_tpu_torch.serving import Predictor

    counters = kernel_counters()
    check(tuple(counters) == COUNTERS, 'the counters and COUNTERS differ')
    # Launches of each main path, counted from 0 just before it is driven.
    path_launches = {}

    def reset_counts():
        for fn in counters.values():
            fn.launches = 0

    def read_counts() -> dict:
        return {name: fn.launches for name, fn in counters.items()}

    dev = torch.device('cuda')
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    card = {'card': smi}
    emit({'phase': 'device', 'nvidia_smi': smi,
          'name': torch.cuda.get_device_name(0),
          'count': torch.cuda.device_count(), 'torch': torch.__version__,
          'cuda': torch.version.cuda, 'python': sys.version.split()[0]})

    # -- build: one nvcc per source, all started together ------------------
    t0 = time.perf_counter()
    report = cuda_build.build()
    emit({'phase': 'build', 'seconds': time.perf_counter() - t0,
          'arch': 'sm_90a', 'libraries': report})
    # -- the native host data path: g++, then each function vs numpy -------
    native_phase(card, args.seed)

    rng = np.random.RandomState(args.seed)
    # The inputs of the checks added with the NatGrad solve's K1/K3 shapes,
    # K5's L = 300 and 400 rows and the M = 1088 step's noise come from a
    # generator of their own, so that every other check keeps the inputs
    # that the seed's stream gave it before they were added.
    aux = np.random.RandomState(args.seed + 1)
    # And those of K2's whole-factor shapes and the solve beyond M = 1088.
    k2_rng = np.random.RandomState(args.seed + 2)
    # And those of the depth-3 shapes of K1/K3, K2, K6 and K7.
    deep = np.random.RandomState(args.seed + 5)
    rbfs = [RBF.create(5.0, ls, device=dev) for ls in LENGTHSCALES]
    snapshot = flagship_snapshot(args.seed)
    Zs = [torch.as_tensor(snapshot[f'DGP/layers/{i}/feature/Z'],
                          dtype=torch.float32, device=dev) for i in (0, 1)]
    # The flagship's three Kuu grams: layer 0 (Z and its KL anchor), layer 1.
    Kuu = torch.stack([add_jitter(rbfs[0].K(Zs[0])),
                       add_jitter(rbfs[0].K(Zs[0])),
                       add_jitter(rbfs[1].K(Zs[1]))])
    kernels = []

    # -- K1 and K3: the blocked factor and the inverse, two launches --------
    kernels += k1_k3_phases(torch, dev, card, rng, aux, deep, Kuu)
    # The route on the flagship's own Kuu grams, against the library.
    LB, LiB = cuda_linalg.chol_inv_batched(Kuu)
    torch.cuda.synchronize()
    Lref = torch.linalg.cholesky(Kuu)
    Liref = torch.linalg.solve_triangular(
        Lref, torch.eye(384, device=dev).expand(3, 384, 384), upper=False)
    dB, dBi = rel(LB, Lref), rel(LiB, Liref)
    reconB = float(torch.linalg.matrix_norm(LB @ LB.transpose(1, 2) - Kuu).max()
                   / torch.linalg.matrix_norm(Kuu).min())
    check(dB <= 2e-5 and dBi <= 6e-5 and reconB <= 1e-5,
          f'K1/K3 route [3,384,384] flagship Kuu: dL {dB}, dLinv {dBi}, '
          f'recon {reconB}')
    emit({'phase': 'K1/K3 route flagship Kuu', **card, 'shape': [3, 384, 384],
          'rel_err_L_vs_library': dB, 'rel_err_Linv_vs_library': dBi,
          'recon_rel_err': reconB,
          'tolerance': 'relative to max|.| of torch.linalg.cholesky + '
                       'solve_triangular: dL <= 2e-5, dLinv <= 6e-5; '
                       'reconstruction <= 1e-5'})

    # -- K2, the whole upper factor, and the NatGrad solve's routes ---------
    kernels += k2_phases(torch, dev, card, rng, k2_rng, deep)
    driver_phases(torch, dev, card, rng, k2_rng)

    # -- K4: fused extraction -> RBF cross-covariance ------------------------
    var = rbfs[1].variance
    gamma = -0.5 / rbfs[1].lengthscales.square()
    geoms = [  # (N, H, W, C, f, s, M, with_kdiag)
        (BATCH * SAMPLES, 10, 10, 10, 5, 1, 384, True),   # flagship last layer
        (256, 15, 13, 10, 3, 2, 200, True),
        (256, 15, 13, 10, 3, 2, 200, False),
        # The training batch, and L = 300 and 400 (BASELINE.md's CIFAR
        # fm16): the shapes K5 is held at, forward.
        (TRAIN_BATCH * TRAIN_SAMPLES, 10, 10, 10, 5, 1, 384, True),
        (TRAIN_BATCH * TRAIN_SAMPLES, 10, 10, 12, 5, 1, 384, True),
        (TRAIN_BATCH * TRAIN_SAMPLES, 10, 10, 16, 5, 1, 384, True),
        # Past the fused route but within K4's envelope: the MNIST
        # ConvKernel geometry (P = 576), one image a block in row tiles.
        (TRAIN_BATCH, 28, 28, 1, 5, 1, 1024, True),
    ]
    # The rows added with the tensor-core K4 draw from a generator of their
    # own, so that every earlier check keeps its inputs.
    k4rng = np.random.RandomState(args.seed + 2)
    check(not torch.backends.cuda.matmul.allow_tf32,
          'float32 products would run in TF32')
    k4 = None
    for i, (N, H, W, C, f, s, M, kd_on) in enumerate(geoms):
        g = rng if i < 3 else k4rng
        img = torch.as_tensor(g.randn(N, H, W, C), dtype=torch.float32,
                              device=dev)
        Z = torch.as_tensor(patches_of(g, g.randn(32, H, W, C), M, f),
                            dtype=torch.float32, device=dev)
        Pn = ((H - f) // s + 1) * ((W - f) // s + 1)
        w = torch.as_tensor(g.rand(Pn) + 0.5, dtype=torch.float32, device=dev)
        a = (img, Z, var, gamma, w / Pn, w, f, s, 1, kd_on)
        kzx, kd = cuda_cross.conv_rbf_cross(*a)
        torch.cuda.synchronize()
        kzx_p, kd_p = cuda_cross.conv_rbf_cross_plain(*a)
        kzx_64, kd_64 = cuda_cross.conv_rbf_cross_plain(
            *(t.double() for t in a[:6]), *a[6:])
        atol = 1e-6 * float(var)
        ok = (bool(torch.allclose(kzx, kzx_p, rtol=1e-5, atol=atol))
              and bool(torch.allclose(kd, kd_p, rtol=1e-5, atol=atol)))
        err = float(max((kzx - kzx_p).abs().max(), (kd - kd_p).abs().max()))
        L4 = f * f * C
        # Cross products 2NPML; the symmetric Kdiag gram NP(P+1)L.
        ops = 2 * N * Pn * M * L4 + (N * Pn * (Pn + 1) * L4 if kd_on else 0)
        ms = kernel_ms(torch, lambda: cuda_cross.conv_rbf_cross(*a),
                       'conv_rbf_cross_kernel')
        line = {'phase': 'K4 conv_rbf_cross', **card,
                'geometry': dict(N=N, H=H, W=W, C=C, f=f, stride=s, M=M,
                                 with_kdiag=kd_on),
                'max_abs_err': err, 'kzx_max': float(kzx_p.abs().max()),
                'tolerance': f'rtol 1e-5, atol {atol}',
                'max_abs_dist_f64': {
                    'kernel': float(max((kzx.double() - kzx_64).abs().max(),
                                        (kd.double() - kd_64).abs().max())),
                    'plain': float(max((kzx_p.double() - kzx_64).abs().max(),
                                       (kd_p.double() - kd_64).abs().max()))},
                'ms': ms, 'achieved_tflops': ops / ms / 1e9,
                'tc_bound_ms': 3 * ops / TF32_OPS_PER_S * 1e3}
        check(ok, f'K4 {line["geometry"]}: max abs err {err}')
        if k4 is None:
            nbytes = 4 * (N * H * W * C + M * L4 + 2 * Pn + 2 + N * M + N)
            k4_bound, k4_by = bound_ms(nbytes, ops)
            call = cuda_ms(torch, lambda: cuda_cross.conv_rbf_cross(*a), 50)
            plain = cuda_ms(torch, lambda: cuda_cross.conv_rbf_cross_plain(*a), 10)
            # cuBLAS's float32 product alone (TF32 off), on patches
            # extracted beforehand: a yardstick of the GEMM core only.
            flat = extract_patches(img, f, s, 1).reshape(N * Pn, L4)
            product = cuda_ms(torch, lambda: flat @ Z.T, 50)
            line.update(call_ms=call, plain_ms=plain, library_ms=None,
                        library_note='no single PyTorch call computes the '
                        'weighted patch-sum RBF cross-covariance',
                        product_library_ms=product,
                        product_library_note='torch.matmul [N P, L] x [L, M] '
                        'in float32, TF32 off, on pre-extracted patches',
                        bound_ms=k4_bound, bound_by=k4_by,
                        target_ms=0.12, gflop=ops / 1e9,
                        fwd_grid=list(cuda_cross.fwd_grid(N, Pn, M, kd_on)),
                        dynamic_smem_bytes=cuda_cross.FWD_SMEM,
                        ptxas=report.get('conv_rbf_cross', {}).get('ptxas'),
                        trace_cycles=k4_trace(torch, *a))
            k4 = {'name': 'conv_rbf_cross', 'route': 'cuda',
                  'source': 'deepcgp_tpu_torch/csrc/conv_rbf_cross.cu',
                  'replaces': 'deepcgp_tpu/ops/pallas_cross.py:165',
                  'max_abs_err': err, 'ms': ms, 'plain_ms': plain,
                  'bound_ms': k4_bound, 'bound_by': k4_by, 'library_ms': None,
                  'shape': f'N={N} {H}x{W}x{C} f={f} M={M}'}
        emit(line)
    kernels.append(k4)

    # -- K5: backward of the fused cross-covariance --------------------------
    bwd_geoms = [  # (N, H, W, C, f, s, M, with_kdiag)
        (TRAIN_BATCH * TRAIN_SAMPLES, 10, 10, 10, 5, 1, 384, True),  # training
        (256, 15, 13, 10, 3, 2, 200, True),
        (256, 15, 13, 10, 3, 2, 200, False),
        # The widest fused rows: L = 300 and L = 400 (BASELINE.md's CIFAR
        # fm16), three and four 128-column tiles of L.
        (TRAIN_BATCH * TRAIN_SAMPLES, 10, 10, 12, 5, 1, 384, True),
        (TRAIN_BATCH * TRAIN_SAMPLES, 10, 10, 16, 5, 1, 384, True),
    ]
    grad_names = ('images', 'Z', 'variance', 'gamma', 'u', 'wkd')
    k5 = None
    for i, (N, H, W, C, f, s, M, kd_on) in enumerate(bwd_geoms):
        g = rng if i < 3 else aux           # the wide rows: see aux in main
        img = torch.as_tensor(g.randn(N, H, W, C), dtype=torch.float32,
                              device=dev)
        Z = torch.as_tensor(patches_of(g, g.randn(32, H, W, C), M, f),
                            dtype=torch.float32, device=dev)
        Pn = ((H - f) // s + 1) * ((W - f) // s + 1)
        L5 = f * f * C
        w = torch.as_tensor(g.rand(Pn) + 0.5, dtype=torch.float32, device=dev)
        dkzx = torch.as_tensor(g.randn(N, M), dtype=torch.float32, device=dev)
        dkd = torch.as_tensor(g.randn(N), dtype=torch.float32, device=dev)
        a = (img, Z, var, gamma, w / Pn, w, f, s, 1, kd_on, dkzx, dkd)
        out = cuda_cross.conv_rbf_cross_bwd(*a)
        torch.cuda.synchronize()
        again = cuda_cross.conv_rbf_cross_bwd(*a)
        ref = cuda_cross.conv_rbf_cross_bwd_plain(*a)
        ref64 = cuda_cross.conv_rbf_cross_bwd_plain(
            *(t.double() for t in a[:6]), *a[6:10],
            *(t.double() for t in a[10:]))
        errs = {n: rel(o, r) for n, o, r in zip(grad_names, out, ref)}
        line = {'phase': 'K5 conv_rbf_cross_bwd', **card,
                'geometry': dict(N=N, H=H, W=W, C=C, f=f, stride=s, M=M,
                                 with_kdiag=kd_on),
                'rel_err': errs,
                'tolerance': 'each gradient within 1e-3 of its largest '
                             'magnitude: float32 sums of up to N P M terms '
                             'in other orders',
                'rel_dist_f64': {
                    'kernel': {n: rel(o.double(), r)
                               for n, o, r in zip(grad_names, out, ref64)},
                    'plain': {n: rel(o.double(), r)
                              for n, o, r in zip(grad_names, ref, ref64)}},
                'dz_bit_equal_run_to_run': bool(torch.equal(out[1], again[1])),
                'dimg_bit_equal_run_to_run': bool(torch.equal(out[0], again[0]))}
        check(max(errs.values()) <= 1e-3,
              f'K5 {line["geometry"]}: relative errors {errs}')
        fn = lambda: cuda_cross.conv_rbf_cross_bwd(*a)  # noqa: E731
        ms_image = kernel_ms(torch, fn, 'bwd_image_kernel')
        ms_z = kernel_ms(torch, fn, 'bwd_z_kernel')
        # The Z side's T^T patches: 2NPML products, reading T [N P, Mpad].
        ops_z = 2 * N * Pn * M * L5
        Mpad = -(-M // 128) * 128
        z_bound, z_by = bound_ms(4 * (N * Pn * Mpad + N * H * W * C
                                      + 2 * M * L5), ops_z)
        line.update(ms_image_side=ms_image, ms_z_side=ms_z, z_side_ms=ms_z,
                    z_side_bound_ms=z_bound, z_side_bound_by=z_by,
                    z_side_tc_bound_ms=3 * ops_z / TF32_OPS_PER_S * 1e3,
                    z_side_bytes_ms=4 * N * Pn * Mpad / HBM_BYTES_PER_S * 1e3,
                    z_side_cluster=cuda_cross.z_side_cluster(
                        N, Pn, M, L5, torch.cuda.get_device_properties(0)
                        .multi_processor_count),
                    z_side_tflops=ops_z / ms_z / 1e9)
        if k5 is None:
            # Recomputed cross products, T Z and T^T patches: 3 x 2NPML;
            # the symmetric Kdiag gram NP(P+1)L and its product 2NP^2L.
            ops = 3 * 2 * N * Pn * M * L5
            if kd_on:
                ops += N * Pn * (Pn + 1) * L5 + 2 * N * Pn * Pn * L5
            nbytes = 4 * (2 * N * H * W * C + 2 * M * L5 + N * M + N
                          + 4 * Pn + 4)
            k5_bound, k5_by = bound_ms(nbytes, ops)
            ms = ms_image + ms_z
            call = cuda_ms(torch, fn, 50)
            plain = cuda_ms(
                torch, lambda: cuda_cross.conv_rbf_cross_bwd_plain(*a), 10)
            err = max(float((o - r).abs().max()) for o, r in zip(out, ref))
            # cuBLAS's float32 T^T patches alone (TF32 off), on patches
            # extracted beforehand: a yardstick of the Z side's GEMM core.
            flat = extract_patches(img, f, s, 1).reshape(N * Pn, L5)
            Tm = torch.randn(N * Pn, Mpad, device=dev)
            product = cuda_ms(torch, lambda: Tm.T @ flat, 50)
            # Image side: the cross products and T Z (2 x 2NPML) and the
            # gram; Z side: T^T patches (2NPML).
            clusters = cuda_build.function(
                'conv_rbf_cross_bwd', 'conv_rbf_cross_bwd_image_max_clusters',
                [ctypes.c_int] * 3)(Pn, L5, Mpad)
            S5 = cuda_cross.bwd_cluster(M)
            threads = 64 * (-(-Pn // 8))
            line.update(ms=ms, launches_per_call=2, call_ms=call,
                        plain_ms=plain, library_ms=None,
                        library_note='none: no one PyTorch call computes it',
                        bound_ms=k5_bound, bound_by=k5_by, gflop=ops / 1e9,
                        achieved_tflops=ops / ms / 1e9,
                        image_side_tflops=(ops - ops_z) / ms_image / 1e9,
                        z_side_target_ms=0.06,
                        product_library_ms=product,
                        product_library_note='the Z side\'s product alone: '
                        'torch.matmul T^T [Mpad, N P] x [N P, L] in float32, '
                        'TF32 off, on pre-extracted patches',
                        image_side_target_ms=0.43,
                        image_side={
                            'cluster_blocks': S5, 'blocks': N * S5,
                            'threads_per_block': threads,
                            'dynamic_smem_bytes': cuda_cross.bwd_smem_bytes(Pn, L5),
                            'resident_clusters': clusters,
                            'resident_warps_per_sm': clusters * S5 * threads
                            / 32 / torch.cuda.get_device_properties(0)
                            .multi_processor_count},
                        z_side_dynamic_smem_bytes=cuda_cross.Z_SMEM,
                        ptxas=report.get('conv_rbf_cross_bwd', {}).get('ptxas'),
                        image_side_trace_cycles=k5_image_trace(torch, *a))
            k5 = {'name': 'conv_rbf_cross_bwd', 'route': 'cuda',
                  'source': 'deepcgp_tpu_torch/csrc/conv_rbf_cross_bwd.cu',
                  'replaces': 'deepcgp_tpu/ops/pallas_cross.py:243',
                  'max_abs_err': err, 'ms': ms, 'plain_ms': plain,
                  'bound_ms': k5_bound, 'bound_by': k5_by, 'library_ms': None,
                  'shape': f'N={N} {H}x{W}x{C} f={f} M={M}'}
        emit(line)
    kernels.append(k5)

    # -- K6 and K7: the unfused route's extraction and its col2im -----------
    # The rows added with the staged K6 draw from a generator of their own.
    kernels += patches_phases(torch, dev, card, rng,
                              np.random.RandomState(args.seed + 3), deep)

    # -- serving: the flagship through Predictor.from_run_dir ---------------
    with tempfile.TemporaryDirectory() as root:
        run = write_run(root, snapshot)
        pred = Predictor.from_run_dir(run, IMAGE, batch_size=BATCH,
                                      num_samples=SAMPLES)
        X = rng.randn(4096, *IMAGE).astype(np.float32)
        Y = rng.randint(0, 10, size=(4096, 1))
        chunks = len(X) // BATCH
        for r in range(WARMUP_REQUESTS):
            pred.predict_proba(X[BATCH * (r % chunks):][:BATCH])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

        reset_counts()
        calls0 = pred._calls
        probs_small = pred.predict_proba(X[:300])       # 300 = 2 x 128 + 44
        # The window: one batch-sized request after another, each ending in
        # the Predictor's synchronize(); its rate is all images over all
        # wall time, its tail from every request's latency.
        latency = []
        t_window = time.perf_counter()
        while time.perf_counter() - t_window < WINDOW_SECONDS:
            rows = X[BATCH * (len(latency) % chunks):][:BATCH]
            t = time.perf_counter()
            probs = pred.predict_proba(rows)
            latency.append(time.perf_counter() - t)
        window = time.perf_counter() - t_window
        labels = pred.predict(X[:200])
        dens = pred.log_density(X[:200], Y[:200])
        batches = pred._calls - calls0
        launches = read_counts()
        peak = torch.cuda.max_memory_allocated()

        check(probs_small.shape == (300, 10) and probs.shape == (BATCH, 10),
              'probability shapes')
        check(bool(np.isfinite(probs_small).all() and np.isfinite(probs).all()),
              'probabilities finite')
        check(float(np.abs(probs.sum(1) - 1).max()) < 5e-3,
              'probabilities sum to 1')
        check(labels.shape == (200,) and bool(np.isfinite(dens).all())
              and bool((dens <= 1e-6).all()), 'labels and log-densities')
        check(launches == launches_of(chol_inv_base=batches,
                                      tri_inv_base=batches,
                                      conv_rbf_cross=batches),
              f'launches {launches} for {batches} predict_y calls')
        path_launches['serving'] = launches

        # The same model on the CPU (plain versions), fed the same noise.
        cpu_model = Predictor.from_run_dir(run, IMAGE, device='cpu').model
        n = BATCH
        noise = [rng.randn(SAMPLES, n, 1000), rng.randn(SAMPLES, n, 10)]
        xb = torch.as_tensor(X[:n].reshape(n, -1))
        p_gpu = pred.model.predict_y(xb.to(dev), SAMPLES, noise=noise)[0]
        p_cpu = cpu_model.predict_y(xb, SAMPLES, noise=noise)[0]
        check(float(p_cpu.std()) > 1e-3,
              'the flagship snapshot answers the same everywhere: the card vs'
              ' CPU comparison would check nothing')
        yb = torch.as_tensor(Y[:n])
        d_gpu = pred.model.predict_density(xb.to(dev), yb.to(dev), SAMPLES,
                                           noise=noise)
        d_cpu = cpu_model.predict_density(xb, yb, SAMPLES, noise=noise)
        dp = float((p_gpu.cpu() - p_cpu).abs().max())
        dd = float((d_gpu.cpu() - d_cpu).abs().max())
        check(dp <= 1e-4, f'card vs CPU probabilities differ by {dp}')
        check(dd <= 1e-3, f'card vs CPU log-densities differ by {dd}')

        lat_ms = np.sort(np.asarray(latency)) * 1e3
        emit({'phase': 'serving', **card, 'config': FLAGSHIP, 'image': IMAGE,
              'batch_size': BATCH, 'num_samples': SAMPLES,
              'warmup_requests': WARMUP_REQUESTS,
              'requests': {'predict_proba_rows': 300, 'window_requests':
                           len(latency), 'window_request_rows': BATCH,
                           'predict_rows': 200, 'log_density_rows': 200},
              'predict_y_calls': batches, 'launches': launches,
              'window_seconds': window,
              'requests_per_s': len(latency) / window,
              'images_per_s': BATCH * len(latency) / window,
              'latency_ms': {q: float(np.percentile(lat_ms, v)) for q, v in
                             (('p50', 50), ('p90', 90), ('p99', 99))}
              | {'min': float(lat_ms[0]), 'max': float(lat_ms[-1])},
              'max_memory_allocated_bytes': peak,
              'card_vs_cpu_max_abs_prob': dp,
              'card_vs_cpu_max_abs_log_density': dd,
              'tolerance': 'probabilities atol 1e-4, log-densities atol 1e-3'})

        # Where a request's time goes: 16 batch-sized requests under the
        # profiler, device time by kernel and the device's busy share.
        wall_ms, busy_ms, top, rounds = profile_device(torch, lambda: [
            pred.predict_proba(X[BATCH * r:][:BATCH]) for r in range(16)],
            reset_counts, read_counts)
        emit({'phase': 'profile', **card, 'requests': 16,
              'request_rows': BATCH,
              'wall_ms': wall_ms, 'device_busy_ms': busy_ms,
              'device_busy_share': busy_ms / wall_ms,
              'profile_rounds': rounds, 'top_device_ms': top})

    # -- training: the flagship's Adam steps from a fresh build -------------
    from deepcgp_tpu_torch.models import builder as mbuilder
    from deepcgp_tpu_torch.training import optim, trainer
    from deepcgp_tpu_torch.utils import checkpoint
    flags = types.SimpleNamespace(**FLAGSHIP, num_samples=TRAIN_SAMPLES)
    Xtr = rng.randn(TRAIN_IMAGES, *IMAGE).astype(np.float32)
    Ytr = rng.randint(0, 10, size=(TRAIN_IMAGES, 1))
    # Time the inducing-point initialisation (patch sampling + k-means on
    # the card) of each layer apart from the rest of the build.
    inducing_seconds = []
    fresh_points = mbuilder.patch_inducing_points

    def timed_points(*a, **k):
        t = time.perf_counter()
        out = fresh_points(*a, **k)
        torch.cuda.synchronize()
        inducing_seconds.append(time.perf_counter() - t)
        return out

    mbuilder.patch_inducing_points = timed_points
    t = time.perf_counter()
    model = mbuilder.build_model(
        flags, IMAGE, images=Xtr,
        generator=torch.Generator().manual_seed(args.seed), device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t
    mbuilder.patch_inducing_points = fresh_points
    emit({'phase': 'train build', **card, 'config': FLAGSHIP,
          'images': [TRAIN_IMAGES, *IMAGE], 'seconds': build_s,
          'inducing_init_seconds_per_layer': inducing_seconds,
          'inducing_init': 'patch sampling + 50 k-means iterations on the '
                           'card, M x 100 patches per layer'})

    config = trainer.TrainConfig(optimizer='Adam', lr=0.01,
                                 batch_size=TRAIN_BATCH)
    state = trainer.init_state(model, config, seed=args.seed)
    Xd = torch.as_tensor(Xtr.reshape(TRAIN_IMAGES, -1), device=dev)
    Yd = torch.as_tensor(Ytr, device=dev)
    warm = trainer.run_chunk(state, config, Xd, Yd, TRAIN_WARMUP_STEPS)
    warm_model = copy.deepcopy(model)   # served below, beside the final one
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    traces = []
    t_window = time.perf_counter()
    while time.perf_counter() - t_window < WINDOW_SECONDS:
        traces.append(trainer.run_chunk(state, config, Xd, Yd, TRAIN_CHUNK))
        torch.cuda.synchronize()
    window = time.perf_counter() - t_window
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    steps = TRAIN_CHUNK * len(traces)
    trace = torch.cat([warm] + traces).cpu().numpy()
    check(bool(np.isfinite(trace).all()), 'a training ELBO is not finite')
    check(launches == launches_of(chol_inv_base=steps, tri_inv_base=steps,
                                  conv_rbf_cross=steps,
                                  conv_rbf_cross_bwd=2 * steps),
          f'launches {launches} for {steps} training steps')
    path_launches['adam'] = launches

    fields, failure = adam_step_vs_cpu(torch, state, config, Xd, Yd,
                                       TRAIN_BATCH, rng)
    emit({'phase': 'training', **card, 'config': FLAGSHIP, 'optimizer': 'Adam',
          'lr': config.lr, 'batch_size': TRAIN_BATCH,
          'num_samples': TRAIN_SAMPLES, 'warmup_steps': TRAIN_WARMUP_STEPS,
          'window_steps': steps, 'window_seconds': window,
          'steps_per_s': steps / window, 'launches': launches,
          'elbo_first': float(trace[0]), 'elbo_window_start': float(
              trace[TRAIN_WARMUP_STEPS]), 'elbo_last': float(trace[-1]),
          'max_memory_allocated_bytes': peak, **fields})
    check(failure is None, f'flagship {failure}')
    from deepcgp_tpu_torch.utils import flops
    peak_flops = flops.device_peak_flops(dev)
    flop_readings = {'flagship_adam': flop_reading(model, TRAIN_BATCH,
                                                   steps / window, peak_flops)}

    wall_ms, busy_ms, top, rounds = profile_device(
        torch, lambda: trainer.run_chunk(state, config, Xd, Yd, 16),
        reset_counts, read_counts)
    emit({'phase': 'training profile', **card, 'steps': 16,
          'wall_ms': wall_ms, 'device_busy_ms': busy_ms,
          'device_busy_share': busy_ms / wall_ms, 'profile_rounds': rounds,
          'top_device_ms': top})

    # -- the trained model as a snapshot, served ----------------------------
    # Each snapshot's served answers must be the model's own on the same
    # noise and finite.  Their sums are 1 only up to the robust-max
    # quadrature's error: 20 Gauss-Hermite points integrate each
    # P(f_c is largest) well only while the latents' variances are alike
    # (the JAX package computes the same numbers).  Training spreads them,
    # so the error grows with the step count -- 0.032 after 406 steps and
    # 0.049 after 486 in two runs of this script, up to 0.12 for variances
    # spread as uniform**4 (plain likelihood on the CPU).  So the sum is
    # checked on the model after the fixed warm-up and reported for the
    # model after the time-bounded window.
    for label, trained, step in (
            ('warm-up', warm_model, TRAIN_WARMUP_STEPS),
            ('window', model, int(state.step))):
        with tempfile.TemporaryDirectory() as root:
            run = write_run(root, checkpoint.model_parameters(trained, step))
            served = Predictor.from_run_dir(run, IMAGE, batch_size=BATCH,
                                            num_samples=SAMPLES)
            probs = served.predict_proba(Xtr[:2 * BATCH])
        xs = Xd[:BATCH]
        noise = [rng.randn(SAMPLES, BATCH, layer.num_outputs)
                 for layer in model.layers]
        p_served = served.model.predict_y(xs, SAMPLES, noise=noise)[0]
        p_trained = trained.predict_y(xs, SAMPLES, noise=noise)[0]
        d_round = float((p_served - p_trained).abs().max())
        sum_err = float(np.abs(probs.sum(1) - 1).max())
        finite = bool(np.isfinite(probs).all())
        emit({'phase': 'trained snapshot served', **card, 'snapshot': label,
              'global_step': step, 'rows': 2 * BATCH, 'finite': finite,
              'max_abs_prob_sum_minus_1': sum_err,
              'served_vs_trained_max_abs_prob': d_round,
              'prob_std': float(probs.std()),
              'tolerance': 'served vs trained 1e-4; after the warm-up, sums '
                           'within 5e-3 of 1'})
        check(probs.shape == (2 * BATCH, 10) and finite,
              f'the {label} snapshot serves finite probabilities')
        check(d_round <= 1e-4, f'{label} snapshot served vs trained: {d_round}')
        check(label != 'warm-up' or sum_err <= 5e-3,
              f'{label} snapshot probabilities sum to 1 +- {sum_err}')

    # -- NatGrad training: the flagship, then M=1024 --------------------------
    state, config, Xd, Yd, launches, _ = natgrad_training(
        torch, 'flagship', flags, IMAGE, TRAIN_BATCH, args.seed, rng, dev,
        card, reset_counts, read_counts, TRAIN_WARMUP_STEPS, TRAIN_CHUNK,
        WINDOW_SECONDS)
    path_launches['natgrad'] = launches

    def natgrad_profile(label):
        # One 16-step chunk (its terminal ELBO included) under the profiler.
        wall_ms, busy_ms, top, rounds = profile_device(
            torch, lambda: trainer.run_chunk(state, config, Xd, Yd, 16),
            reset_counts, read_counts)
        emit({'phase': f'natgrad training profile {label}', **card,
              'steps': 16, 'wall_ms': wall_ms, 'device_busy_ms': busy_ms,
              'device_busy_share': busy_ms / wall_ms,
              'profile_rounds': rounds, 'top_device_ms': top})

    natgrad_profile('flagship')
    mflags = types.SimpleNamespace(**M1024, num_samples=TRAIN_SAMPLES)
    state, config, Xd, Yd, launches, fresh = natgrad_training(
        torch, 'm1024', mflags, M1024_IMAGE, M1024_BATCH, args.seed, rng, dev,
        card, reset_counts, read_counts, 5, 10, WINDOW_SECONDS)
    path_launches['m1024_natgrad'] = launches
    flop_readings['m1024_natgrad'] = flop_reading(
        fresh, M1024_BATCH, WINDOW_STEPS_PER_S['m1024'], peak_flops)
    natgrad_profile('m1024')
    del state, Xd, Yd
    path_launches['m1024_adam'] = m1024_adam(torch, fresh, args.seed, rng, dev,
                                             card, reset_counts, read_counts)
    del fresh
    # NatGrad above K1's largest matrix (M = 1088): the solve takes K2 on
    # the whole G, Kuu the library; two warm-up steps and one 3-step chunk,
    # then 16 steps under the profiler.
    check(optim.natgrad_route(torch.float32, 1088) == 'upper',
          'M = 1088 does not take K2')
    state, config, Xd, Yd, launches, _ = natgrad_training(
        torch, 'm1088',
        types.SimpleNamespace(**M1088, num_samples=TRAIN_SAMPLES), M1024_IMAGE,
        M1024_BATCH, args.seed, rng, dev, card, reset_counts, read_counts,
        2, 3, 0.0, noise_rng=aux)
    path_launches['m1088_natgrad'] = launches
    natgrad_profile('m1088')
    del state, Xd, Yd

    # -- the unfused route: MNIST's single-layer ConvKernel, CIFAR fm32 -----
    state, launches = unfused_adam(torch, 'mnist_conv', MNIST_CONV,
                                   MNIST_IMAGE, args.seed, rng, dev, card,
                                   reset_counts, read_counts)
    path_launches['mnist_conv_adam'] = launches
    path_launches['mnist_conv_serving'] = mnist_conv_serving(
        torch, state.model, int(state.step), dev, card, rng, reset_counts,
        read_counts)
    del state
    # fm32's last layer starts at lengthscale 25, as the flagship snapshot
    # does.  At the default 5 its 800-element patches sit so far apart that
    # every gradient through its cross-covariances (all of layer 1's
    # leaves, layer 0's Z and q_mu) is 1e-11..1e-58 in float64, and float32
    # returns the rounding noise of the products around the squared
    # distance instead, on the CPU as on the card
    # (tools/torch_grad_witness.py): the check would hold noise to noise.
    # One step at the default init is checked after the window, with layer
    # 1's leaves below FM32_DEFAULT_FLOOR in float64 read, not held.
    _, path_launches['fm32_adam'] = unfused_adam(
        torch, 'fm32', FM32, IMAGE, args.seed, rng, dev, card, reset_counts,
        read_counts, loaded={1: {'base_kernel/lengthscales': LENGTHSCALES[1]}})
    fm32_default_init_step(torch, args.seed, rng, dev, card)

    # -- depth 3's hidden-layer extraction: the route the layer takes ------
    hidden_extraction_phase(torch, dev, card, rng)

    # -- the compiled chunk: graphed against eager, bit for bit and timed ---
    path_launches.update(graph_phases(torch, dev, card, args.seed,
                                      reset_counts, read_counts))

    # -- the CLI: the entry points a user runs ------------------------------
    path_launches.update(cli_phases(torch, dev, card, args.seed,
                                    reset_counts, read_counts))
    # -- the rest of the single-device surface -------------------------------
    path_launches.update(surface_phases(torch, dev, card, args.seed,
                                        reset_counts, read_counts))
    # -- the mesh: the collectives on the card -------------------------------
    path_launches.update(mesh_phases(torch, card, args.seed, reset_counts,
                                     read_counts))
    # -- the last of the JAX surface: FLOP accounting, the examples, digits -
    flops_phase(torch, dev, card, flop_readings)
    path_launches.update(example_phases(torch, card, args.seed, reset_counts,
                                        read_counts))
    # -- the measurement tools: roofline, bytes audit, soak, digits sweep --
    path_launches.update(tool_phases(torch, card, reset_counts, read_counts))

    for k in kernels:
        k['launches_by_path'] = {path: n[k['name']]
                                 for path, n in path_launches.items()}
        k['launches'] = sum(k['launches_by_path'].values())
        check(k['launches'] > 0, f'{k["name"]} never launched on a main path')
    order = ('name', 'route', 'source', 'replaces', 'launches',
             'launches_by_path', 'shape', 'max_abs_err', 'ms', 'plain_ms',
             'bound_ms', 'bound_by', 'library_ms')
    short = [r for r in PROFILER_ROUNDS if r[1] < r[2]]
    emit({'phase': 'profiler rounds', 'rounds': len(PROFILER_ROUNDS),
          'short': short})
    emit({'kernels': [{key: k[key] for key in order} for k in kernels]})
    print(smi, flush=True)
    emit({'ok': True, 'device': {'platform': 'gpu',
                                 'kind': torch.cuda.get_device_name(0),
                                 'count': torch.cuda.device_count()}})
    return 0


if __name__ == '__main__':
    sys.exit(main())
