"""The port's measurement tools (deepcgp_tpu_torch/tools) on the CPU.

* ``roofline.parse_trace``, both bucket attributions and the join on a
  Chrome trace written here in the layout ``torch.profiler`` exports on
  the card: K1-K7's kernel names, an ``align1`` SIMT product, a float64
  kernel, a memcpy, a CPU-only operator and a device span of an
  annotated region;
* bytes from recorded shapes and types, and the hand kernels' bytes from
  their wrappers' tensors (the launch path run on CPU tensors with the
  library call stubbed) against PERF.md's formulas;
* the soak against the JAX package's ``run_chunk`` on the same
  parameters (``convert``) and the same draws (the port's, replayed into
  JAX);
* ``natgrad_digits``' flags and sweep table against the JAX tool's, read
  as data, and its exit code when a setting fails;
* the roofline and bytes tools end to end at a small size.
"""

import ast
import importlib.util
import json
import pathlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepcgp_tpu.models import dgp as jdgp
from deepcgp_tpu.models.builder import BuilderFlags, build_model as jbuild
from deepcgp_tpu.models.layers import ConvLayer as JConvLayer
from deepcgp_tpu.training import trainer as jtrainer
from deepcgp_tpu.utils import checkpoint as jckpt

from deepcgp_tpu_torch.convert import from_jax_parameters
from deepcgp_tpu_torch.ops import cuda_build, cuda_linalg, cuda_patches
from deepcgp_tpu_torch.tools import bytes_audit, natgrad_digits, roofline, soak
from deepcgp_tpu_torch.utils import profiling

ROOT = pathlib.Path(__file__).resolve().parent.parent


# ------------------------------------------------------- a synthetic trace
class TraceWriter:
    """Chrome trace events in torch.profiler's layout."""

    def __init__(self):
        self.events = []
        self.ext = 0
        self.corr = 0

    def x(self, cat, name, ts, dur, tid=10, **args):
        self.events.append({'ph': 'X', 'cat': cat, 'name': name, 'pid': 1,
                            'tid': tid, 'ts': ts, 'dur': dur, 'args': args})

    def frame(self, path, ts, dur, tid=10):
        self.x('python_function', f'/src/deepcgp_tpu_torch/{path}', ts, dur,
               tid, **{'Python id': len(self.events)})

    def op(self, name, ts, dur, tid=10, cat='cpu_op', **args):
        self.ext += 1
        self.x(cat, name, ts, dur, tid, **{'External id': self.ext, **args})
        return self.ext

    def kernel(self, name, device_ts, dur, ext, host_ts, tid=10,
               cat='kernel', launch='cudaLaunchKernel'):
        self.corr += 1
        self.x('cuda_runtime', launch, host_ts, 1, tid,
               correlation=self.corr, **{'External id': ext})
        self.x(cat, name, device_ts, dur, 7, correlation=self.corr,
               stream=7, **{'External id': ext})

    def write(self, path):
        with open(path, 'w') as f:
            json.dump({'traceEvents': self.events + [
                {'ph': 'M', 'name': 'process_name', 'pid': 1, 'tid': 0,
                 'args': {'name': 'python'}}]}, f)
        return str(path)


# (kernel name, its bucket, its source bucket, direction, duration us)
STEP = [
    ('chol_factor_cluster_kernel', 'K1 chol_factor', 'chol/solve', 'fwd', 50),
    ('tri_inv_strip_kernel', 'K3 tri_inv', 'chol/solve', 'fwd', 20),
    ('conv_rbf_cross_kernel', 'K4 conv_rbf_cross', 'conv-Kuf', 'fwd', 30),
    ('cutlass_80_simt_sgemm_128x32_8x5_nn_align1', 'gemm simt align1',
     'qsqrt-term', 'fwd', 40),
    ('void at::native::vectorized_elementwise_kernel<4, '
     'at::native::CUDAFunctor_add<double>, std::array<char*, 3ul> >',
     'float64', 'kl', 'fwd', 10),
    ('Memcpy DtoD (Device -> Device)', 'copy/memset', 'batch', 'fwd', 5),
    ('sm90_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize128x128x32', 'gemm',
     'qsqrt-term', 'bwd', 60),
    ('bwd_image_kernel', 'K5 conv_rbf_cross_bwd', 'conv-Kuf', 'bwd', 70),
    ('bwd_z_kernel', 'K5 conv_rbf_cross_bwd', 'conv-Kuf', 'bwd', 25),
    ('chol_upper_cluster_kernel', 'K2 chol_upper', 'chol/solve', 'fwd', 45),
    ('extract_transposed_kernel', 'K6 extract_patches', 'conv-Kuf', 'fwd', 8),
    ('col2im_transposed_kernel', 'K7 col2im', 'conv-Kuf', 'bwd', 9),
]
OUTSIDE_KERNEL = ('void at::native::elementwise_kernel<128, 2, '
                  'direct_copy_kernel_cuda>', 'copy/memset', 3)
PROLOGUE_KERNEL = ('void at::native::vectorized_elementwise_kernel<2, '
                   'at::native::FillFunctor<long>, std::array<char*, 1ul> >')


def reference_trace(path):
    """The eager step: forward ops on thread 10 under the port's frames,
    backward ops on thread 20 inside autograd's evaluate_function, each
    kernel launched from its operator or hand-kernel region."""
    w = TraceWriter()
    w.op(roofline.EAGER_STEP, 0, 1000, cat='user_annotation')
    w.frame('training/trainer.py(160): train_step', 1, 998)
    w.frame('models/dgp.py(123): elbo', 2, 700)
    dev = iter(range(5000, 10 ** 6, 100))
    k = {name: dur for name, _, _, _, dur in STEP}

    def launch_region(region, kernel, ts, tid=10):
        # The runtime ties a ctypes launch to no region: no External id.
        w.op(region, ts, 5, tid, cat='user_annotation')
        w.kernel(kernel, next(dev), k[kernel], None, ts + 1, tid)

    w.frame('models/layers.py(50): _precompute', 10, 60)
    w.frame('ops/linalg.py(90): chol_with_inv', 11, 55)
    w.frame('ops/cuda_linalg.py(230): chol_factor_blocked', 12, 10)
    launch_region('chol_factor_blocked', STEP[0][0], 13)
    w.frame('ops/cuda_linalg.py(610): tri_inv_blocked', 30, 10)
    launch_region('tri_inv_blocked', STEP[1][0], 31)
    w.frame('ops/cuda_cross.py(513): fused_conv_rbf_cross', 100, 50)
    fused = w.op('_FusedConvRBFCross', 101, 40, **{'Sequence number': 8,
                                                   'Fwd thread id': 0})
    assert fused
    launch_region('conv_rbf_cross', STEP[2][0], 110)
    w.frame('ops/conditional.py(30): multi_output_conditional', 200, 100)
    w.op('aten#0', 209, 22, cat='user_annotation')     # OpBytes' region
    mm = w.op('aten::mm', 210, 20, **{'Sequence number': 7,
                                      'Fwd thread id': 0,
                                      'Input Dims': [[320, 384], [384, 3840]],
                                      'Input type': ['float', 'float']})
    w.kernel(STEP[3][0], next(dev), k[STEP[3][0]], mm, 212)
    w.frame('models/dgp.py(117): prior_kl', 400, 60)
    w.frame('models/layers.py(190): KL', 401, 58)
    w.frame('ops/linalg.py(218): _gauss_kl', 402, 56)
    w.op('aten#1', 409, 12, cat='user_annotation')
    add = w.op('aten::add', 410, 10, **{'Input Dims': [[384, 384], [384, 384]],
                                        'Input type': ['double', 'double']})
    w.kernel(STEP[4][0], next(dev), k[STEP[4][0]], add, 412)
    w.op('aten::empty', 430, 3)          # a CPU-only operator
    w.frame('training/trainer.py(256): batch', 720, 20)
    cp = w.op('aten::copy_', 721, 5)
    w.kernel(STEP[5][0], next(dev), k[STEP[5][0]], cp, 722, cat='gpu_memcpy',
             launch='cudaMemcpyAsync')
    # The backward, on autograd's thread, in the forward's reverse order.
    w.op('autograd::engine::evaluate_function: MmBackward0', 750, 30, tid=20,
         **{'Sequence number': 7, 'Fwd thread id': 1})
    mm_b = w.op('aten::mm', 755, 20, tid=20)
    w.kernel(STEP[6][0], next(dev), k[STEP[6][0]], mm_b, 757, tid=20)
    w.op('autograd::engine::evaluate_function: _FusedConvRBFCrossBackward',
         790, 40, tid=20, **{'Sequence number': 8, 'Fwd thread id': 1})
    launch_region('conv_rbf_cross_bwd_image', STEP[7][0], 795, tid=20)
    launch_region('conv_rbf_cross_bwd_z', STEP[8][0], 810, tid=20)
    w.frame('training/optim.py(240): natgrad_update', 850, 60)
    w.frame('ops/cuda_linalg.py(360): chol_upper_blocked', 851, 10)
    launch_region('chol_upper_blocked', STEP[9][0], 852)
    w.frame('ops/cuda_patches.py(170): extract_patches_transposed', 870, 10)
    launch_region('extract_patches_transposed', STEP[10][0], 871)
    w.op('autograd::engine::evaluate_function: TfOrderPatchesBackward', 900,
         30, tid=20, **{'Sequence number': 8, 'Fwd thread id': 1})
    launch_region('col2im_transposed', STEP[11][0], 905, tid=20)
    # The device span of the step's region repeats its kernels' time.
    w.x('gpu_user_annotation', roofline.EAGER_STEP, 5000, 1500, 7)
    # The capture after the eager run: launch regions that run nothing.
    w.op('chol_factor_blocked', 1100, 5, cat='user_annotation')
    return w.write(path)


def chunk_trace(path, steps=2, rename=None, drop=False):
    """``steps`` replays of the step graph (the generators' fill launched
    first, then kernels carrying the cudaGraphLaunch's correlation and no
    operator), then one copy outside the steps."""
    w = TraceWriter()
    dev = 100000
    for s in range(steps):
        ext = w.op(roofline.REPLAY_STEP, 1000 * s, 50, cat='user_annotation')
        kernels = [n for n, *_ in STEP]
        if s == 1 and rename is not None:
            kernels[rename] = 'some_other_kernel'
        if s == 1 and drop:
            kernels = kernels[:-1]
        # The generators' seed and offset fill, launched before the graph.
        fill = w.op('aten::fill_', 1000 * s + 2, 3)
        w.kernel(PROLOGUE_KERNEL, dev, 2, fill, 1000 * s + 3)
        dev += 100
        w.corr += 1
        w.x('cuda_runtime', 'cudaGraphLaunch', 1000 * s + 10, 5,
            correlation=w.corr, **{'External id': ext})
        for name in kernels:
            dur = dict((n, d) for n, _, _, _, d in STEP).get(name, 1)
            cat = 'gpu_memcpy' if name.startswith('Memcpy') else 'kernel'
            w.x(cat, name, dev, dur, 7, correlation=w.corr)
            dev += 100
        w.x('gpu_user_annotation', roofline.REPLAY_STEP, dev - 1000, 900, 7)
    ext = w.op('aten::copy_', 1000 * steps + 10, 5)
    w.kernel(OUTSIDE_KERNEL[0], dev, OUTSIDE_KERNEL[2], ext, 1000 * steps + 11)
    w.op('aten::empty', 1000 * steps + 30, 2)
    return w.write(path)


def test_parse_trace_buckets_and_sources(tmp_path):
    """Every device event lands in its bucket by name and in its source
    bucket by the operator that launched it in the eager step (backward
    operators by their forward's frames); CPU operators and the device
    spans of annotated regions are not device work; the buckets sum to
    the device total."""
    ref = roofline.parse_trace(reference_trace(tmp_path / 'ref.json'))
    chunk = roofline.parse_trace(chunk_trace(tmp_path / 'chunk.json'))
    assert [e['name'] for e in chunk.events].count(STEP[0][0]) == 2
    assert not any('empty' in e['name'] or 'step' in e['name']
                   for e in chunk.events)
    assert len(chunk.events) == 2 * len(STEP) + 2 + 1
    step_us = sum(d for *_, d in STEP)
    outside = OUTSIDE_KERNEL[2] + 2 * 2     # the copy, two replays' fills
    assert chunk.total_us == 2 * step_us + outside
    assert roofline.bucket_of(PROLOGUE_KERNEL) == 'elementwise'
    for name, bucket, _, _, _ in STEP:
        assert roofline.bucket_of(name) == bucket, name
    assert roofline.bucket_of(OUTSIDE_KERNEL[0]) == OUTSIDE_KERNEL[1]

    r = roofline.analyse('synthetic', 2, ref, chunk, cpu=False)
    assert sum(r.buckets.values()) == pytest.approx(chunk.total_us)
    assert r.counts['K5 conv_rbf_cross_bwd'] == 4
    for i in (1, 2, 3, 4, 6, 7):
        assert r.counts[roofline.BUCKETS[i - 1][0]] == 2
    assert r.joined_steps == 2 and r.step_events == len(STEP)
    want = {}
    for name, _, source, direction, dur in STEP:
        want.setdefault(source, {'fwd': 0.0, 'bwd': 0.0})[direction] += 2 * dur
    want[roofline.OUTSIDE] = {'fwd': outside, 'bwd': 0.0}
    assert {k: v for k, v in r.sources.items()} == want
    got = [(name, roofline.source_bucket_of(s), d)
           for name, s, d, _ in r.reference]
    assert got == [(n, src, d) for n, _, src, d, _ in STEP]
    assert sum(r.position_us) == 2 * step_us


@pytest.mark.parametrize('broken', ['rename', 'drop'])
def test_join_raises_on_a_mismatch(tmp_path, broken):
    """A replayed step whose kernel at a position has another name, or
    which has another count of kernels, makes the analysis raise."""
    ref = roofline.parse_trace(reference_trace(tmp_path / 'ref.json'))
    chunk = roofline.parse_trace(chunk_trace(
        tmp_path / 'chunk.json', rename=3 if broken == 'rename' else None,
        drop=broken == 'drop'))
    with pytest.raises(roofline.JoinError):
        roofline.analyse('synthetic', 2, ref, chunk, cpu=False)
    steps = roofline.region_steps(chunk, roofline.REPLAY_STEP)
    roofline.join(steps[0], steps[0])
    with pytest.raises(roofline.JoinError):
        roofline.join(steps[0], steps[1])


def test_step_bytes_on_the_synthetic_trace(tmp_path):
    """An operator's bytes are its recorded inputs plus its logged
    outputs; a hand kernel's, its launch record's (the k-th of its C entry
    for its k-th event, the capture's launch regions left out); events no
    'aten#' region owns carry none and are counted."""
    ref = roofline.parse_trace(reference_trace(tmp_path / 'ref.json'))
    eager, span = roofline.eager_step(ref, cpu=False)
    ops = [('mm', 4 * 320 * 3840, 0), ('add', 8 * 384 * 384, 0)]
    entries = {k: c for c, k in roofline.LAUNCHES.items()}
    shapes = {'extract_patches_transposed': [(2, 8, 8, 1), (2, 16, 9)],
              'col2im_transposed': [(2, 16, 9), (2, 8, 8, 1)]}
    launches = [(entries[n], 10 * i, 1,
                 shapes.get(entries[n], [(3, 64, 64)] * 3))
                for i, (n, *_) in enumerate(STEP) if n in entries]
    out, hand, fallback, unmatched = bytes_audit.step_bytes(
        ref, eager, span, ops, launches)
    assert [h[0] for h in hand] == [entries[n] for n, *_ in STEP
                                    if n in entries]
    want = {n: 10 * i + 1 for i, (n, *_) in enumerate(STEP) if n in entries}
    want[STEP[3][0]] = 4 * (320 * 384 + 384 * 3840) + 4 * 320 * 3840
    want[STEP[4][0]] = 8 * 2 * 384 * 384 + 8 * 384 * 384
    assert out == [want.get(n, 0) for n, *_ in STEP]
    assert (fallback, unmatched) == (0, 2)       # the memcpy, the bwd mm


# -------------------------------------------------------------------- bytes
def test_shape_bytes_and_formulas():
    """Recorded Input Dims x Input type; a tensor list flagged; K1-K3, K6
    and K7 by PERF.md's formulas."""
    assert bytes_audit.shape_bytes(
        [[320, 384], [384, 3840], [], [2, 3]],
        ['float', 'float', 'Scalar', 'double']) == (
        4 * (320 * 384 + 384 * 3840) + 8 * 6, False)
    assert bytes_audit.shape_bytes([[[2, 3], [4]]], ['TensorList'])[1]
    B, M = 3, 384
    assert bytes_audit.formula_bytes(
        'chol_factor_blocked', [(B, M, M), (B, M, M), (B, M // 32, 32, 32)]
    ) == 4 * B * (2 * M * M + 32 * M)
    assert bytes_audit.formula_bytes(
        'tri_inv_blocked', [(B, M, M), (B, M, M)]) == 8 * B * M * M
    assert bytes_audit.formula_bytes(
        'chol_upper_blocked', [(B, M, M), (B, M // 32, 32, 32)]
    ) == 4 * B * (M * (M + 1) // 2 + M * M + 32 * M)
    assert bytes_audit.formula_bytes('conv_rbf_cross', [(1, 2)]) is None


@pytest.fixture
def launch_on_cpu(monkeypatch):
    """Run the wrappers' launch path on CPU tensors: the device checks
    pass, the C entry is a stub that returns success."""
    monkeypatch.setattr(cuda_linalg, '_check_device', lambda *a: False)
    monkeypatch.setattr(cuda_linalg, '_cluster', lambda M, B=1: 8)
    monkeypatch.setattr(cuda_patches, '_check', lambda *a: False)
    monkeypatch.setattr(cuda_build, 'function', lambda *a: lambda *b: 0)
    monkeypatch.setattr(torch.cuda, 'current_stream',
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=0))


@pytest.mark.parametrize('B,M', [(3, 384), (1, 1024)])
def test_k1_k3_wrapper_bytes_equal_the_formula(launch_on_cpu, B, M):
    """K1's and K3's launches report the bytes of the tensors their
    wrappers pass: 4 B (2 M^2 + 32 M) each (A, or L and its diagonal
    blocks' inverses, read; L and the inverses, or L^-1, written)."""
    A = torch.zeros(B, M, M)
    with profiling.observe_launches() as record:
        L, Dinv = cuda_linalg.chol_factor_blocked(A)
        cuda_linalg.tri_inv_blocked(L, Dinv)
    want = 4 * B * (2 * M * M + 32 * M)
    assert [r[0] for r in record] == ['chol_factor_blocked', 'tri_inv_blocked']
    for name, reads, writes, shapes in record:
        assert reads + writes == want == bytes_audit.formula_bytes(name,
                                                                   shapes)


@pytest.mark.parametrize('N,H,W,C,f,s', [(320, 10, 10, 10, 5, 1),
                                         (32, 28, 28, 1, 5, 1),
                                         (320, 14, 14, 10, 3, 1)])
def test_k6_k7_wrapper_bytes_equal_the_formula(launch_on_cpu, N, H, W, C, f,
                                               s):
    """K6 and K7 report 4 N (H W C + P L): the image and the patches, one
    read and the other written."""
    X = torch.zeros(N, H, W, C)
    with profiling.observe_launches() as record:
        g = cuda_patches.extract_patches_transposed(X, f, s)
        cuda_patches.col2im_transposed(g, (H, W, C), f, s)
    P = ((H - f) // s + 1) * ((W - f) // s + 1)
    want = 4 * N * (H * W * C + P * f * f * C)
    assert [r[0] for r in record] == ['extract_patches_transposed',
                                      'col2im_transposed']
    for name, reads, writes, shapes in record:
        assert reads + writes == want == bytes_audit.formula_bytes(name,
                                                                   shapes)


def test_launch_observers_nest_and_detach():
    with profiling.observe_launches() as outer:
        with profiling.launch('k', (torch.zeros(2),), (3,)):
            pass
        with profiling.observe_launches() as inner:
            with profiling.launch('j', (), (torch.zeros(1, dtype=torch.float64),)):
                pass
    with profiling.launch('z', (), ()):
        pass
    assert outer == [('k', 8, 3, [(2,)]), ('j', 0, 8, [(1,)])]
    assert inner == [('j', 0, 8, [(1,)])]


# --------------------------------------------------------------------- soak
SOAK_IMAGE = (12, 12, 1)


def _soak_flags():
    return BuilderFlags(M='16,16', feature_maps='2', filter_sizes='5,3',
                        strides='2,1', num_samples=3, batch_size=8)


def test_soak_matches_jax_run_chunk(monkeypatch, capsys):
    """The soak's two chunks of 3 NatGrad steps on a 2-layer M=16 model in
    float64, against the JAX package's run_chunk (jit off, so its scan
    steps in Python) from the same parameters, fed the port's batches and
    Monte-Carlo draws (replayed from a generator seeded as the soak seeds
    the state's, in the order a step draws them, and the final check's
    after each chunk): the ELBO trace at rtol 1e-6, nan_steps and
    steps_back equal, and the verdict line printed."""
    rng = np.random.RandomState(0)
    X = rng.randn(64, *SOAK_IMAGE)
    Y = rng.randint(0, 10, size=(64, 1))
    jmodel = jbuild(_soak_flags(), X, Y, jax.random.PRNGKey(0),
                    dtype=jnp.float64)
    jconfig = jtrainer.TrainConfig(optimizer='NatGrad', lr=0.01,
                                   lr_decay_steps=100000, gamma=0.001,
                                   batch_size=8)
    Z0 = [np.asarray(l.Z0) for l in jmodel.layers
          if isinstance(l, JConvLayer)]
    port = from_jax_parameters(_soak_flags(), SOAK_IMAGE,
                               jckpt.model_parameters(jmodel, 0), Z0,
                               num_data=jmodel.num_data, device='cpu')
    Xt = torch.as_tensor(X.reshape(64, -1))
    Yt = torch.as_tensor(Y)
    out = soak.soak(port, Xt, Yt, 'small', 'NatGrad', 8, 6, 3, seed=0)
    assert 'SOAK OK: small NatGrad 6 steps' in capsys.readouterr().out

    g = torch.Generator()
    g.manual_seed(1)                 # the soak's state: seed 100 * 0 + 1
    S = port.num_samples
    idx, noise = [], []

    def draw():
        idx.append(torch.randint(0, 64, (8,), generator=g).numpy())
        noise.extend(torch.randn((S, 8, layer.num_outputs), generator=g,
                                 dtype=torch.float64).numpy()
                     for layer in port.layers)

    for _ in range(2):
        for _ in range(3 + 1):       # three steps, then the final check
            draw()
    monkeypatch.setattr(jax.random, 'randint',
                        lambda key, shape, lo, hi: jnp.asarray(idx.pop(0)))
    monkeypatch.setattr(jdgp, 'mc_normal',
                        lambda key, shape, dtype: jnp.asarray(noise.pop(0)))
    state = jtrainer.init_state(jmodel, jconfig, jax.random.PRNGKey(1))
    trace = []
    with jax.disable_jit():
        for _ in range(2):
            state, elbos = jtrainer.run_chunk(state, jconfig, jnp.asarray(
                X.reshape(64, -1)), jnp.asarray(Y), 3)
            trace.append(np.asarray(elbos))
    assert not idx and not noise
    np.testing.assert_allclose(out['elbos'], np.concatenate(trace), rtol=1e-6)
    assert out['nan_steps'] == int(np.sum(~np.isfinite(np.concatenate(trace))))
    assert out['steps_back'] == float(state.steps_back) == 0.0
    assert out['ok'] and 0.0 <= out['train_accuracy'] <= 1.0


def test_soak_fails_on_a_nan_step(monkeypatch, capsys):
    """A NaN in a chunk's ELBO trace makes the verdict SOAK FAIL and main
    exit 1."""
    real = soak.trainer.run_chunk

    def poisoned(*a, **k):
        out = real(*a, **k)
        out[0] = float('nan')
        return out
    monkeypatch.setattr(soak.trainer, 'run_chunk', poisoned)
    monkeypatch.setitem(soak.CONFIGS, 'small', (
        dict(soak.FLAGSHIP, M='8,8', feature_maps='2', filter_sizes='5,3',
             strides='2,1'), SOAK_IMAGE, 8))
    monkeypatch.setattr(soak, 'IMAGES', 64)
    assert soak.main(['--config', 'small', '--optimizer', 'Adam', '--steps',
                      '2', '--chunk', '2'], device='cpu') == 1
    assert 'SOAK FAIL: small Adam 2 steps, nan_steps=1' in \
        capsys.readouterr().out


def test_tools_refuse_the_cpu_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    for tool in (soak, natgrad_digits, roofline, bytes_audit):
        with pytest.raises(RuntimeError, match='CUDA is not available'):
            tool.main(['--steps', '1'])


# ----------------------------------------------------------- digits sweep
def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        'jax_natgrad_digits', ROOT / 'tools' / 'natgrad_digits.py')
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _jax_sweeps():
    """The JAX tool's ``sweeps`` list (a local of its main), as data."""
    tree = ast.parse((ROOT / 'tools' / 'natgrad_digits.py').read_text())
    main = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == 'main')
    node = next(n for n in ast.walk(main) if isinstance(n, ast.Assign)
                and getattr(n.targets[0], 'id', None) == 'sweeps')
    return eval(compile(ast.Expression(node.value), 'sweeps', 'eval'),
                {'dict': dict})


@pytest.mark.parametrize('white', [False, True])
def test_digits_flags_and_sweeps_equal_the_jax_tool(white):
    assert vars(natgrad_digits._flags(white)) == \
        vars(_jax_tool()._flags(white))
    assert natgrad_digits.SWEEPS == _jax_sweeps()


def test_digits_failed_setting_exits_nonzero(monkeypatch, capsys):
    """A setting that raises is recorded with its error, the sweep goes
    on, and main returns 1; with every setting run it returns 0."""
    def run_config(tag, **kw):
        if tag == 'ng-g3e-2':
            raise FloatingPointError('boom')
        return {'tag': tag, 'final_acc': 0.5}
    monkeypatch.setattr(natgrad_digits, 'run_config', run_config)
    assert natgrad_digits.main(['--only', 'adam,ng-g3e-2,ng-g1e-1'],
                               device='cpu') == 1
    records = json.loads(capsys.readouterr().out)
    assert [r['tag'] for r in records] == ['adam', 'ng-g3e-2', 'ng-g1e-1']
    assert records[1]['error'] == "FloatingPointError('boom')"
    assert natgrad_digits.main(['--only', 'adam'], device='cpu') == 0


def test_digits_run_config_on_the_cpu():
    """One setting at a cut schedule: its record has the JAX tool's keys."""
    out = natgrad_digits.run_config('ng-g1e-2', optimizer='NatGrad',
                                    gamma0=0.01, total_steps=4,
                                    eval_every=2, device='cpu')
    assert set(out) == {'tag', 'optimizer', 'gamma0', 'white',
                        'warm_adam_steps', 'final_acc', 'peak_acc',
                        'steps_back', 'accs', 'elbos', 'wall_s'}
    assert len(out['accs']) == 2 and np.isfinite(out['elbos']).all()


# ------------------------------------------------------ the tools on the CPU
@pytest.fixture
def tiny_config(monkeypatch):
    monkeypatch.setitem(roofline.CONFIGS, 'tiny', (
        dict(roofline.FLAGSHIP, M='16,16', feature_maps='2',
             filter_sizes='3,3', strides='2,1'), (12, 12, 3), 8, 'NatGrad'))
    monkeypatch.setattr(roofline, 'IMAGES', 64)


def test_roofline_and_bytes_end_to_end_on_the_cpu(tiny_config, tmp_path,
                                                  capsys):
    """Two NatGrad steps of a small model: the tables print, every step
    joins the eager step, the buckets hold the device total, and
    --parse-only reads the saved traces back to the same numbers, as does
    the saved result."""
    argv = ['--config', 'tiny', '--steps', '2', '--trace-dir', str(tmp_path)]
    r = roofline.main(argv, device='cpu')
    out = capsys.readouterr().out
    assert '== tiny:' in out and '-- top 30 ops (per step) --' in out
    assert r.joined_steps == 2 and r.step_events > 100
    assert sum(r.buckets.values()) == pytest.approx(r.total_us)
    again = roofline.main(argv + ['--parse-only', '--bucket-detail', 'other'])
    assert again.buckets == r.buckets
    saved = roofline.read_result(str(tmp_path))
    assert (saved.buckets, saved.sources, saved.position_us,
            saved.joined_steps) == (r.buckets, r.sources, r.position_us,
                                    r.joined_steps)
    a = bytes_audit.main(argv + ['--parse-only', '--top', '5'])
    assert 'bytes roofline' in capsys.readouterr().out
    assert a.mb_step > 0 and len(a.rows) == r.step_events
