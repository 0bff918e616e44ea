#!/usr/bin/env python3
"""Where a float32 gradient of the PyTorch port on the card parts from the
CPU's: witnesses of one Adam step's gradients on configurations that
chip_smoke.py trains.

    python3 tools/torch_grad_witness.py [--seed 0] [--configs mnist_conv,m1024]
        [--steps 135] [--variants kernels,kl32,klT64]
        [--out chiprun_out/grad_witness.jsonl]

For the MNIST single-layer ConvKernel (M=1024), CIFAR fm32 and the
M=1024 ARD-RBF configuration at the builder's default initialisation,
at a fresh build and after ``--steps`` Adam steps, and for the
partial-view model of chip_smoke.py's ``partial view adam``
(``partial_view``: its images, labels, build and seed, 10 warm-up steps
and then chunks of 20 until each step count of ``--steps``, a comma-
separated list, is reached, every witness on the noise that phase's
step check draws), one batch's gradients are taken

* on the card in float32 through the kernels, and again with one part of
  the computation swapped: every kernel for its plain version (``plain``),
  K4 and K5 for their plain versions (``cross_plain``), the hidden
  layer's whole conditional (extraction, Kuf, Kdiag, the conditional and
  the mean) in float64 (``hidden64``),
  one layer's conditional in float64 (``hidcond64``, ``lastcond64``),
  the Kuu factorization in float64 (``chol64``) or only its backward's
  products (``cholbwd64``), the hidden layer with its RBF variance
  factored out (``factored``: Kuu = v (C + jitter/v I), fvar = v (1 -
  ||C Lc^-T||^2) + the q_sqrt term, the KL prior's factor scaled by
  sqrt v), the squared distances in
  float64 (``dist64``), the conditional in float64 (``cond64``), the
  ConvKernel's Kdiag gram by the centred self-gram (``selfgram_kdiag``),
  the whole KL in float64 (``kl64``), the KL's factor-form products all
  in float32 (``kl32``) or one of them in float64 (``klT64``: T = sum
  Lq Lq^T, as the port keeps it; ``klW64``: W = Lp^-T Lp^-1;
  ``kltrace64``: sum(W * T)), the
  likelihood's expectation in float64 (``lik64``), and every ATen matrix
  product (``mm64``), reduction
  (``sum64``) or transcendental function (``transc64``), or all three
  (``all64``), in float64 by a dispatch mode; ``a+b`` swaps both;
* on the CPU in float32 with the same swaps, and at parameters one rounding
  away (each times 1 + 2^-24 u, u standard normal; ``--perturbations N``
  above 2 does it N times for every variant);
* on the CPU in float64 with one part alone in float32 (``--islands
  chol,hidcond,...``: the Kuu Cholesky-with-inverse, the KL, the hidden
  or the last layer's conditional, the likelihood's expectation);
* on the CPU in float64, the reference.

Each line gives, per gradient leaf, max |g - g64| over max |g64|, the
largest |g64|, and how many of each layer's marginal variances the
conditional clamped to zero.  Needs a CUDA card (``--device cpu`` runs the
same at a small size as a rehearsal).
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import os
import sys
import types

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

VARIANTS = ('kernels', 'plain', 'cross_plain', 'hidden64', 'chol64',
            'cholbwd64', 'dist64', 'cond64', 'hidcond64', 'lastcond64',
            'factored',
            'selfgram_kdiag', 'kl64', 'kl32', 'klT64', 'klW64', 'kltrace64',
            'lik64', 'mm64', 'sum64', 'transc64', 'all64')
# The KL variants of factor_kl: the products of the factor-form KL
# evaluated in float64, the rest in float32.
KL_PRODUCTS = {'kl32': (), 'klT64': ('T',), 'klW64': ('W',),
               'kltrace64': ('trace',)}
CONFIGS = ('mnist_conv', 'fm32', 'm1024', 'partial_view')
# ATen operators that the *64 dispatch variants run in float64: matrix
# products, reductions, transcendental functions.
OPS64 = {'mm64': ('mm', 'bmm', 'addmm', 'baddbmm', 'addbmm', 'dot', 'mv',
                  'addmv'),
         'sum64': ('sum', 'mean', 'prod', 'cumsum', 'logsumexp',
                   'linalg_vector_norm'),
         'transc64': ('exp', 'log', 'erf', 'sqrt', 'rsqrt', 'pow', 'expm1',
                      'log1p', 'reciprocal')}
OPS64['all64'] = sum(OPS64.values(), ())


def upcast_mode(names):
    """A dispatch mode that runs the ATen operators ``names`` in float64 on
    float32 inputs and rounds their results back, forward and backward."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_map
    packets = {getattr(torch.ops.aten, n) for n in names}

    def cast(a, b):
        return lambda x: (x.to(b) if isinstance(x, torch.Tensor)
                          and x.dtype == a else x)

    class Upcast(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if func.overloadpacket not in packets:
                return func(*args, **kwargs)
            up = cast(torch.float32, torch.float64)
            out = func(*tree_map(up, args), **tree_map(up, kwargs))
            return tree_map(cast(torch.float64, torch.float32), out)
    return Upcast()


def factor_kl(products):
    """``ops.linalg.gauss_kl`` whose float32 factor form (``Lp_inv`` given)
    evaluates the products named in ``products`` -- 'T' = sum_r Lq_r
    Lq_r^T, 'W' = Lp^-T Lp^-1, 'trace' = sum(W * T) -- in float64, each
    rounded back, and the rest in float32; the other forms unchanged."""
    import torch
    from deepcgp_tpu_torch.ops import linalg
    kl = linalg.gauss_kl

    def at(name, x):
        return x.double() if name in products else x

    def gauss_kl(q_mu, q_sqrt, K=None, *, Lp=None, Lp_inv=None):
        if Lp_inv is None or q_mu.dtype != torch.float32:
            return kl(q_mu, q_sqrt, K, Lp=Lp, Lp_inv=Lp_inv)
        M, R = q_mu.shape
        T = linalg.syrk_sum(at('T', torch.tril(q_sqrt))).float()
        Wp = at('W', Lp_inv)
        W = (Wp.T @ Wp).float()
        trace = (at('trace', W) * at('trace', T)).sum().float()
        alpha = Lp_inv @ q_mu
        return 0.5 * (trace + alpha.square().sum() - M * R
                      - 2.0 * linalg.tril_logdet(q_sqrt)
                      + R * 2.0 * linalg.tril_logdet(Lp))
    return gauss_kl


def _cast(x, dtype):
    """Floating tensors in ``x`` (a tensor, a tuple, list, named tuple or
    dict) cast to ``dtype``, differentiably; anything else as it is."""
    import torch
    if isinstance(x, torch.Tensor):
        return x.to(dtype) if x.is_floating_point() else x
    if isinstance(x, tuple) and hasattr(x, '_fields'):
        return type(x)(*[_cast(v, dtype) for v in x])
    if isinstance(x, (tuple, list)):
        return type(x)(_cast(v, dtype) for v in x)
    if isinstance(x, dict):
        return {k: _cast(v, dtype) for k, v in x.items()}
    return x


def precision_island(fn, method: bool, inner, outer):
    """``fn`` run in dtype ``inner`` inside a model of dtype ``outer``: its
    arguments (and, for a module's ``method``, the module's parameters and
    buffers) cast to ``inner``, its results back to ``outer``."""
    import torch
    from torch import nn

    class Call(nn.Module):
        def __init__(self, mod):
            super().__init__()
            self.mod = mod

        def forward(self, args, kwargs):
            return fn(self.mod, *args, **kwargs)

    def plain(*args, **kwargs):
        return _cast(fn(*_cast(args, inner), **_cast(kwargs, inner)), outer)

    def of_module(self, *args, **kwargs):
        if not isinstance(self, nn.Module):
            return _cast(fn(self, *_cast(args, inner),
                            **_cast(kwargs, inner)), outer)
        tensors = dict(self.named_parameters())
        tensors.update(self.named_buffers())
        return _cast(torch.func.functional_call(
            Call(self), {f'mod.{k}': v.to(inner) for k, v in tensors.items()},
            (_cast(args, inner), _cast(kwargs, inner))), outer)
    return of_module if method else plain


def island_part(part: str):
    """(owner, attribute, is a method) of an ``island:`` part."""
    from deepcgp_tpu_torch.models import layers, likelihoods
    from deepcgp_tpu_torch.ops import linalg
    return {'chol': (linalg, 'chol_with_inv', False),
            'kl': (linalg, 'gauss_kl', False),
            'hidcond': (layers.ConvLayer, 'conditional_mean_var', True),
            'lastcond': (layers.SVGPLayer, 'conditional_mean_var', True),
            'lik': (likelihoods.MultiClass, 'variational_expectations',
                    True)}[part]


def factored_hidden_layer(put) -> None:
    """The non-white hidden ``ConvLayer`` of an isotropic RBF with its
    variance v factored out of every gram: Kuu = v (C + jitter/v I), Kuf =
    v C, Knn = v, so the factors and the conditional's A are v-free and v
    enters the variance as one factor and the KL through its prior's
    factor, sqrt(v) Lc.  The same function; v's gradient is then one
    explicit term instead of the sum over Kuu, Kuf and Knn that
    cancels."""
    import torch
    from deepcgp_tpu_torch.config import JITTER
    from deepcgp_tpu_torch.models import layers
    from deepcgp_tpu_torch.ops import linalg
    from deepcgp_tpu_torch.ops.distances import square_distance

    def unit(base, X, X2=None):
        if base.lengthscales.ndim:
            raise NotImplementedError('factored: an isotropic RBF only')
        return torch.exp((-0.5 / base.lengthscales.square())
                         * square_distance(X, X2))

    def kuu_grams(self):
        eye = torch.eye(self.Z.shape[0], dtype=self.Z.dtype,
                        device=self.Z.device)
        jitter = (JITTER / self.base_kernel.variance) * eye
        return tuple(unit(self.base_kernel, Z) + jitter
                     for Z in (self.Z, self.Z0.detach()))

    def make_cache(self, pairs):
        (Lm, Lm_inv), (Lp, Lp_inv) = pairs
        return layers.LayerCache(Lm=Lm, Lp=Lp, Lm_inv=Lm_inv, Lp_inv=Lp_inv)

    def conditional_mean_var(self, cache, ND_X, full_cov=False):
        if full_cov or self.white:
            raise NotImplementedError('factored: the non-white diagonal form')
        N = ND_X.shape[0]
        H, W = self.view.input_size
        NHWC_X = ND_X.reshape(N, H, W, self.view.feature_maps)
        NPL = self.view.extract_patches_NPL(NHWC_X)
        A = unit(self.base_kernel, NPL.transpose(0, 1),
                 self.Z[None]) @ cache.Lm_inv.T                  # [P, N, M]
        R = self.q_mu.shape[1]
        fvar = (self.base_kernel.variance * (1.0 - A.square().sum(-1))
                ).expand(R, *A.shape[:2])
        A = A @ cache.Lm_inv
        fmean = torch.einsum('pnm,mr->npr', A, self.q_mu)
        P, _, M = A.shape
        LTA = A.reshape(P * N, M) @ torch.tril(self.q_sqrt).permute(
            1, 0, 2).reshape(M, R * M)
        fvar = fvar + LTA.reshape(P * N, R, M).square().sum(-1).reshape(
            P, N, R).permute(2, 0, 1)
        fvar = torch.maximum(fvar, fvar.new_zeros(()))
        mean = fmean.reshape(N, self.num_outputs)
        return (mean + self.mean_function(self.view.mean_view(NHWC_X, NPL)),
                fvar.permute(2, 1, 0).reshape(N, self.num_outputs))

    def KL(self, cache=None):
        s = self.base_kernel.variance.sqrt()
        return linalg.gauss_kl(self.q_mu, self.q_sqrt, Lp=s * cache.Lp,
                               Lp_inv=cache.Lp_inv / s)

    for name, fn in (('kuu_grams', kuu_grams), ('make_cache', make_cache),
                     ('conditional_mean_var', conditional_mean_var),
                     ('KL', KL)):
        put(layers.ConvLayer, name, fn)


@contextlib.contextmanager
def swapped(variant: str):
    """The port with one part of the computation swapped (see module doc)."""
    import torch
    from deepcgp_tpu_torch.models import (base_kernels, conv_kernels, layers,
                                          likelihoods)
    from deepcgp_tpu_torch.ops import (cuda_cross, cuda_linalg, cuda_patches,
                                       linalg)
    saved = []

    def put(obj, name, value):
        saved.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    if '+' in variant:
        first, rest = variant.split('+', 1)
        with swapped(first), swapped(rest):
            yield
        return
    if variant in OPS64:
        with upcast_mode(OPS64[variant]):
            yield
        return
    if variant.startswith('island:'):
        owner, name, method = island_part(variant.split(':', 1)[1])
        put(owner, name, precision_island(getattr(owner, name), method,
                                          torch.float32, torch.float64))
    if variant in KL_PRODUCTS:
        put(linalg, 'gauss_kl', factor_kl(KL_PRODUCTS[variant]))
    elif variant == 'kl64':
        kl = linalg.gauss_kl

        def gauss_kl(q_mu, q_sqrt, K=None, *, Lp=None, Lp_inv=None):
            d = (lambda x: None if x is None else x.double())
            return kl(d(q_mu), d(q_sqrt), d(K), Lp=d(Lp),
                      Lp_inv=d(Lp_inv)).to(q_mu.dtype)
        put(linalg, 'gauss_kl', gauss_kl)
    elif variant == 'lik64':
        ve = likelihoods.MultiClass.variational_expectations

        def expectations(self, Fmu, Fvar, Y):
            return ve(self, Fmu.double(), Fvar.double(), Y).to(Fmu.dtype)
        put(likelihoods.MultiClass, 'variational_expectations', expectations)
    elif variant == 'plain':
        put(cuda_linalg, 'chol_factor_blocked',
            cuda_linalg.chol_factor_blocked_plain)
        put(cuda_linalg, 'tri_inv_blocked', cuda_linalg.tri_inv_blocked_plain)
        put(cuda_patches, 'extract_patches_transposed',
            cuda_patches.extract_patches_transposed_plain)
        put(cuda_patches, 'col2im_transposed',
            cuda_patches.col2im_transposed_plain)
    elif variant == 'factored':
        factored_hidden_layer(put)
    elif variant == 'cholbwd64':
        backward = linalg._CholWithInv.backward

        def backward64(ctx, gL, gLinv):
            L, Linv = ctx.saved_tensors
            ctx64 = types.SimpleNamespace(saved_tensors=(L.double(),
                                                         Linv.double()))
            d = (lambda x: None if x is None else x.double())
            return backward(ctx64, d(gL), d(gLinv)).to(L.dtype)
        put(linalg._CholWithInv, 'backward', staticmethod(backward64))
    elif variant == 'cross_plain':
        put(cuda_cross, 'conv_rbf_cross', cuda_cross.conv_rbf_cross_plain)
        put(cuda_cross, 'conv_rbf_cross_bwd',
            cuda_cross.conv_rbf_cross_bwd_plain)
    elif variant == 'hidden64':
        put(layers.ConvLayer, 'conditional_mean_var', precision_island(
            layers.ConvLayer.conditional_mean_var, True, torch.float64,
            torch.float32))
    elif variant == 'chol64':
        def impl(K):
            L = torch.linalg.cholesky(K.double())
            eye = torch.eye(K.shape[-1], dtype=L.dtype, device=L.device)
            Linv = torch.linalg.solve_triangular(L, eye.expand(L.shape),
                                                 upper=False)
            return L.to(K.dtype), Linv.to(K.dtype)
        put(linalg, '_chol_inv_impl', impl)
    elif variant == 'dist64':
        sd = base_kernels.square_distance

        def dist(X, X2=None):
            return sd(X.double(), None if X2 is None else X2.double()).to(X.dtype)
        put(base_kernels, 'square_distance', dist)
    elif variant in ('cond64', 'hidcond64', 'lastcond64'):
        # The last layer's conditional is the one with P == 1.
        cond = layers.multi_output_conditional
        last = {'cond64': (True, False), 'hidcond64': (False,),
                'lastcond64': (True,)}[variant]

        def conditional(Kmn, Knn, f, *, Lm_inv, q_sqrt=None, **kw):
            if (Kmn.shape[0] == 1) not in last:
                return cond(Kmn, Knn, f, Lm_inv=Lm_inv, q_sqrt=q_sqrt, **kw)
            mean, var = cond(Kmn.double(), Knn.double(), f.double(),
                             Lm_inv=Lm_inv.double(),
                             q_sqrt=None if q_sqrt is None else q_sqrt.double(),
                             **kw)
            return mean.to(Kmn.dtype), var.to(Kmn.dtype)
        put(layers, 'multi_output_conditional', conditional)
    elif variant == 'selfgram_kdiag':
        def kdiag(self, ND_X, patches=None):
            if patches is None:
                patches = self._patches(ND_X)
            w = self._weights()
            pc = self.view.patch_count
            return torch.matmul(torch.matmul(self.base_kernel.K(patches), w),
                                w) / (pc * pc)
        put(conv_kernels.ConvKernel, 'Kdiag', kdiag)
    elif variant != 'kernels' and not variant.startswith('island:'):
        raise ValueError(variant)
    try:
        yield
    finally:
        for obj, name, value in reversed(saved):
            setattr(obj, name, value)


@contextlib.contextmanager
def clamp_counts(record: list):
    """Count each conditional's clamped (zero) marginal variances, beside
    the smallest of them."""
    from deepcgp_tpu_torch.models import layers
    cond = layers.multi_output_conditional

    def counted(*a, **k):
        mean, var = cond(*a, **k)
        record.append([int((var == 0).sum()), float(var.detach().min())])
        return mean, var
    layers.multi_output_conditional = counted
    try:
        yield
    finally:
        layers.multi_output_conditional = cond


def gradients(torch, model, config, xb, yb, noise, variant, device, dtype):
    """(loss, {leaf: gradient on the CPU in float64}, clamped variances per
    conditional) of ``model`` moved to ``device`` / ``dtype``."""
    from deepcgp_tpu_torch.training import trainer
    m = copy.deepcopy(model).to(device, dtype)
    counts = []
    with swapped(variant), clamp_counts(counts):
        loss, grads = trainer.loss_and_grads(
            trainer.init_state(m, config), xb.to(device, dtype),
            yb.to(device), noise)
    return (float(loss), {k: g.detach().cpu().double() for k, g in grads.items()},
            counts)


def perturbed(torch, model, seed: int):
    """A copy of ``model`` with each parameter times 1 + 2^-24 u."""
    nearby = copy.deepcopy(model).cpu()
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in nearby.parameters():
            p.mul_(1.0 + 2.0 ** -24 * torch.randn(p.shape, generator=gen,
                                                  dtype=p.dtype))
    return nearby


def witness(torch, label, state, config, Xd, Yd, dev, rng, emit, variants,
            perturbations=2, islands=()):
    model = state.model
    B = config.batch_size
    noise = [rng.randn(model.num_samples, B, layer.num_outputs)
             for layer in model.layers]
    xb, yb = Xd[:B].cpu(), Yd[:B].cpu()
    cpu = torch.device('cpu')
    loss64, g64, counts64 = gradients(torch, model, config, xb, yb, noise,
                                      'kernels', cpu, torch.float64)
    line = {'state': label, 'step': int(state.step), 'loss_f64': loss64,
            'clamped_f64': counts64,
            'g64_max': {k: float(g.abs().max()) for k, g in g64.items()}}
    runs = [(f'{where} {v}', v, d, None) for v in variants
            for where, d in (('card', dev), ('cpu', cpu))]
    runs += [(f'cpu perturbed {i}' if v == 'kernels'
              else f'cpu {v} perturbed {i}', v, cpu, i)
             for v in variants for i in range(1, perturbations + 1)
             if v == 'kernels' or perturbations > 2]
    runs += [(f'cpu f32 island {part}', f'island:{part}', cpu, None)
             for part in islands]
    for name, variant, device, seed in runs:
        src = model if seed is None else perturbed(torch, model, seed)
        dtype = (torch.float64 if variant.startswith('island:')
                 else torch.float32)
        loss, g, counts = gradients(torch, src, config, xb, yb, noise,
                                    variant, device, dtype)
        line[name] = {'loss_rel_err': abs(loss - loss64) / abs(loss64),
                      'clamped': counts,
                      'grad_rel_err': {k: cs.rel(g[k], g64[k]) for k in g64}}
    emit(line)


def card_name(dev) -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    if dev.type == 'cpu':
        return 'cpu rehearsal'
    import subprocess
    return subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True, check=True).stdout.strip()


def partial_view_inputs(seed: int):
    """(images, labels, the generator of the step check's noise) of
    chip_smoke.py's ``partial view adam``: its phase generator after the
    draws of the ``full cov`` phase that precedes it."""
    from deepcgp_tpu_torch.ops.patches import out_size
    rng = np.random.RandomState(seed + 6)
    flagship_hidden = out_size(cs.IMAGE[0], 5, 3) ** 2 * int(
        cs.FLAGSHIP['feature_maps'])
    rng.randn(512, *cs.MNIST_IMAGE)
    rng.randn(cs.FULL_COV_N, *cs.IMAGE)
    for outputs in (flagship_hidden, 10, 10):
        rng.randn(outputs, cs.FULL_COV_N)
    rng.randn(10, cs.FULL_COV_MNIST_N)
    X = rng.randn(cs.PV_IMAGES, *cs.PV_IMAGE).astype(np.float32)
    Y = rng.randint(0, 10, size=(cs.PV_IMAGES, 1))
    return X, Y, rng


def partial_view(torch, args, dev, emit, variants) -> None:
    """chip_smoke.py's partial-view Adam run, witnessed at each step count
    of ``--steps`` (after the 10 warm-up steps)."""
    from deepcgp_tpu_torch.training import trainer
    X, Y, rng = partial_view_inputs(args.seed)
    model = cs.partial_view_model(torch, X, args.seed, dev)
    config = trainer.TrainConfig(optimizer='Adam', lr=0.01,
                                 batch_size=cs.TRAIN_BATCH)
    state = trainer.init_state(model, config, seed=args.seed)
    Xd = torch.as_tensor(X.reshape(len(X), -1), device=dev)
    Yd = torch.as_tensor(Y, device=dev)
    trainer.run_chunk(state, config, Xd, Yd, cs.TRAIN_WARMUP_STEPS)
    done = 0
    for steps in sorted(args.steps):
        while done < steps:
            trainer.run_chunk(state, config, Xd, Yd, cs.TRAIN_CHUNK)
            done += cs.TRAIN_CHUNK
        noise_rng = np.random.RandomState()
        noise_rng.set_state(rng.get_state())
        witness(torch, f'partial_view after {done} window steps', state,
                config, Xd, Yd, dev, noise_rng, emit, variants,
                args.perturbations, args.islands)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--steps', default='135',
                    type=lambda s: [int(x) for x in s.split(',')],
                    help='Adam steps before the trained witness; for '
                         'partial_view a comma-separated list of window '
                         'steps (multiples of 20)')
    ap.add_argument('--device', default='cuda')
    ap.add_argument('--configs', default='mnist_conv,fm32',
                    help=f'comma-separated, of {CONFIGS}')
    ap.add_argument('--variants', default=','.join(VARIANTS),
                    help='comma-separated, of the module docstring\'s')
    ap.add_argument('--perturbations', type=int, default=2,
                    help='CPU runs at parameters one rounding away; above 2, '
                         'for every variant')
    ap.add_argument('--islands', default='',
                    help='comma-separated parts (chol, kl, hidcond, lastcond, '
                         'lik), each run alone in float32 in a float64 '
                         'model on the CPU')
    ap.add_argument('--out', default=os.path.join(ROOT, 'chiprun_out',
                                                  'grad_witness.jsonl'))
    args = ap.parse_args()
    args.islands = tuple(p for p in args.islands.split(',') if p)
    import torch
    from deepcgp_tpu_torch.models import builder as mbuilder
    from deepcgp_tpu_torch.training import trainer
    dev = torch.device(args.device)
    small = dev.type == 'cpu'
    if not small and not torch.cuda.is_available():
        print('torch_grad_witness: no CUDA device', file=sys.stderr)
        return 2
    if not small:
        from deepcgp_tpu_torch.ops import cuda_build
        cuda_build.build()
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    out = open(args.out, 'w')

    def emit(obj):
        text = json.dumps(obj)
        print(text, flush=True)
        out.write(text + '\n')

    emit({'card': card_name(dev),
          'float32_matmul_precision': torch.get_float32_matmul_precision(),
          'matmul_allow_tf32': torch.backends.cuda.matmul.allow_tf32})
    rng = np.random.RandomState(args.seed)
    variants = args.variants.split(',')
    unknown = {v for vs in variants for v in vs.split('+')} - set(VARIANTS)
    if unknown:
        raise SystemExit(f'unknown variants {unknown}')
    # (flags, image, batch) per configuration; small shapes for --device cpu.
    table = {'mnist_conv': (cs.MNIST_CONV, cs.MNIST_IMAGE, cs.TRAIN_BATCH),
             'fm32': (cs.FM32, cs.IMAGE, cs.TRAIN_BATCH),
             'm1024': (cs.M1024, cs.M1024_IMAGE, cs.M1024_BATCH)}
    images = cs.TRAIN_IMAGES
    if small:
        images = 64
        table = {'mnist_conv': (dict(cs.MNIST_CONV, M='128'), (14, 14, 1), 8),
                 'fm32': (dict(cs.FM32, M='64,64'), (20, 20, 3), 8),
                 'm1024': (dict(cs.M1024, M='128'), (14, 14, 1), 8)}
        cs.PV_IMAGES, cs.PV_M, cs.TRAIN_SAMPLES = 64, 32, 3
    for label in args.configs.split(','):
        if label == 'partial_view':
            partial_view(torch, args, dev, emit, variants)
            continue
        flags, image, batch = table[label]
        cs.TRAIN_IMAGES = images
        X, Y = cs.learnable_data(rng, image)
        model = mbuilder.build_model(
            types.SimpleNamespace(**flags, num_samples=3 if small else
                                  cs.TRAIN_SAMPLES),
            image, None, images=X,
            generator=torch.Generator().manual_seed(args.seed), device=dev)
        config = trainer.TrainConfig(optimizer='Adam', lr=0.01,
                                     batch_size=batch)
        state = trainer.init_state(model, config, seed=args.seed)
        Xd = torch.as_tensor(X.reshape(len(X), -1), device=dev)
        Yd = torch.as_tensor(Y, device=dev)
        witness(torch, f'{label} fresh', state, config, Xd, Yd, dev, rng, emit,
                variants, args.perturbations, args.islands)
        trainer.run_chunk(state, config, Xd, Yd,
                          3 if small else max(args.steps))
        witness(torch, f'{label} trained', state, config, Xd, Yd, dev, rng,
                emit, variants, args.perturbations, args.islands)
    out.close()
    return 0


if __name__ == '__main__':
    sys.exit(main())
