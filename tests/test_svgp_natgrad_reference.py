"""The benchmark's plain SVGP and NatGrad reference
(``portbench/reference/svgp.py``) and what the NatGrad cell adds: the port
held to the reference at a small size (7x7x1 images, D = 49, M = 64,
R = 10, batch 16, S = 2) in float64 and float32 -- the ELBO, every
gradient, and three eager NatGrad ``run_chunk`` steps with their final
checks; the reference's natural-gradient step by itself, on a conjugate
Gaussian-likelihood SVGP, where gamma = 1 lands on the closed-form optimal
q(u); the reference importing nothing of JAX or either package; the
yardstick's counts against a hand count at M = 4; and the port's
``natgrad update`` span and NatGrad counters on one eager CPU step."""

import math
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from deepcgp_tpu_torch.models.builder import build_model  # noqa: E402
from deepcgp_tpu_torch.training import trainer  # noqa: E402
from deepcgp_tpu_torch.utils import profiling  # noqa: E402
from deepcgp_tpu_torch.utils.checkpoint import \
    parse_layer_parameters  # noqa: E402
from portbench import inputs, program, yardstick_natgrad  # noqa: E402
from portbench.kinds import train_natgrad as kind  # noqa: E402
from portbench.reference import svgp  # noqa: E402
from portbench.reference.convgp import Arith, gauss_kl  # noqa: E402

SEED = 2 ** 31 + 23
SMALL = dict(name='small', reference='svgp', image_shape=[7, 7, 1],
             num_classes=10, num_data=256, held_out=0, M=[64],
             feature_maps=[], filter_sizes=[5], strides=[1],
             base_kernel='rbf', last_kernel='rbf', white=False,
             identity_mean=False, dtype='float32', lr=0.01,
             lr_decay_steps=2, lr_decay_continuous=False, gamma=0.1,
             weights=dict(variance=5.0, lengthscale=7.0, q_mu_scale=0.5,
                          q_sqrt_scale=1.0))
TRAFFIC = dict(kind='train_natgrad', optimizer='NatGrad', batch=16,
               samples=2, chunk_steps=5)
# Agreement of the port with the float64 reference, relative to the
# reference's own size (the loss, a leaf's gradient, a leaf's change):
# float64 reads up to 1.4e-14 (the order of its summations); float32 up
# to 2.5e-5, a raw hyperparameter's float32 spacing (~5e-7 at 5) against
# its first Adam changes of ~lr = 0.01.
RTOL = {torch.float64: 1e-11, torch.float32: 2e-4}


def small_port(dtype):
    """(model, TrainState, TrainConfig, X, Y) of the small configuration
    through the port's builder, from the reference-format snapshot the
    benchmark's kind writes."""
    w = kind.weights(SMALL, SEED, 'cpu')
    _, loaded = parse_layer_parameters(kind.snapshot(w), 1)
    model = build_model(program.flags(SMALL, TRAFFIC['samples']),
                        tuple(SMALL['image_shape']), loaded,
                        num_data=SMALL['num_data'], dtype=dtype,
                        device='cpu')
    tc = trainer.TrainConfig(optimizer='NatGrad', lr=SMALL['lr'],
                             lr_decay_steps=SMALL['lr_decay_steps'],
                             gamma=SMALL['gamma'], lr_staircase=True,
                             batch_size=TRAFFIC['batch'])
    state = trainer.init_state(model, tc, seed=SEED)
    X, Y = inputs.training_set(SMALL, SEED, 'cpu')
    return model, state, tc, X.to(dtype), Y


def rel(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / max(float(b.norm()), 1e-300))


@pytest.mark.parametrize('dtype', [torch.float64, torch.float32],
                         ids=['float64', 'float32'])
def test_elbo_and_every_gradient_against_the_reference(dtype):
    _, state, _, X, Y = small_port(dtype)
    B, S = TRAFFIC['batch'], TRAFFIC['samples']
    xb, yb = X[:B], Y[:B]
    noise = [torch.zeros((S, B, 10), dtype=dtype)]
    loss, grads = trainer.loss_and_grads(state, xb, yb, noise)
    params = {k: p.detach().double() for k, p in state.params.items()}
    assert set(params) == set(svgp.LEAVES)
    rloss, rgrads = svgp.loss_and_grads(Arith('float64'), params,
                                        xb.double(), yb[:, 0],
                                        SMALL['num_data'], S)
    assert abs(float(loss) - float(rloss)) <= RTOL[dtype] * abs(float(rloss))
    for k in svgp.LEAVES:
        assert rel(grads[k], rgrads[k]) <= RTOL[dtype], k


@pytest.mark.parametrize('dtype', [torch.float64, torch.float32],
                         ids=['float64', 'float32'])
def test_three_natgrad_chunks_against_the_reference(dtype):
    """Three eager 1-step NatGrad ``run_chunk`` calls, each with its final
    check on a fresh minibatch, against the reference's three chunks from
    the same leaves and the same stream: each ELBO, each leaf's change
    and the backoff counter."""
    _, state, tc, X, Y = small_port(dtype)
    p0 = {k: p.detach().double().clone() for k, p in state.params.items()}
    g = torch.Generator()
    g.manual_seed(SEED)
    ref = svgp.Trainer(Arith('float64'), p0, SMALL, TRAFFIC, g,
                       noise_dtype=dtype)
    for _ in range(3):
        elbo = trainer.run_chunk(state, tc, X, Y, 1, graphed=False)
        [rloss] = ref.chunk(X, Y, 1)
        assert abs(-float(elbo[0]) - float(rloss)) <= (
            RTOL[dtype] * abs(float(rloss)))
        for k in svgp.LEAVES:
            change = state.params[k].detach().double() - p0[k]
            assert rel(change, ref.params[k] - p0[k]) <= RTOL[dtype], k
        assert float(state.steps_back) == ref.steps_back
    assert all(float((ref.params[k] - p0[k]).norm()) > 0
               for k in svgp.LEAVES)
    assert int(state.step) == ref.step_count == 3


def conjugate_problem(R=2, M=8, n=20, D=3, seed=0):
    g = torch.Generator().manual_seed(seed)
    kw = dict(dtype=torch.float64)
    X = torch.randn((n, D), generator=g, **kw)
    Z = torch.randn((M, D), generator=g, **kw)
    y = torch.randn((n, R), generator=g, **kw)
    q_mu = torch.randn((M, R), generator=g, **kw)
    q_sqrt = torch.eye(M, **kw) + 0.1 * torch.randn(
        (R, M, M), generator=g, **kw).tril(-1)
    return X, Z, y, q_mu, q_sqrt


def gaussian_elbo(q_mu, q_sqrt, X, Z, y, noise_var):
    """sum_n E_q[log N(y_n | f_n, noise_var)] - KL[q(u) || p(u)] of an SVGP
    with the reference's ARD RBF (variance 2, lengthscales 1.5)."""
    ar = Arith('float64')
    variance = torch.tensor(2.0, dtype=torch.float64)
    ls = torch.full((X.shape[1],), 1.5, dtype=torch.float64)
    Kmm = svgp.kuu(ar, Z, variance, ls)
    Kmn = svgp.rbf_ard(ar, Z, X, variance, ls)
    Lm = torch.linalg.cholesky(Kmm)
    A = torch.linalg.solve_triangular(Lm, Kmn, upper=False)
    Bm = torch.linalg.solve_triangular(Lm.T, A, upper=True)
    mean = Bm.T @ q_mu
    Lq = torch.tril(q_sqrt)
    var = torch.stack([variance - (A * A).sum(0) + ((Lq[r].T @ Bm) ** 2).sum(0)
                       for r in range(q_mu.shape[1])], 1)
    ell = (-0.5 * math.log(2 * math.pi * noise_var)
           - ((y - mean) ** 2 + var) / (2 * noise_var))
    return ell.sum() - gauss_kl(ar, q_mu, q_sqrt, Kmm), Kmm, Kmn


def test_reference_natgrad_with_gamma_one_lands_on_the_optimal_q():
    """On a Gaussian likelihood the ELBO is quadratic in the expectation
    parameters, so one natural-gradient step with gamma = 1 from any q(u)
    lands on the optimum: S* = (Kmm^-1 + Kmm^-1 Kmn Knm Kmm^-1 /
    noise)^-1, mu* = S* Kmm^-1 Kmn y / noise (Titsias's q(u))."""
    X, Z, y, q_mu, q_sqrt = conjugate_problem()
    noise_var = 0.3
    leaves = [q_mu.clone().requires_grad_(True),
              q_sqrt.clone().requires_grad_(True)]
    elbo, Kmm, Kmn = gaussian_elbo(*leaves, X, Z, y, noise_var)
    d_mu, d_sqrt = torch.autograd.grad(-elbo, leaves)
    mu_new, L_new = svgp.natgrad_step(Arith('float64'), q_mu, q_sqrt,
                                      d_mu, d_sqrt, 1.0)
    Kinv = torch.linalg.inv(Kmm.detach())
    P = Kinv @ Kmn.detach()
    S_opt = torch.linalg.inv(Kinv + P @ P.T / noise_var)
    mu_opt = S_opt @ P @ y / noise_var
    assert torch.allclose(mu_new, mu_opt, rtol=0, atol=1e-9)
    for r in range(y.shape[1]):
        assert torch.allclose(L_new[r] @ L_new[r].T, S_opt, rtol=0,
                              atol=1e-9)
        assert torch.equal(L_new[r], torch.tril(L_new[r]))
    # The optimum is a fixed point of the step.
    leaves = [mu_new.clone().requires_grad_(True),
              L_new.clone().requires_grad_(True)]
    elbo, _, _ = gaussian_elbo(*leaves, X, Z, y, noise_var)
    grads = torch.autograd.grad(-elbo, leaves)
    again = svgp.natgrad_step(Arith('float64'), mu_new, L_new, *grads, 1.0)
    assert torch.allclose(again[0], mu_opt, rtol=0, atol=1e-9)


def test_reference_imports_nothing_of_jax_or_either_package():
    code = ('import sys, torch; import portbench.reference.svgp; '
            "bad = sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'deepcgp_tpu', 'deepcgp_tpu_torch'}); "
            'assert not bad, bad; '
            'assert not torch.backends.cuda.matmul.allow_tf32; '
            'assert not torch.backends.cudnn.allow_tf32')
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, '-c', code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_yardstick_counts_by_hand_at_m4():
    """R = 2, M = 4, triangles counted as triangles: tril(W^T dW) sums,
    for each of the M(M+1)/2 lower entries (i, j), M - i products of W's
    and dW's columns, sum_i (i+1)(M-i) multiply-adds a GP, whose leading
    term M^3 / 6 is the count's M^3 / 3 operations: 2 x 4^3 / 3 in all, reading W and dW and writing X, three [2, 4, 4] float32 stacks
    of 128 bytes; the factor of G 2 x 4^3 / 3, reading G and writing its
    factor; the triangle-by-triangle solve 2 x 4^3 / 3, reading W and the
    factor and writing W_new; the mean update, two triangular mat-vecs,
    2 x 2 x 4^2 = 64, reading W_new (128 bytes) and mu, dmu and writing
    mu_new (32 bytes each)."""
    big = 1024
    assert 2 * sum((i + 1) * (big - i) for i in range(big)) == \
        pytest.approx(big ** 3 / 3, rel=0.01)
    M = 4
    parts = yardstick_natgrad.natgrad_parts(2, M)
    assert [p[0] for p in parts] == ['tril(W^T dW)', 'the factor of G',
                                     'the solve W R^-T', 'the mean update']
    assert [p[1] for p in parts] == [pytest.approx(128 / 3),
                                     pytest.approx(128 / 3),
                                     pytest.approx(128 / 3), 64]
    assert [p[2] for p in parts] == [384, 256, 384, 224]
    assert yardstick_natgrad.natgrad_flops(2, M) == pytest.approx(128 + 64)
    least, bound = yardstick_natgrad.natgrad_least_s(2, M)
    assert bound == 'bytes'
    assert least == pytest.approx((384 + 256 + 384 + 224) / 3.35e12)
    # At [R, M] = [10, 1024] bytes bound every part of the update.
    for _, ops, nbytes in yardstick_natgrad.natgrad_parts(10, 1024):
        assert nbytes / 3.35e12 > ops / 165e12
    # A step at N = 2 rows, D = 3 pixels: the conditional 2NMD + 2NM^2 +
    # 2NMR + RNM^2 = 48 + 64 + 32 + 64, Kuu 2 M^2 D = 96, its factor
    # M^3 / 3 = 64 / 3 and the KL's solves RM^3 / 3 + RM^2 = 128 / 3 + 32.
    assert yardstick_natgrad.forward_flops(M, 2, 3, 2) == pytest.approx(400)
    cfg = dict(image_shape=[3, 1, 1], M=[M], num_classes=2)
    assert yardstick_natgrad.training_step_flops(cfg, 2) == pytest.approx(
        3 * 400 + 128 + 64)


@pytest.mark.parametrize('dtype,route', [(torch.float32, 'upper'),
                                         (torch.float64, 'library')],
                         ids=['float32', 'float64'])
def test_natgrad_span_and_counters_on_one_eager_step(dtype, route):
    _, state, tc, X, Y = small_port(dtype)
    before = profiling.COUNTERS.copy()
    with profiling.recording() as rec:
        trainer.run_chunk(state, tc, X, Y, 1, graphed=False)
    names = [s.name for s in rec.spans]
    assert names.count('natgrad update') == 1
    [span] = [s for s in rec.spans if s.name == 'natgrad update']
    assert rec.spans[span.parent].name == 'run_chunk'
    counts = {k: profiling.COUNTERS[k] - before[k] for k in
              ('natgrad updates', 'natgrad route upper',
               'natgrad route panels', 'natgrad route library',
               'fused adam steps')}
    assert counts == {'natgrad updates': 1, 'natgrad route upper': 0,
                      'natgrad route panels': 0, 'natgrad route library': 0,
                      'fused adam steps': 0, f'natgrad route {route}': 1}


def plant(fault, monkeypatch):
    """A fault in the timed path: half of each batch left out of the
    ELBO, the natural-gradient half skipped, or gamma doubled."""
    from deepcgp_tpu_torch.models.dgp import DGP
    from deepcgp_tpu_torch.training import optim
    if fault == 'half_batch':
        elbo = DGP.elbo

        def half(self, X, Y, **draw):
            n = X.shape[0] // 2
            return elbo(self, X[:n], Y[:n], **draw)
        monkeypatch.setattr(DGP, 'elbo', half)
    elif fault == 'natgrad_skipped':
        def skipped(params, grads, gamma, steps_back):
            ok = torch.ones((), dtype=torch.bool)
            return ([(a.detach().clone(), torch.tril(b.detach()))
                     for a, b in params], steps_back, ok)
        monkeypatch.setattr(optim, 'natgrad_step_with_backoff', skipped)
    elif fault == 'gamma_doubled':
        schedule = optim.gamma_schedule
        monkeypatch.setattr(optim, 'gamma_schedule',
                            lambda *a: 2.0 * schedule(*a))


@pytest.mark.parametrize('fault', [None, 'half_batch', 'natgrad_skipped',
                                   'gamma_doubled'])
def test_the_cell_at_a_small_size_is_correct_unless_a_fault_is_planted(
        fault, monkeypatch):
    """The harness runs the NatGrad cell's kind on the CPU at the small
    size against the cell's own limits: a sound run is correct, with the
    four checks; each fault planted in the timed path underneath is not."""
    from portbench import harness
    spec = harness.cell('mnist-svgp-m1024.train-natgrad')
    spec['config'] = dict(SMALL, gamma=spec['config']['gamma'])
    spec['traffic'] = dict(TRAFFIC)
    plant(fault, monkeypatch)
    out = harness.run_cell(spec, SEED, 0.3, False, 'cpu')
    assert list(out['checks']) == list(kind.CHECKS)
    assert out['correct'] == (fault is None), out['checks']
    assert out['failed'] == 0 and out['attempted'] > 0


def test_a_first_step_that_backs_off_is_compared():
    """At gamma 0.1 the small start's first proposal leaves the PD cone on
    both sides: the step backs off, the first gradient is still read
    (each side's own, not Adam's moment), and ``natgrad_gap`` compares
    the second step, the first one committed.  A program that backs off
    where the reference commits reads a gap near 1; a start from which
    the reference commits no step reads an infinite one."""
    cfg = dict(SMALL, gamma=0.1)
    start = kind.checked_start(cfg, TRAFFIC, SEED, 'cpu')
    ref = kind.reference(start, cfg, TRAFFIC)
    out = kind.numbers(start['readings'], ref, start['p0'])
    d = out['detail']
    assert d['steps_back'] == d['reference_steps_back'] == [1.0, 1.0, 1.0]
    assert d['natgrad_step'] == 2
    assert 0.0 < out['grad_gap'] < 1e-3
    assert out['natgrad_gap'] < 1e-3
    losses, g1, qs, p3, backs = start['readings']
    stalled = (losses, g1, [qs[0], qs[0], qs[0]], p3, [1.0, 2.0, 2.0])
    assert kind.numbers(stalled, ref, start['p0'])['natgrad_gap'] == \
        pytest.approx(1.0)
    cfg = dict(SMALL, gamma=1.0)
    start = kind.checked_start(cfg, TRAFFIC, SEED, 'cpu')
    ref = kind.reference(start, cfg, TRAFFIC)
    assert ref[4] == [1.0, 2.0, 3.0]
    assert kind.numbers(start['readings'], ref,
                        start['p0'])['natgrad_gap'] == math.inf
