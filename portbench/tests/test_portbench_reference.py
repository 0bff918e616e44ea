"""The plain reference against ``deepcgp_tpu_torch`` on the CPU at a tiny
size, both in float64 on the same parameters, inputs and noise: the ELBO,
every gradient, one Adam step, the bf16 moment store and the class
probabilities."""

import numpy as np
import pytest
import torch

from portbench import inputs, program
from portbench.reference import convgp as ref
from portbench.tests.conftest import TINY

F64 = ref.Arith('float64')


@pytest.fixture(scope='module')
def setup():
    from deepcgp_tpu_torch.models.builder import build_model
    from deepcgp_tpu_torch.utils.checkpoint import parse_layer_parameters
    weights = inputs.weights(TINY, 5, 'cpu')
    _, loaded = parse_layer_parameters(program.snapshot(weights), 2)
    model = build_model(program.flags(TINY, 3), tuple(TINY['image_shape']),
                        loaded, num_data=TINY['num_data'],
                        dtype=torch.float64, device='cpu')
    spec = ref.Spec(TINY)
    g = torch.Generator().manual_seed(3)
    B, S = 6, 3
    X = torch.randn((B, 12 * 12 * 3), generator=g, dtype=torch.float64)
    Y = torch.randint(0, 10, (B,), generator=g)
    noise = [torch.randn((S, B, spec.outputs(i)), generator=g,
                         dtype=torch.float64) for i in range(spec.depth)]
    params = {k: p.detach().clone() for k, p in model.named_parameters()}
    assert set(params) == set(spec.leaf_names())
    anchors = {0: model.layers[0].Z0.clone()}
    return model, spec, X, Y, noise, params, anchors


def rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


def reference_elbo(spec, X, Y, noise, params, anchors):
    return ref.elbo(F64, spec, params, anchors, X.reshape(-1, 12, 12, 3), Y,
                    noise, TINY['num_data'])


def test_elbo_and_gradients(setup):
    model, spec, X, Y, noise, params, anchors = setup
    leaves = dict(model.named_parameters())
    for p in leaves.values():
        p.requires_grad_(True)
    elbo = model.elbo(X, Y[:, None], noise=noise)
    grads = torch.autograd.grad(elbo, list(leaves.values()))
    ref_params = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    relbo = reference_elbo(spec, X, Y, noise, ref_params, anchors)
    rgrads = torch.autograd.grad(relbo, [ref_params[k] for k in leaves])
    elbo, relbo = float(elbo.detach()), float(relbo.detach())
    assert abs(elbo - relbo) <= 1e-10 * abs(relbo)
    for k, a, b in zip(leaves, grads, rgrads):
        assert rel(a, b) <= 1e-8, k


def test_probabilities(setup):
    model, spec, X, _, noise, params, _ = setup
    with torch.no_grad():
        probs = model.predict_y(X, noise[0].shape[0], noise=noise)[0].mean(0)
    rprobs = ref.predict_proba(F64, spec, params, X.reshape(-1, 12, 12, 3),
                               noise)
    assert rel(probs, rprobs) <= 1e-10
    assert float(rprobs.std(1).min()) > 1e-3     # the classes differ


def test_one_adam_step(setup):
    from deepcgp_tpu_torch.training import optim
    _, _, _, _, _, params, _ = setup
    g = torch.Generator().manual_seed(4)
    grads = {k: torch.randn(p.shape, generator=g, dtype=p.dtype)
             for k, p in params.items()}
    state = optim.adam_init(params)
    updates, *_ = optim.adam_updates(grads, state)
    lr = ref.learning_rate(TINY['lr'], TINY['lr_decay_steps'], 0, True)
    mine = {k: p.clone() for k, p in params.items()}
    ref.Adam(mine, TINY['lr'], TINY['lr_decay_steps'], True, g).step(mine,
                                                                     grads)
    for k, p in params.items():
        assert rel(mine[k], p - lr * updates[k]) <= 1e-12, k


@pytest.mark.parametrize('continuous', [False, True])
def test_the_learning_rate_schedule_is_the_programs(continuous):
    from deepcgp_tpu_torch.training import optim
    schedule = optim.learning_rate_schedule(0.01, 3, staircase=not continuous)
    for step in range(8):
        lr = float(schedule(torch.tensor(step), torch.float64))
        assert lr == pytest.approx(
            ref.learning_rate(0.01, 3, step, continuous), rel=1e-14)


def test_the_bf16_store_rounds_to_a_neighbour_without_bias():
    from deepcgp_tpu_torch.training import optim
    g = torch.Generator().manual_seed(6)
    x = torch.randn(1 << 16, generator=g) * 10.0 ** torch.randint(
        -6, 6, (1 << 16,), generator=g)
    down = (x.view(torch.int32) & -65536).view(torch.float32)
    ulp = (down.view(torch.int32) + 65536).view(torch.float32) - down
    for rounded in (ref.sr_bf16(x, g), optim._sr_to_bf16(x, 7).float()):
        step = (rounded - x).abs()
        assert bool((step < ulp.abs()).all())
        assert bool((rounded.abs() >= down.abs()).all())
    exact = torch.tensor([1.0, -2.5, 0.0])
    assert torch.equal(ref.sr_bf16(exact, g), exact)
    one = torch.full((1 << 16,), 1.0 + 2 ** -10)
    assert abs(float(ref.sr_bf16(one, g).double().mean()) - (1 + 2 ** -10)) < 2e-5


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11,
                      -3.0 - 2 ** -12], dtype=torch.float32)
    want = torch.tensor([1.0 + 2 ** -10, 1.0, 1.0 + 2 ** -9, -3.0])
    assert torch.equal(ref.tf32_round(x), want)
    a = torch.randn(5, 7, dtype=torch.float32, requires_grad=True)
    b = torch.randn(7, 3, dtype=torch.float32, requires_grad=True)
    out = ref.Arith('tf32').mm(a, b)
    assert rel(out.detach(), (a @ b).detach()) < 3e-3
    out.sum().backward()
    assert a.grad.shape == a.shape and b.grad.shape == b.shape


def test_patches_are_in_the_snapshots_order():
    X = torch.arange(2 * 5 * 5 * 2, dtype=torch.float64).reshape(2, 5, 5, 2)
    p = ref.patches(X, 3, 2)
    assert p.shape == (2, 4, 18)
    assert np.array_equal(p[1, 3].numpy(), X[1, 2:5, 2:5, :].reshape(-1).numpy())
