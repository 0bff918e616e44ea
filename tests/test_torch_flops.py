"""The port's FLOP and byte accounting (deepcgp_tpu_torch/utils/flops.py)
against the JAX package's (deepcgp_tpu/utils/flops.py) on the CPU: the
three counts exactly equal for the same flags, at the full widths of the
flagship and M=1024 configurations (counts only: the inducing points are
given, no k-means runs), at depth 3, for a white model, a plain-RBF last
layer, and batch and S varied; the card's peak table; and the hardware
count against torch's FlopCounterMode over one CPU training step."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from deepcgp_tpu.models.builder import BuilderFlags, build_model as jbuild
from deepcgp_tpu.utils import flops as jflops

from deepcgp_tpu_torch.models.builder import build_model
from deepcgp_tpu_torch.training import trainer
from deepcgp_tpu_torch.utils import flops

FLAGSHIP = dict(M='384,384', feature_maps='10', filter_sizes='5,5',
                strides='3,1')
M1024 = dict(M='1024', feature_maps='', filter_sizes='5', strides='1',
             last_kernel='rbf')
SMALL = dict(M='8,8', feature_maps='2', filter_sizes='5,3', strides='2,1')
DEEP3 = dict(M='8,8,8', feature_maps='2,2', filter_sizes='5,3,3',
             strides='2,1,1', identity_mean=True)
CASES = {
    'flagship': (FLAGSHIP, (32, 32, 3)),
    'm1024': (M1024, (28, 28, 1)),
    'small': (SMALL, (12, 12, 1)),
    'small_white': (dict(SMALL, white=True), (12, 12, 1)),
    'small_rbf_last': (dict(SMALL, last_kernel='rbf'), (12, 12, 1)),
    'deep3': (DEEP3, (16, 16, 1)),
}


def _given_Z(flags, image, rng):
    """Inducing points of every layer, so neither builder runs k-means."""
    Ms = [int(m) for m in flags['M'].split(',')]
    fms = [int(c) for c in flags['feature_maps'].split(',') if c]
    fs = [int(f) for f in flags['filter_sizes'].split(',')]
    ss = [int(s) for s in flags['strides'].split(',')]
    (H, W), C = image[:2], image[2]
    params = {}
    for i, M in enumerate(Ms):
        if i == len(Ms) - 1 and flags.get('last_kernel') == 'rbf':
            L = H * W * C
        else:
            L = fs[i] * fs[i] * C
        params[i] = {'Z': rng.randn(M, L)}
        if i < len(fms):
            H, W = (H - fs[i]) // ss[i] + 1, (W - fs[i]) // ss[i] + 1
            C = fms[i]
    return params


def _models(case, num_samples=10):
    """The JAX and the port model of one case, float32, from the same
    inducing points."""
    flags, image = CASES[case]
    rng = np.random.RandomState(0)
    params = _given_Z(flags, image, rng)
    bflags = BuilderFlags(**flags, num_samples=num_samples)
    X = rng.randn(4, *image)
    Y = rng.randint(0, 10, size=(4, 1))
    jmodel = jbuild(bflags, X, Y, jax.random.PRNGKey(0), params,
                    dtype=jnp.float32)
    model = build_model(bflags, image, params, images=X,
                        generator=torch.Generator().manual_seed(0),
                        device='cpu')
    return jmodel, model


@pytest.mark.parametrize('case', list(CASES))
@pytest.mark.parametrize('batch,S', [(32, 10), (128, 10), (8, 2)])
def test_counts_equal_jax(case, batch, S):
    """training_step_flops, training_step_hardware_flops and
    training_step_min_bytes: exactly the JAX package's numbers."""
    jmodel, model = _models(case, num_samples=S)
    assert flops.training_step_flops(model, batch) == \
        jflops.training_step_flops(jmodel, batch)
    assert flops.training_step_hardware_flops(model, batch) == \
        jflops.training_step_hardware_flops(jmodel, batch)
    assert flops.training_step_min_bytes(model, batch) == \
        jflops.training_step_min_bytes(jmodel, batch)
    assert flops.training_step_min_bytes(model, batch, 4) == \
        jflops.training_step_min_bytes(jmodel, batch, 4)


def test_flagship_counts_scale():
    """The flagship at batch 32, S = 10: model FLOPs at most the hardware
    count; the batch-independent terms make doubling the batch cost less
    than twice; S scales only the later layers."""
    _, model = _models('flagship')
    fl = flops.training_step_flops(model, 32)
    assert 0 < fl <= flops.training_step_hardware_flops(model, 32)
    assert fl < flops.training_step_flops(model, 64) < 2 * fl
    _, model_s20 = _models('flagship', num_samples=20)
    assert fl < flops.training_step_flops(model_s20, 32) < 2 * fl


def test_device_peak(monkeypatch):
    assert np.isnan(flops.device_peak_flops('cpu'))
    assert np.isnan(flops.device_peak_flops(torch.device('cpu')))
    monkeypatch.setattr(torch.cuda, 'get_device_name',
                        lambda device=None: 'NVIDIA H100 80GB HBM3')
    assert flops.device_peak_flops(torch.device('cuda')) == 989.4e12
    assert flops.device_peak_flops('cuda:0') == 989.4e12
    monkeypatch.setattr(torch.cuda, 'get_device_name',
                        lambda device=None: 'NVIDIA A100-SXM4-80GB')
    assert np.isnan(flops.device_peak_flops('cuda'))
    assert flops.peak_flops('NVIDIA H100 PCIe') == 756.5e12


def test_hardware_count_vs_flop_counter():
    """The analytic hardware count against torch's FlopCounterMode over
    one Adam step of the small model on the CPU, within the JAX test's
    loose factor of 10 (the counter sees the products, not the Cholesky
    factors or the elementwise work); the model count stays at or below
    the hardware count."""
    _, model = _models('small', num_samples=2)
    rng = np.random.RandomState(1)
    X = torch.as_tensor(rng.randn(32, 144), dtype=torch.float32)
    Y = torch.as_tensor(rng.randint(0, 10, size=(32, 1)))
    config = trainer.TrainConfig(optimizer='Adam', batch_size=8)
    state = trainer.init_state(model, config, seed=1)
    trainer.run_chunk(state, config, X, Y, 1)           # warm
    with FlopCounterMode(display=False) as counter:
        trainer.run_chunk(state, config, X, Y, 1)
    counted = counter.get_total_flops()
    analytic = flops.training_step_hardware_flops(model, 8)
    assert counted > 0
    assert 0.1 < analytic / counted < 10.0, (analytic, counted)
    assert flops.training_step_flops(model, 8) <= analytic
