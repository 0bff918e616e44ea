"""The PyTorch port's Adam moment store against the JAX package on the
CPU: the bf16 stochastic rounding bit for bit, the 'auto' per-leaf storage
of ``scale_by_adam_storage``, and the pytree order that numbers the bf16
leaves.  Inputs are numpy arrays from a seeded RandomState handed to both
sides."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from deepcgp_tpu.models.builder import BuilderFlags, build_model as jbuild
from deepcgp_tpu.training import optim as joptim

from deepcgp_tpu_torch.models.builder import build_model
from deepcgp_tpu_torch.training import optim


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _bits(x):
    """bf16 values as their uint16 bit patterns."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(x).view(np.uint16)


def test_sr_to_bf16_bit_identical_to_jax():
    """Bit for bit the JAX package's stochastic rounding on finite inputs:
    random magnitudes, zeros, denormals, values already exact in bf16, and
    values next to an exponent boundary and to the float32 maximum, under
    several salts.  ±inf and NaN only have to stay non-finite."""
    rng = np.random.RandomState(0)
    finite = np.concatenate([
        rng.randn(2000) * np.exp(rng.uniform(-30, 30, 2000)),
        [0.0, -0.0, 1e-40, -3e-42, 1.4e-45, 1.0, -2.0, 0.5, 3.0, 1.5,
         np.nextafter(np.float32(2.0), np.float32(0.0)),
         np.nextafter(np.float32(1.0), np.float32(2.0)),
         np.float32(np.finfo(np.float32).max), -np.float32(np.finfo(np.float32).max),
         np.float32(np.finfo(np.float32).tiny)]]).astype(np.float32)
    x = finite.reshape(3, -1) if finite.size % 3 == 0 else finite
    for salt in (0, 1, 0x9E3779B9, 0xFFFFFFFF, 123456789):
        ours = optim._sr_to_bf16(_t(x), salt)
        ref = joptim._sr_to_bf16(jnp.asarray(x), jnp.asarray(salt, jnp.uint32))
        np.testing.assert_array_equal(_bits(ours), _bits(ref), err_msg=str(salt))
        exact = x.view(np.uint32) & 0xFFFF == 0
        np.testing.assert_array_equal(ours.float().numpy()[exact], x[exact])
    special = np.array([np.inf, -np.inf, np.nan], np.float32)
    for salt in (0, 77):
        assert not torch.isfinite(optim._sr_to_bf16(_t(special), salt)).any()
        assert not jnp.isfinite(joptim._sr_to_bf16(
            jnp.asarray(special), jnp.asarray(salt, jnp.uint32))).any()


def test_auto_adam_matches_jax_storage():
    """'auto' Adam against ``scale_by_adam_storage('auto')`` over 2 steps on
    a tree with two leaves of >= 2^22 float32 elements (bf16 moments,
    numbered in the JAX tree's order, here its sorted dict keys) and two
    small ones (exact moments): the bf16 moments bit-equal, the float32
    moments at rtol 1e-6, the updates at 2e-5 (under x64 JAX takes the
    bias correction in float64, the port in the parameters' float32, as
    the JAX package on its accelerator: 1 - 0.999 differs by 1.3e-5 in
    float32, 6.5e-6 after the square root)."""
    rng = np.random.RandomState(1)
    shapes = {'b_big': (4, 1024, 1024), 'a_small': (3, 4),
              'c_big': ((1 << 22) + 3,), 'd_small': ()}
    params = {k: torch.zeros(s, dtype=torch.float32) for k, s in shapes.items()}
    order = [k for k in sorted(shapes) if optim.bf16_moments(params[k])]
    state = optim.adam_init(params, order)
    assert {k: state['mu'][k].dtype for k in shapes} == {
        'b_big': torch.bfloat16, 'c_big': torch.bfloat16,
        'a_small': torch.float32, 'd_small': torch.float32}
    tx = joptim.scale_by_adam_storage('auto')
    jstate = tx.init({k: jnp.zeros(s, jnp.float32) for k, s in shapes.items()})
    for _ in range(2):
        g = {k: np.asarray(rng.randn(*s), np.float32) for k, s in shapes.items()}
        upd, state['mu'], state['nu'], state['count'] = optim.adam_updates(
            {k: _t(v) for k, v in g.items()}, state)
        jupd, jstate = tx.update({k: jnp.asarray(v) for k, v in g.items()}, jstate)
        for k in shapes:
            np.testing.assert_allclose(upd[k].numpy(), np.asarray(jupd[k]),
                                       rtol=2e-5, err_msg=k)
            for ours, ref in ((state['mu'][k], jstate.mu[k]),
                              (state['nu'][k], jstate.nu[k])):
                if ours.dtype == torch.bfloat16:
                    np.testing.assert_array_equal(_bits(ours), _bits(ref), err_msg=k)
                else:
                    np.testing.assert_allclose(ours.numpy(), np.asarray(ref),
                                               rtol=1e-6, err_msg=k)


def test_bf16_leaves_are_numbered_in_jax_pytree_order():
    """``jax_leaf_order`` visits the port's parameters and buffers in the
    JAX model's pytree order (the order that numbers the bf16 moment
    leaves): the same shapes in the same sequence, for a conv model and a
    plain-RBF one."""
    rng = np.random.RandomState(0)
    for flags, image in (
            (BuilderFlags(M='8,8', feature_maps='2', filter_sizes='3,3',
                          strides='1,1'), (6, 6, 1)),
            (BuilderFlags(M='8', feature_maps='', filter_sizes='5', strides='1',
                          last_kernel='rbf'), (6, 6, 1))):
        X = rng.randn(32, *image)
        jmodel = jbuild(flags, X, rng.randint(0, 10, (32, 1)),
                        jax.random.PRNGKey(0), dtype=jnp.float64)
        model = build_model(flags, image, images=X, dtype=torch.float64,
                            device='cpu')
        ours = [tuple(t.shape) for _, t in optim.jax_leaf_order(model)]
        ref = [tuple(np.shape(a)) for a in jax.tree_util.tree_leaves(jmodel)]
        assert ours == ref
