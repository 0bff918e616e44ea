"""The port's transposed-order patch extraction (K6) and its adjoint (K7)
against the JAX package's Pallas kernels on the CPU (interpret mode): the
plain versions at the shapes of tests/test_pallas_patches.py in float64,
K7 against every form of the Pallas col2im and against the transpose of
the slice-form reference, the adjoint identity, the patch permutation, and
the autograd Function's launches.  Inputs are seeded numpy arrays handed
to both sides."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepcgp_tpu.ops import pallas_patches as jpp
from deepcgp_tpu.ops.patches import out_size

from deepcgp_tpu_torch.ops import cuda_cross, cuda_patches

SHAPES = [
    (10, 10, 10, 5, 1, 1),   # flagship last layer
    (28, 28, 1, 5, 2, 1),    # MNIST hidden conv
    (9, 11, 3, 3, 2, 2),     # odd sizes, stride+dilation
    (32, 32, 3, 5, 3, 1),    # CIFAR first layer
    (6, 6, 1, 3, 1, 2),      # dilation-only
    (14, 14, 10, 5, 1, 1),   # CIFAR strides 2,1 last layer (C = 10)
    (9, 8, 10, 3, 2, 1),     # C = 10, stride 2
]
N = 3


def _image(seed, H, W, C):
    return np.random.RandomState(seed).randn(N, H, W, C)


def _cotangent(seed, H, W, C, f, s, d):
    P = out_size(H, f, s, d) * out_size(W, f, s, d)
    return np.random.RandomState(seed).randn(N, P, f * f * C)


@pytest.mark.parametrize('H,W,C,f,s,d', SHAPES)
def test_k6_plain_equals_pallas(H, W, C, f, s, d):
    x = _image(0, H, W, C)
    ref = np.asarray(jpp.extract_patches_transposed(jnp.asarray(x), f, s, d))
    out = cuda_patches.extract_patches_transposed(torch.tensor(x), f, s, d)
    assert tuple(out.shape) == ref.shape
    np.testing.assert_array_equal(out.numpy(), ref)
    assert cuda_patches.extract_patches_transposed.launches == 0


@pytest.mark.parametrize('form', ['rmw', 'tree', 'dot'])
@pytest.mark.parametrize('H,W,C,f,s,d', SHAPES)
def test_k7_plain_matches_pallas_col2im(H, W, C, f, s, d, form, monkeypatch):
    """K7's plain version against the Pallas col2im in each of its three
    forms (the same map, summed in other orders) and against the JAX
    transpose of the slice-form reference: reassociation only, rtol 1e-11,
    atol 1e-13.  Pixels no patch covers (stride or dilation > 1) are 0."""
    monkeypatch.setenv('DEEPCGP_COL2IM_FORM', form)
    g = _cotangent(1, H, W, C, f, s, d)
    pallas = np.asarray(jpp._pallas_col2im(jnp.asarray(g), (N, H, W, C), f, s,
                                           d, interpret=True))
    transpose = jax.linear_transpose(
        lambda im: jpp._ref_transposed(im, f, s, d),
        jax.ShapeDtypeStruct((N, H, W, C), jnp.float64))
    ref, = transpose(jnp.asarray(g))
    out = cuda_patches.col2im_transposed(torch.tensor(g), (H, W, C), f, s, d)
    assert tuple(out.shape) == (N, H, W, C)
    for want in (pallas, np.asarray(ref)):
        np.testing.assert_allclose(out.numpy(), want, rtol=1e-11, atol=1e-13)
    assert cuda_patches.col2im_transposed.launches == 0


@pytest.mark.parametrize('H,W,C,f,s,d', SHAPES)
def test_adjoint_identity(H, W, C, f, s, d):
    """<K6(x), g> == <x, K7(g)>."""
    x = torch.tensor(_image(2, H, W, C))
    g = torch.tensor(_cotangent(3, H, W, C, f, s, d))
    lhs = float((cuda_patches.extract_patches_transposed(x, f, s, d) * g).sum())
    rhs = float((x * cuda_patches.col2im_transposed(g, (H, W, C), f, s, d)).sum())
    assert abs(lhs - rhs) <= 1e-12 * max(abs(lhs), 1.0)


@pytest.mark.parametrize('Hout,Wout', [(6, 6), (24, 24), (4, 5), (10, 3), (1, 7)])
def test_transposed_patch_perm_equals_jax(Hout, Wout):
    perm = cuda_patches.transposed_patch_perm(Hout, Wout)
    assert perm.dtype == torch.int64
    np.testing.assert_array_equal(perm.numpy(),
                                  jpp.transposed_patch_perm(Hout, Wout))


def test_tf_and_transposed_pixel_index_agree():
    """The transposed col2im equals the TF-order one of the cotangent
    permuted back to TF patch order."""
    H, W, C, f, s, d = SHAPES[2]
    g = torch.tensor(_cotangent(4, H, W, C, f, s, d))
    perm = cuda_patches.transposed_patch_perm(out_size(H, f, s, d),
                                              out_size(W, f, s, d))
    g_tf = torch.empty_like(g)
    g_tf[:, perm] = g
    np.testing.assert_allclose(
        cuda_patches.col2im_transposed(g, (H, W, C), f, s, d).numpy(),
        cuda_cross.col2im(g_tf, (H, W, C), f, s, d).numpy(), rtol=1e-12,
        atol=1e-14)


@pytest.mark.parametrize('image_grad', [False, True])
def test_autograd_runs_k7_only_for_an_image_gradient(image_grad, monkeypatch):
    """The autograd Function extracts once (K6) and calls K7 in the
    backward exactly once when the image needs a gradient, never when it
    does not (JAX's custom VJP runs no col2im then either); its image
    gradient is K7 of the cotangent."""
    calls = {'k6': 0, 'k7': 0}

    def count(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(cuda_patches, 'extract_patches_transposed_plain',
                        count('k6', cuda_patches.extract_patches_transposed_plain))
    monkeypatch.setattr(cuda_patches, 'col2im_transposed_plain',
                        count('k7', cuda_patches.col2im_transposed_plain))
    H, W, C, f, s, d = SHAPES[2]
    x = torch.tensor(_image(5, H, W, C), requires_grad=image_grad)
    weight = torch.tensor(np.random.RandomState(6).rand(f * f * C),
                          requires_grad=True)
    g = torch.tensor(_cotangent(7, H, W, C, f, s, d))
    patches = cuda_patches.transposed_patches(x, f, s, d)
    ((patches * weight) * g).sum().backward()
    assert calls == {'k6': 1, 'k7': int(image_grad)}
    np.testing.assert_allclose(weight.grad.numpy(),
                               (patches.detach() * g).sum((0, 1)).numpy(),
                               rtol=1e-12)
    if image_grad:
        np.testing.assert_allclose(
            x.grad.numpy(), cuda_patches.col2im_transposed_plain(
                g * weight.detach(), (H, W, C), f, s, d).numpy(), rtol=1e-12)


def test_wrappers_refuse_other_devices():
    """Off the CPU the wrappers launch or raise: a tensor on another device
    is refused, never computed by the plain version."""
    x = torch.zeros(2, 6, 6, 1, device='meta')
    with pytest.raises(ValueError, match='unsupported device'):
        cuda_patches.extract_patches_transposed(x, 3)
    with pytest.raises(ValueError, match='unsupported device'):
        cuda_patches.col2im_transposed(torch.zeros(2, 16, 9, device='meta'),
                                       (6, 6, 1), 3)
