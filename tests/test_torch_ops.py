"""Parity of the PyTorch port's ops (deepcgp_tpu_torch/ops) with the JAX
package on the CPU: the plain versions of the two CUDA kernels against the
Pallas kernels they replace (interpret mode), and the plain tensor ops
against their JAX functions.  Inputs are numpy arrays from a seeded
RandomState handed to both sides; float64 unless a test says otherwise."""

import ast
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepcgp_tpu.models.base_kernels import RBF as JRBF
from deepcgp_tpu.models.conv_kernels import (AdditivePatchKernel as JAdd,
                                             ConvKernel as JConv)
from deepcgp_tpu.models.views import FullView as JFullView
from deepcgp_tpu.ops import conditional as jcond
from deepcgp_tpu.ops import distances as jdist
from deepcgp_tpu.ops import linalg as jlinalg
from deepcgp_tpu.ops import pallas_cross, pallas_linalg
from deepcgp_tpu.ops import patches as jpatches

from deepcgp_tpu_torch.models.base_kernels import RBF
from deepcgp_tpu_torch.models.conv_kernels import AdditivePatchKernel, ConvKernel
from deepcgp_tpu_torch.models.views import FullView
from deepcgp_tpu_torch.ops import conditional, cuda_cross, cuda_linalg, distances, patches

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _spd(rng, B, M, jitter=2.0):
    A = rng.randn(B, M, M)
    return A @ np.swapaxes(A, -1, -2) / M + jitter * np.eye(M)


# ------------------------------------------------------------ no JAX


_FORBIDDEN = ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'deepcgp_tpu',
              'tensorboardX', 'tensorboard', 'PIL', 'matplotlib')


def _port_files():
    return sorted((ROOT / 'deepcgp_tpu_torch').rglob('*.py')) + [ROOT / 'chip_smoke.py']


@pytest.mark.parametrize('path', _port_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax(path):
    """No import statement of the port or of chip_smoke.py names JAX, its
    libraries, the JAX package (deepcgp_tpu_torch itself is allowed) or a
    package the card's machine lacks (tensorboardX, tensorboard, PIL,
    matplotlib)."""
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or '']
        else:
            continue
        for name in names:
            assert name.split('.')[0] not in _FORBIDDEN, (path, node.lineno, name)
    text = path.read_text()
    for call in ('__import__(', 'import_module('):
        assert call not in text, (path, call)


def test_port_loads_no_jax_module():
    """Importing every module of the port pulls in no JAX module."""
    mods = [f'deepcgp_tpu_torch.{p.relative_to(ROOT / "deepcgp_tpu_torch").with_suffix("")}'
            .replace('/', '.').replace('.__init__', '')
            for p in (ROOT / 'deepcgp_tpu_torch').rglob('*.py')]
    code = ('import importlib, sys\n'
            f'for m in {mods!r}: importlib.import_module(m)\n'
            'bad = [m for m in sys.modules if m.split(".")[0] in '
            f'{_FORBIDDEN!r}]\n'
            'print(bad); sys.exit(1 if bad else 0)\n')
    out = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


# ------------------------------------------------------------ K1


def test_chol_inv_base_plain_matches_pallas():
    rng = np.random.RandomState(0)
    S = _spd(rng, 3, 64)
    Lj, Lij = pallas_linalg.chol_inv_base(jnp.asarray(S), interpret=True)
    L, Li = cuda_linalg.chol_inv_base(_t(S))
    np.testing.assert_allclose(L.numpy(), np.asarray(Lj), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(Li.numpy(), np.asarray(Lij), rtol=1e-9, atol=1e-12)
    assert cuda_linalg.chol_inv_base.launches == 0   # the CPU never launches


def test_chol_inv_batched_f32_matches_pallas_driver():
    """The port's blocked driver (plain base case on the CPU) against the
    JAX driver with its Pallas base in interpret mode, float32 at [2, 128,
    128]: both run the same block identities in full f32, so they agree to
    a few f32 ulps of the factor's scale (tolerance 2e-5 of max|.|)."""
    rng = np.random.RandomState(1)
    S = _spd(rng, 2, 128).astype(np.float32)
    Lj, Lij = pallas_linalg.chol_inv_batched(jnp.asarray(S), interpret=True)
    L, Li = cuda_linalg.chol_inv_batched(_t(S))
    for a, b in ((L, Lj), (Li, Lij)):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=2e-5 * np.abs(b).max())
        assert (np.triu(a.numpy(), 1) == 0).all()


def test_chol_non_pd_gives_nan_on_both_sides():
    rng = np.random.RandomState(2)
    S = _spd(rng, 3, 128).astype(np.float32)
    S[1] = -np.eye(128)
    Lj, Lij = pallas_linalg.chol_inv_batched(jnp.asarray(S), interpret=True)
    L, Li = cuda_linalg.chol_inv_batched(_t(S))
    for a in (np.asarray(Lj), np.asarray(Lij), L.numpy(), Li.numpy()):
        assert not np.isfinite(a[1]).all()
        assert np.isfinite(a[0]).all() and np.isfinite(a[2]).all()


@pytest.mark.parametrize('dtype,M', [(np.float64, 128), (np.float32, 96),
                                     (np.float32, 64)])
def test_chol_with_inv_matches_jax(dtype, M):
    """The gate: f32 with M % 64 == 0 takes the driver, anything else the
    library factor plus one triangular solve -- the same pair either way."""
    from deepcgp_tpu_torch.ops import linalg
    rng = np.random.RandomState(3)
    S = _spd(rng, 2, M).astype(dtype)
    Lj, Lij = jlinalg.chol_with_inv(jnp.asarray(S))
    L, Li = linalg.chol_with_inv(_t(S))
    tol = 1e-10 if dtype == np.float64 else 2e-5
    for a, b in ((L, Lj), (Li, Lij)):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=tol * np.abs(b).max())


# ------------------------------------------------------------ K4

GEOMS = [
    # (H, W, C, f, s, d, M): flagship last layer, digits last layer,
    # stride and dilation (the geometries of tests/test_pallas_cross.py).
    (10, 10, 10, 5, 1, 1, 24),
    (8, 8, 1, 3, 1, 1, 16),
    (9, 11, 3, 3, 2, 1, 10),
    (12, 12, 2, 3, 1, 2, 12),
]


def _kernels(H, W, C, f, s, d, M, jcls, tcls, seed=0):
    rng = np.random.RandomState(seed)
    jview = JFullView(input_size=(H, W), filter_size=f, feature_maps=C,
                      stride=s, dilation=d)
    jbase = JRBF.create(variance=1.3, lengthscales=0.9, dtype=jnp.float64)
    w = rng.rand(jview.patch_count) + 0.5
    jk = jcls.create(jbase, jview, patch_weights=jnp.asarray(w), dtype=jnp.float64)
    view = FullView(input_size=(H, W), filter_size=f, feature_maps=C,
                    stride=s, dilation=d)
    base = RBF(_t(jbase.raw_variance), _t(jbase.raw_lengthscales))
    tk = tcls(base, _t(w), view)
    X = rng.randn(6, H * W * C)
    Z = rng.randn(M, view.patch_length)
    return jk, tk, X, Z


@pytest.mark.parametrize('cls', ['conv', 'add'])
@pytest.mark.parametrize('H,W,C,f,s,d,M', GEOMS)
def test_kzx_and_kdiag_matches_pallas(H, W, C, f, s, d, M, cls, monkeypatch):
    jcls, tcls = {'conv': (JConv, ConvKernel), 'add': (JAdd, AdditivePatchKernel)}[cls]
    jk, tk, X, Z = _kernels(H, W, C, f, s, d, M, jcls, tcls)
    monkeypatch.setenv('DEEPCGP_PALLAS_CROSS', '1')
    assert pallas_cross.kernel_supported(jk) and cuda_cross.supported(tk)
    kzx_j, kd_j = jk.Kzx_NM_and_Kdiag(jnp.asarray(Z), jnp.asarray(X))
    kzx, kd = cuda_cross.kzx_and_kdiag(tk, _t(Z), _t(X))
    np.testing.assert_allclose(kzx.numpy(), np.asarray(kzx_j), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(kd.numpy(), np.asarray(kd_j), rtol=1e-10, atol=1e-12)
    assert cuda_cross.conv_rbf_cross.launches == 0


def test_padded_zt_built_once_per_inducing_matrix():
    """The kernel's transposed, tile-padded copy of Z is reused while Z is
    the same tensor, and rebuilt for another Z or after an in-place write."""
    Z = torch.randn(200, 7)
    Zt = cuda_cross._padded_zt(Z)
    assert tuple(Zt.shape) == (7, 256)
    np.testing.assert_array_equal(Zt[:, :200].numpy(), Z.T.numpy())
    assert (Zt[:, 200:] == 0).all()
    assert cuda_cross._padded_zt(Z) is Zt
    Z.mul_(2.0)
    Zt2 = cuda_cross._padded_zt(Z)
    assert Zt2 is not Zt
    np.testing.assert_array_equal(Zt2[:, :200].numpy(), Z.T.numpy())
    assert cuda_cross._padded_zt(Z.clone()) is not Zt2


def test_cross_gate():
    """ARD lengthscales are refused; a geometry whose patch matrix outgrows
    one block's shared memory is refused (the JAX gate's VMEM check), and
    a direct call of the fused evaluation there raises (models route such
    kernels unfused)."""
    view = FullView(input_size=(10, 10), filter_size=5, feature_maps=10)
    ard = RBF.create(1.0, 1.0, ard_dim=250, dtype=torch.float64)
    assert not cuda_cross.supported(ConvKernel.create(ard, view, dtype=torch.float64))
    iso = RBF.create(1.0, 1.0, dtype=torch.float64)
    assert cuda_cross.supported(ConvKernel.create(iso, view, dtype=torch.float64))
    big = FullView(input_size=(128, 128), filter_size=9, feature_maps=8)
    k_big = ConvKernel.create(iso, big, dtype=torch.float64)
    assert not cuda_cross.supported(k_big)
    with pytest.raises(NotImplementedError):
        cuda_cross.kzx_and_kdiag(k_big, torch.zeros(4, big.patch_length),
                                 torch.zeros(1, 128 * 128 * 8))


# ------------------------------------------------------------ plain ops


@pytest.mark.parametrize('self_gram', [True, False])
def test_square_distance(self_gram):
    rng = np.random.RandomState(4)
    X = rng.randn(3, 7, 5) * 3 + 10
    X2 = None if self_gram else rng.randn(1, 9, 5)
    ref = jdist.square_distance(jnp.asarray(X),
                                None if X2 is None else jnp.asarray(X2))
    out = distances.square_distance(_t(X), None if X2 is None else _t(X2))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-10, atol=1e-10)
    assert (out >= 0).all()


@pytest.mark.parametrize('H,W,C,f,s,d', [(32, 32, 3, 5, 3, 1), (10, 10, 10, 5, 1, 1),
                                         (9, 11, 3, 3, 2, 1), (12, 12, 2, 3, 1, 2)])
def test_extract_patches_tf_order(H, W, C, f, s, d):
    rng = np.random.RandomState(5)
    X = rng.randn(2, H, W, C)
    ref = jpatches.extract_patches(jnp.asarray(X), f, s, d)
    out = patches.extract_patches(_t(X), f, s, d)
    assert tuple(out.shape) == ref.shape
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize('white', [True, False])
def test_multi_output_conditional(white):
    rng = np.random.RandomState(6)
    P, N, M, R = 3, 5, 8, 2
    Z = rng.randn(M, 4)
    Kmm = np.exp(-0.5 * ((Z[:, None] - Z[None]) ** 2).sum(-1)) + 1e-2 * np.eye(M)
    Kmn = rng.rand(P, N, M) * 0.5
    Knn = np.ones((P, N))
    f = rng.randn(M, R)
    q_sqrt = np.tril(rng.randn(R, M, M)) * 0.3
    Lm = np.linalg.cholesky(Kmm)
    Lm_inv = np.linalg.inv(Lm)
    mj, vj = jcond.multi_output_conditional(
        jnp.asarray(Kmn), None, jnp.asarray(Knn), jnp.asarray(f),
        q_sqrt=jnp.asarray(q_sqrt), white=white, Lm=jnp.asarray(Lm),
        Lm_inv=jnp.asarray(Lm_inv), layout='pnm')
    m, v = conditional.multi_output_conditional(
        _t(Kmn), _t(Knn), _t(f), Lm_inv=_t(Lm_inv), q_sqrt=_t(q_sqrt), white=white)
    np.testing.assert_allclose(m.numpy(), np.asarray(mj), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(v.numpy(), np.asarray(vj), rtol=1e-10, atol=1e-12)


def test_lower_triangular_pack_roundtrip():
    from deepcgp_tpu.utils import transforms as jtr
    from deepcgp_tpu_torch.utils import transforms
    rng = np.random.RandomState(7)
    mats = np.tril(rng.randn(3, 5, 5))
    packed = transforms.lower_triangular_flatten(_t(mats))
    np.testing.assert_array_equal(
        packed.numpy(), np.asarray(jtr.lower_triangular_flatten(jnp.asarray(mats))))
    np.testing.assert_array_equal(
        transforms.lower_triangular_unflatten(packed, 5).numpy(), mats)
    x = rng.randn(7) * 10
    np.testing.assert_allclose(
        transforms.positive_forward(_t(x)).numpy(),
        np.asarray(jtr.positive_forward(jnp.asarray(x))), rtol=1e-12)
    np.testing.assert_allclose(
        transforms.positive_backward(np.abs(x) + 1e-3),
        jtr.positive_backward(np.abs(x) + 1e-3), rtol=1e-12)


@pytest.mark.parametrize('cls', ['conv', 'add'])
def test_kdiag_alone_matches_jax(cls):
    jcls, tcls = {'conv': (JConv, ConvKernel), 'add': (JAdd, AdditivePatchKernel)}[cls]
    jk, tk, X, _ = _kernels(9, 11, 3, 3, 2, 1, 4, jcls, tcls)
    np.testing.assert_allclose(tk.Kdiag(_t(X)).numpy(),
                               np.asarray(jk.Kdiag(jnp.asarray(X))), rtol=1e-10)
