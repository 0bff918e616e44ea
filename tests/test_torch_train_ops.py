"""Parity of the PyTorch port's training ops with the JAX package on the
CPU: the plain version of the K5 backward against ``jax.grad`` through the
fused Pallas kernel (interpret mode), the differentiable linear algebra
against JAX's custom VJPs and against plain torch autograd, and the fresh
initialisation (k-means, patch sampling, identity convolution, the
builder's q_sqrt) given the same draws.  Inputs come from seeded numpy;
float64 throughout."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepcgp_tpu.models import builder as jbuilder
from deepcgp_tpu.models.base_kernels import RBF as JRBF
from deepcgp_tpu.models.conv_kernels import (AdditivePatchKernel as JAdd,
                                             ConvKernel as JConv)
from deepcgp_tpu.models.inducing import patch_inducing_points as jpatch_points
from deepcgp_tpu.models.views import FullView as JFullView
from deepcgp_tpu.native import sample_patches as jsample_patches
from deepcgp_tpu.ops import linalg as jlinalg
from deepcgp_tpu.ops.kmeans import kmeans as jkmeans
from deepcgp_tpu.utils import checkpoint as jckpt

from deepcgp_tpu_torch.models import builder, inducing
from deepcgp_tpu_torch.models.base_kernels import RBF
from deepcgp_tpu_torch.models.conv_kernels import AdditivePatchKernel, ConvKernel
from deepcgp_tpu_torch.models.layers import ConvLayer
from deepcgp_tpu_torch.models.views import FullView
from deepcgp_tpu_torch.ops import cuda_cross, linalg
from deepcgp_tpu_torch.ops.kmeans import kmeans
from deepcgp_tpu_torch.utils import checkpoint

GEOMS = [
    # (H, W, C, f, s, d, M): flagship last layer, digits last layer, stride
    # and dilation (the geometries of tests/test_pallas_cross.py).
    (10, 10, 10, 5, 1, 1, 24),
    (8, 8, 1, 3, 1, 1, 16),
    (9, 11, 3, 3, 2, 1, 10),
    (12, 12, 2, 3, 1, 2, 12),
]


def _t(a, grad=False):
    return torch.tensor(np.array(a), requires_grad=grad)


def _spd(rng, B, M, jitter=2.0):
    A = rng.randn(B, M, M)
    return A @ np.swapaxes(A, -1, -2) / M + jitter * np.eye(M)


def _close(a, b, rtol, what=''):
    """rtol elementwise, with an absolute floor of rtol times the array's
    largest magnitude: elements far below the array's scale carry its
    rounding, not the formula's."""
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    np.testing.assert_allclose(a, b, rtol=rtol,
                               atol=rtol * np.abs(b).max(),
                               err_msg=what)


# ------------------------------------------------------------ K5


@pytest.mark.parametrize('cls', ['conv', 'add'])
@pytest.mark.parametrize('H,W,C,f,s,d,M', GEOMS)
def test_k5_plain_backward_matches_pallas(H, W, C, f, s, d, M, cls, monkeypatch):
    """All five gradients of (Kzx, Kdiag) -- images, Z, raw variance, raw
    lengthscale, patch weights -- from the port's plain backward against
    jax.grad through the fused Pallas kernel (K5 in interpret mode)."""
    monkeypatch.setenv('DEEPCGP_PALLAS_FORCE', '1')
    monkeypatch.setenv('DEEPCGP_PALLAS_CROSS', '1')
    jcls, tcls = {'conv': (JConv, ConvKernel), 'add': (JAdd, AdditivePatchKernel)}[cls]
    rng = np.random.RandomState(1)
    jview = JFullView(input_size=(H, W), filter_size=f, feature_maps=C,
                      stride=s, dilation=d)
    # Random patches sit ~sqrt(2L) apart: a lengthscale of sqrt(L)/2 keeps
    # the kernel values (and every gradient) away from underflow.
    jbase = JRBF.create(variance=1.3, lengthscales=0.5 * np.sqrt(jview.patch_length),
                        dtype=jnp.float64)
    w = rng.rand(jview.patch_count) + 0.5
    jk = jcls.create(jbase, jview, patch_weights=jnp.asarray(w), dtype=jnp.float64)
    X = rng.randn(6, H * W * C)
    Z = rng.randn(M, jview.patch_length)
    ckzx = rng.randn(6, M)
    ckd = rng.randn(6)

    def loss(kernel, Z_, X_):
        kzx, kd = kernel.Kzx_NM_and_Kdiag(Z_, X_)
        return jnp.sum(kzx * ckzx) + jnp.sum(kd * ckd)

    gk, gZ, gX = jax.grad(loss, argnums=(0, 1, 2))(jk, jnp.asarray(Z), jnp.asarray(X))

    view = FullView(input_size=(H, W), filter_size=f, feature_maps=C,
                    stride=s, dilation=d)
    tk = tcls(RBF(_t(jbase.raw_variance), _t(jbase.raw_lengthscales)), _t(w), view)
    for p in tk.parameters():
        p.requires_grad_(True)
    Xt, Zt = _t(X, True), _t(Z, True)
    kzx, kd = cuda_cross.kzx_and_kdiag(tk, Zt, Xt)
    ((kzx * _t(ckzx)).sum() + (kd * _t(ckd)).sum()).backward()
    _close(Xt.grad, gX, 1e-8, 'images')
    _close(Zt.grad, gZ, 1e-8, 'Z')
    _close(tk.base_kernel.raw_variance.grad, gk.base_kernel.raw_variance, 1e-8, 'var')
    _close(tk.base_kernel.raw_lengthscales.grad, gk.base_kernel.raw_lengthscales,
           1e-8, 'lengthscale')
    _close(tk.patch_weights.grad, gk.patch_weights, 1e-8, 'patch weights')
    assert cuda_cross.conv_rbf_cross_bwd.launches == 0   # the CPU never launches


def test_k5_plain_backward_masks_strictly():
    """A patch that equals an inducing patch sits at D == 0, the clamp's
    kink: the plain backward takes the kernel's strict mask (no gradient
    through max(D, 0) there), where autograd of clamp_min would pass it."""
    rng = np.random.RandomState(3)
    # Small integers: every sum below is exact, so D is exactly 0 there.
    X = torch.tensor(rng.randint(-2, 3, size=(2, 4, 4, 1)).astype(np.float64))
    patches = cuda_cross.extract_patches(X, 3)
    Z = torch.cat([patches[0, :1],
                   torch.tensor(rng.randint(-2, 3, size=(3, 9)).astype(np.float64))])
    var, gamma = torch.tensor(1.2), torch.tensor(-0.3)
    u = torch.full((4,), 0.25, dtype=torch.float64)
    dkzx = torch.tensor(rng.randn(2, 4))
    D = (patches.square().sum(-1)[:, :, None] + Z.square().sum(-1)
         - 2.0 * patches @ Z.T)
    assert float(D[0, 0, 0]) == 0.0
    out = cuda_cross.conv_rbf_cross_bwd_plain(X, Z, var, gamma, u, u, 3, 1, 1,
                                              False, dkzx, torch.zeros(2))
    # Reference: the same gradient with the coincident pair's T zeroed.
    Xr, Zr = X.clone().requires_grad_(True), Z.clone().requires_grad_(True)
    pr = cuda_cross.extract_patches(Xr, 3)
    Dr = (pr.square().sum(-1)[:, :, None] + Zr.square().sum(-1)
          - 2.0 * pr @ Zr.T)
    Dm = torch.where(Dr > 0, Dr, Dr.detach().clamp_min(0.0))
    K = var * torch.exp(gamma * Dm)
    (torch.einsum('npm,p->nm', K, u) * dkzx).sum().backward()
    np.testing.assert_allclose(out[0].numpy(), Xr.grad.numpy(), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(out[1].numpy(), Zr.grad.numpy(), rtol=1e-10, atol=1e-12)


def test_k5_gate():
    """The backward's cluster image side takes one warp per 8 patch rows
    (P <= 64) and at most 4 column tiles (L <= 512) within one block's
    shared memory: the flagship's last layer fits; a 28 x 28 MNIST layer
    (P = 576) takes the row-tiled image side (L <= 512 there too), so it
    trains on the fused route as well; what neither takes trains unfused
    (K6/K7, cuda_cross.fused_fits), and a direct CUDA call of K5 outside
    the gate raises, never falls back."""
    assert cuda_cross.bwd_fits(36, 250)
    assert cuda_cross.bwd_fits(64, 256) and cuda_cross.bwd_fits(8, 512)
    assert not cuda_cross.bwd_fits(64, 512)   # shared memory
    assert cuda_cross.bwd_route(576, 25) == 'tiled'
    assert not cuda_cross.bwd_fits(576, 513)
    assert not cuda_cross.bwd_fits(36, 513)
    assert cuda_cross.bwd_smem_bytes(36, 250) < cuda_cross.SMEM_LIMIT


def test_col2im_is_the_adjoint_of_extraction():
    rng = np.random.RandomState(4)
    X = torch.tensor(rng.randn(2, 9, 11, 3))
    dP = torch.tensor(rng.randn(2, 4 * 5, 27))
    lhs = (cuda_cross.extract_patches(X, 3, 2, 1) * dP).sum()
    rhs = (X * cuda_cross.col2im(dP, (9, 11, 3), 3, 2, 1)).sum()
    assert abs(float(lhs - rhs)) < 1e-10 * abs(float(lhs))


# ------------------------------------------------------------ linear algebra


def test_chol_with_inv_backward():
    """The products-only backward against JAX's custom VJP and against
    torch autograd through cholesky + inverse."""
    rng = np.random.RandomState(5)
    K = _spd(rng, 2, 12)
    gL, gLi = np.tril(rng.randn(2, 12, 12)), np.tril(rng.randn(2, 12, 12))
    _, vjp = jax.vjp(jlinalg.chol_with_inv, jnp.asarray(K))
    gK_jax, = vjp((jnp.asarray(gL), jnp.asarray(gLi)))
    Kt = _t(K, True)
    L, Li = linalg.chol_with_inv(Kt)
    gK, = torch.autograd.grad((L * _t(gL)).sum() + (Li * _t(gLi)).sum(), Kt)
    _close(gK, gK_jax, 1e-9)
    Kr = _t(K, True)
    Lr = torch.linalg.cholesky(Kr)
    Lir = torch.linalg.inv(Lr)
    gKr, = torch.autograd.grad((Lr * _t(gL)).sum() + (Lir * _t(gLi)).sum(), Kr)
    _close(gK, 0.5 * (gKr + gKr.transpose(1, 2)), 1e-9)


def test_tril_logdet_syrk_gram_backward():
    rng = np.random.RandomState(6)
    L = np.tril(rng.randn(3, 7, 7)) + 3 * np.eye(7)
    Lq = rng.randn(3, 7, 7)
    X = rng.randn(2, 5, 4)
    C7, C5 = rng.randn(7, 7), rng.randn(2, 5, 5)
    for fn_t, fn_j, plain, a, c in (
            (linalg.tril_logdet, jlinalg.tril_logdet,
             lambda x: torch.log(torch.abs(torch.diagonal(x, dim1=-2, dim2=-1))).sum(),
             L, np.asarray(1.7)),
            (linalg.syrk_sum, jlinalg.syrk_sum,
             lambda x: torch.einsum('rmk,rnk->mn', x, x), Lq, C7),
            (linalg.gram_syrk, jlinalg.gram_syrk,
             lambda x: x @ x.transpose(-1, -2), X, C5)):
        xt = _t(a, True)
        val = fn_t(xt)
        g, = torch.autograd.grad((val * _t(c)).sum(), xt)
        vj, vjp = jax.vjp(fn_j, jnp.asarray(a))
        _close(val, vj, 1e-12)
        _close(g, vjp(jnp.asarray(c))[0], 1e-10)
        xr = _t(a, True)
        gr, = torch.autograd.grad((plain(xr) * _t(c)).sum(), xr)
        _close(g, gr, 1e-10)


@pytest.mark.parametrize('form', ['white', 'factor', 'K'])
def test_gauss_kl_value_and_grads(form):
    """All three prior forms against JAX's gauss_kl, value and gradients
    (q_mu, q_sqrt and the prior's K, through chol_with_inv for the factor
    form); the factor form also against the K form."""
    rng = np.random.RandomState(7)
    M, R = 9, 3
    q_mu = rng.randn(M, R)
    q_sqrt = np.tril(rng.randn(R, M, M)) * 0.4 + np.eye(M)
    K = _spd(rng, 1, M)[0]

    def jkl(mu, sq, K_):
        if form == 'white':
            return jlinalg.gauss_kl(mu, sq, None)
        if form == 'factor':
            Lp, Lpi = jlinalg.chol_with_inv(K_)
            return jlinalg.gauss_kl(mu, sq, Lp=Lp, Lp_inv=Lpi)
        return jlinalg.gauss_kl(mu, sq, K_)

    def tkl(mu, sq, K_):
        if form == 'white':
            return linalg.gauss_kl(mu, sq, None)
        if form == 'factor':
            Lp, Lpi = linalg.chol_with_inv(K_)
            return linalg.gauss_kl(mu, sq, Lp=Lp, Lp_inv=Lpi)
        return linalg.gauss_kl(mu, sq, K_)

    vj, gj = jax.value_and_grad(jkl, argnums=(0, 1, 2))(
        jnp.asarray(q_mu), jnp.asarray(q_sqrt), jnp.asarray(K))
    args = [_t(q_mu, True), _t(q_sqrt, True), _t(K, True)]
    val = tkl(*args)
    grads = torch.autograd.grad(val, args, allow_unused=True)
    _close(val, vj, 1e-10)
    for g, ref in zip(grads, gj):
        if g is None:
            assert not np.asarray(ref).any()
        else:
            _close(g, ref, 1e-9)
    if form == 'factor':
        args2 = [_t(q_mu, True), _t(q_sqrt, True), _t(K, True)]
        val2 = linalg.gauss_kl(args2[0], args2[1], args2[2])
        grads2 = torch.autograd.grad(val2, args2)
        _close(val, val2.detach(), 1e-10)
        for g, g2 in zip(grads, grads2):
            _close(g, g2, 1e-8)


@pytest.mark.parametrize('form', ['white', 'factor', 'K'])
def test_gauss_kl_float32_evaluates_in_float64(form, monkeypatch):
    """The white and K forms of a float32 KL are the float64 KL of the same
    float32 arguments rounded to float32, gradients too.  The factor form
    (Lp, Lp_inv) evaluates only T = sum_r Lq_r Lq_r^T in float64 and the
    rest in float32: its value and gradients are float32 within 1e-6 of
    the float64 KL's, and T's product runs in float64."""
    rng = np.random.RandomState(8)
    M, R = 12, 3
    q_mu = rng.randn(M, R).astype(np.float32)
    q_sqrt = (np.tril(rng.randn(R, M, M)) * 0.4 + np.eye(M)).astype(np.float32)
    K = _spd(rng, 1, M)[0]
    Lp = np.linalg.cholesky(K)
    prior = {'white': {}, 'K': {'K': K},
             'factor': {'Lp': Lp, 'Lp_inv': np.linalg.inv(Lp)}}[form]
    syrk_dtypes = []
    syrk = linalg.syrk_sum
    monkeypatch.setattr(linalg, 'syrk_sum',
                        lambda Lq: syrk_dtypes.append(Lq.dtype) or syrk(Lq))

    def kl(dtype):
        args = [torch.tensor(a, dtype=dtype, requires_grad=True)
                for a in (q_mu, q_sqrt)]
        kw = {k: torch.tensor(v.astype(np.float32), dtype=dtype)
              for k, v in prior.items()}
        val = linalg.gauss_kl(*args, **kw)
        return val, torch.autograd.grad(val, args)

    v32, g32 = kl(torch.float32)
    v64, g64 = kl(torch.float64)
    assert v32.dtype == torch.float32
    if form != 'factor':
        assert v32.item() == np.float32(v64.item())
        for a, b in zip(g32, g64):
            assert a.dtype == torch.float32 and torch.equal(a, b.float())
        return
    assert syrk_dtypes == [torch.float64, torch.float64]
    np.testing.assert_allclose(v32.item(), v64.item(), rtol=1e-6)
    for a, b in zip(g32, g64):
        assert a.dtype == torch.float32
        _close(a.double(), b, 1e-6)


# ------------------------------------------------------------ initialisation


def test_kmeans_matches_jax_given_initial_centers():
    rng = np.random.RandomState(8)
    X = np.concatenate([rng.randn(60, 5) + 4 * rng.randn(1, 5) for _ in range(4)])
    key = jax.random.PRNGKey(3)
    ref = jkmeans(key, jnp.asarray(X), 6, iters=20)
    _, sub = jax.random.split(key)
    idx = np.asarray(jax.random.choice(sub, X.shape[0], shape=(6,), replace=False))
    out = kmeans(torch.tensor(X), 6, 20, centers=torch.tensor(X[idx]))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-10, atol=1e-12)
    g = torch.Generator().manual_seed(0)
    drawn = kmeans(torch.tensor(X), 6, 0, generator=g)
    assert len({tuple(r) for r in drawn.numpy().round(12)}) == 6   # distinct rows


def test_patch_inducing_points_match_jax_given_the_draws():
    """Patch sampling (the port's copy of the numpy gather), then k-means
    from the JAX package's initial centers: the JAX package's inducing
    patches.  The torch-drawn offsets stay in the reference's range."""
    rng = np.random.RandomState(9)
    NHWC = rng.randn(20, 9, 8, 2)
    key = jax.random.PRNGKey(4)
    ref = jpatch_points(key, jnp.asarray(NHWC), 5, 3, kmeans_iters=10)
    k1, k2 = jax.random.split(key)
    a, b, c = jax.random.split(k1, 3)
    count = 5 * inducing.SAMPLES_PER_INDUCING_POINT
    img = np.asarray(jax.random.randint(a, (count,), 0, 20))
    ys = np.asarray(jax.random.randint(b, (count,), 0, 9 - 3))
    xs = np.asarray(jax.random.randint(c, (count,), 0, 8 - 3))
    patches = inducing.gather_patches(NHWC, img, ys, xs, 3)
    np.testing.assert_array_equal(patches, jsample_patches(NHWC, img, ys, xs, 3))
    _, sub = jax.random.split(k2)
    idx = np.asarray(jax.random.choice(sub, count, shape=(5,), replace=False))
    out = kmeans(torch.tensor(patches), 5, 10, centers=torch.tensor(patches[idx]))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-10, atol=1e-12)
    drawn = inducing.sample_patches(NHWC, 300, 3, torch.Generator().manual_seed(1))
    assert drawn.shape == (300, 18)


def test_identity_conv_matches_jax():
    rng = np.random.RandomState(10)
    X = rng.randn(30, 12, 12, 3)
    key = jax.random.PRNGKey(5)
    ref = jbuilder.identity_conv(key, X, 5, 3, 4, 2)
    idx = np.asarray(jax.random.randint(key, (1000,), 0, 30))
    np.testing.assert_array_equal(builder.identity_conv(X, 5, 4, 2, idx), ref)


@pytest.mark.parametrize('white', [False, True])
def test_fresh_init_matches_jax_given_inducing_points(white):
    """A fresh build from training images: with the JAX model's inducing
    points loaded (and nothing else), every other parameter -- q_mu zero,
    q_sqrt = 1e-5 chol(Kuu) hidden and chol(Kuu) last (identities when
    white), unit patch weights, variance and lengthscale 5 -- is the JAX
    package's fresh initialisation; the KL anchor is a copy of Z."""
    rng = np.random.RandomState(11)
    X = rng.randn(40, 12, 12, 1)
    Y = rng.randint(0, 10, size=(40, 1))
    flags = jbuilder.BuilderFlags(M='6,8', feature_maps='2', filter_sizes='5,3',
                                  strides='2,1', num_samples=3, batch_size=8,
                                  white=white)
    jm = jbuilder.build_model(flags, X, Y, jax.random.PRNGKey(0), dtype=jnp.float64)
    loaded = {i: {'Z': np.asarray(layer.Z)} for i, layer in enumerate(jm.layers)}
    port = builder.build_model(flags, (12, 12, 1), loaded, images=X,
                               dtype=torch.float64, device='cpu')
    assert port.num_data == 40 and port.num_samples == 3
    ref = jckpt.model_parameters(jm, 0)
    out = checkpoint.model_parameters(port, 0)
    assert set(out) == set(ref)
    for k in ref:
        np.testing.assert_allclose(out[k], ref[k], rtol=1e-10, atol=1e-15, err_msg=k)
    hidden = port.layers[0]
    assert isinstance(hidden, ConvLayer)
    assert torch.equal(hidden.Z0, hidden.Z.detach())
    assert hidden.Z0.data_ptr() != hidden.Z.data_ptr()


def test_fresh_build_draws_inducing_points_from_images():
    rng = np.random.RandomState(12)
    X = rng.randn(50, 12, 12, 1)
    flags = jbuilder.BuilderFlags(M='6,8', feature_maps='2', filter_sizes='5,3',
                                  strides='2,1', num_samples=3)
    a = builder.build_model(flags, (12, 12, 1), images=X, dtype=torch.float64,
                            generator=torch.Generator().manual_seed(2), device='cpu')
    b = builder.build_model(flags, (12, 12, 1), images=X, dtype=torch.float64,
                            generator=torch.Generator().manual_seed(2), device='cpu')
    for (name, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), name
    assert a.layers[0].Z.shape == (6, 25) and a.layers[1].Z.shape == (8, 18)
    assert torch.isfinite(a.layers[1].q_sqrt).all()
