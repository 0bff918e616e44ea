"""The split-TF32 (3xTF32) scheme of the fused cross-covariance kernels K4
and K5's Z side (``ops/cuda_cross.py``), on the CPU, before any chip run:
``tf32_round`` against hand-made bit patterns, the emulated Kzx, Kdiag
and dZ against the plain float32 versions under the chip's rules and
against the JAX kernels in float64 (Pallas in interpret mode), and the
host-side planning of the two launches.  The kernels themselves run only
on the card, where ``chip_smoke.py`` holds them against the same plain
versions."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepcgp_tpu.models.base_kernels import RBF as JRBF
from deepcgp_tpu.models.conv_kernels import ConvKernel as JConv
from deepcgp_tpu.models.views import FullView as JFullView
from deepcgp_tpu.ops import pallas_cross

from deepcgp_tpu_torch.ops import cuda_cross
from deepcgp_tpu_torch.ops.patches import extract_patches


def _f32(bits):
    return torch.tensor(np.array(bits, dtype=np.uint32).view(np.int32)).view(
        torch.float32)


def _bits(x):
    return x.view(torch.int32).numpy().view(np.uint32)


# ------------------------------------------------------------ tf32_round


@pytest.mark.parametrize('given,want', [
    (0x3F800000, 0x3F800000),   # 1.0 is a TF32 value
    (0x3F801000, 0x3F802000),   # tie: away from zero (even would go down)
    (0xBF801000, 0xBF802000),   # negative tie: away from zero
    (0x3F800FFF, 0x3F800000),   # below half an ulp: down
    (0x3F801001, 0x3F802000),   # above half an ulp: up
    (0x3FFFF000, 0x40000000),   # the carry reaches the exponent: 2.0
    (0x00001000, 0x00002000),   # subnormal tie
    (0x00000FFF, 0x00000000),   # subnormal below half: zero
    (0x807FF000, 0x80800000),   # the largest subnormal rounds to -FLT_MIN
    (0x00000000, 0x00000000),
    (0x80000000, 0x80000000),   # -0 keeps its sign
])
def test_tf32_round_bit_patterns(given, want):
    """Round to nearest, ties away from zero, on the 13 dropped mantissa
    bits, as cvt.rna.tf32.f32 does, subnormals included."""
    out = cuda_cross.tf32_round(_f32([given]))
    assert _bits(out)[0] == want


@pytest.mark.parametrize('given', [0x7F800000, 0xFF800000, 0x7FC00000,
                                   0x7FFFFFFF, 0xFFC00001])
def test_tf32_round_passes_inf_and_nan(given):
    """+-inf and NaN come back bit for bit (a NaN's payload can carry into
    the sign bit under the rounding add)."""
    x = _f32([given])
    assert _bits(cuda_cross.tf32_round(x))[0] == given


def test_split_tf32_carries_float32():
    """hi and lo are TF32 values (13 low mantissa bits zero; lo = x - hi as
    the tensor cores read it, truncated) and hi + lo is x to within 2^-21
    of |x|, over 23 binades."""
    x = torch.tensor(np.random.RandomState(0).randn(4096)
                     * np.exp2(np.random.RandomState(1).randint(-11, 12, 4096)),
                     dtype=torch.float32)
    hi, lo = cuda_cross.split_tf32(x)
    assert not (_bits(hi) & 0x1FFF).any() and not (_bits(lo) & 0x1FFF).any()
    err = (hi.double() + lo.double() - x.double()).abs()
    assert bool((err <= 2.0 ** -21 * x.double().abs()).all())
    assert float((hi.double() - x.double()).abs().max()
                 / x.double().abs().max()) > 2.0 ** -14   # one pass is not enough


def test_matmul_3xtf32_is_float32_accurate():
    """The three-pass product lands as near the float64 product as plain
    float32 does (within 2^-20 of the operands' scale), where one TF32
    pass is ~500x farther."""
    rng = np.random.RandomState(2)
    a, b = rng.randn(64, 250), rng.randn(250, 96)
    ref = a @ b
    scale = np.abs(a).max() * np.abs(b).max() * 250
    t = lambda v: torch.tensor(v, dtype=torch.float32)  # noqa: E731
    e3 = np.abs(cuda_cross.matmul_3xtf32(t(a), t(b)).double().numpy() - ref).max()
    e32 = np.abs((t(a) @ t(b)).double().numpy() - ref).max()
    e1 = np.abs((cuda_cross.tf32_round(t(a)) @ cuda_cross.tf32_round(t(b)))
                .double().numpy() - ref).max()
    assert e3 <= e32 + 2.0 ** -20 * scale
    assert e1 > 50 * max(e3, e32)


# ------------------------------------------------- emulation vs references

# (H, W, C, f, stride, M): the flagship's last layer, chip_smoke.py's
# stride-2 geometry, and L = 400 (CIFAR fm16).
GEOMS = {'flagship': (10, 10, 10, 5, 1, 384),
         'stride2': (15, 13, 10, 3, 2, 200),
         'L400': (10, 10, 16, 5, 1, 384)}
N_IMAGES = 4
VARIANCE = 5.0
# The emulation may sit farther from float64 than plain float32 by this
# much of the reference's largest magnitude: a few ulps of float32, where
# the products' split adds ~2^-21 of each term (one TF32 pass: 2^-11).
MARGIN = 2.0 ** -20


def _case(name, lengthscale, seed=0):
    """numpy inputs as chip_smoke.py draws them: normal images, inducing
    patches cut from other normal images, weights in [0.5, 1.5)."""
    H, W, C, f, s, M = GEOMS[name]
    rng = np.random.RandomState(seed)
    X = rng.randn(N_IMAGES, H, W, C)
    src = extract_patches(torch.tensor(rng.randn(16, H, W, C)), f, 1, 1)
    src = src.reshape(-1, f * f * C).numpy()
    Z = src[rng.choice(len(src), M, replace=False)]
    P = ((H - f) // s + 1) * ((W - f) // s + 1)
    w = rng.rand(P) + 0.5
    dkzx, dkd = rng.randn(N_IMAGES, M), rng.randn(N_IMAGES)
    gamma = -0.5 / lengthscale ** 2
    return dict(X=X, Z=Z, w=w, P=P, f=f, s=s, gamma=gamma, ls=lengthscale,
                dkzx=dkzx, dkd=dkd, geom=(H, W, C))


def _torch_args(c, dtype):
    t = lambda v: torch.tensor(v, dtype=dtype)  # noqa: E731
    return (t(c['X']), t(c['Z']), t(VARIANCE), t(c['gamma']),
            t(c['w'] / c['P']), t(c['w']), c['f'], c['s'], 1)


def _jax_kernel(c):
    H, W, C = c['geom']
    view = JFullView(input_size=(H, W), filter_size=c['f'], feature_maps=C,
                     stride=c['s'])
    base = JRBF.create(variance=VARIANCE, lengthscales=c['ls'],
                       dtype=jnp.float64)
    jk = JConv.create(base, view, patch_weights=jnp.asarray(c['w']),
                      dtype=jnp.float64)
    assert pallas_cross.supported_for(jk, c['Z'].shape[0], N_IMAGES)
    return jk


def _dist(a, ref):
    return float(np.abs(np.asarray(a, dtype=np.float64) - np.asarray(ref)).max())


@pytest.mark.parametrize('lengthscale', [5.0, 25.0])
@pytest.mark.parametrize('geometry', list(GEOMS))
def test_emulated_forward_holds_k4_rules(geometry, lengthscale, monkeypatch):
    """Kzx and Kdiag with both products in split TF32: within K4's chip
    rule of the plain float32 version (rtol 1e-5, atol 1e-6 var), and no
    farther from the JAX kernel in float64 than plain float32 is, plus
    MARGIN of the largest magnitude."""
    c = _case(geometry, lengthscale)
    a32 = _torch_args(c, torch.float32)
    kzx_e, kd_e = cuda_cross.conv_rbf_cross_3xtf32(*a32, True)
    kzx_p, kd_p = cuda_cross.conv_rbf_cross_plain(*a32, True)
    atol = 1e-6 * VARIANCE
    assert torch.allclose(kzx_e, kzx_p, rtol=1e-5, atol=atol)
    assert torch.allclose(kd_e, kd_p, rtol=1e-5, atol=atol)

    monkeypatch.setenv('DEEPCGP_PALLAS_CROSS', '1')
    jk = _jax_kernel(c)
    kzx_j, kd_j = jk.Kzx_NM_and_Kdiag(jnp.asarray(c['Z']),
                                      jnp.asarray(c['X'].reshape(N_IMAGES, -1)))
    for emul, plain, ref in ((kzx_e, kzx_p, kzx_j), (kd_e, kd_p, kd_j)):
        ref = np.asarray(ref)
        assert _dist(emul, ref) <= _dist(plain, ref) + MARGIN * np.abs(ref).max()


@pytest.mark.parametrize('lengthscale', [5.0, 25.0])
@pytest.mark.parametrize('geometry', list(GEOMS))
def test_emulated_dz_holds_k5_rules(geometry, lengthscale, monkeypatch):
    """dZ with T^T patches in split TF32: within K5's chip rule of the
    plain float32 backward (1e-3 of its largest magnitude), and no farther
    from the JAX kernels' float64 dZ (jax.vjp through the Pallas forward
    and backward) than plain float32 is, plus MARGIN of the largest
    magnitude."""
    c = _case(geometry, lengthscale)
    a32 = _torch_args(c, torch.float32)
    dkzx = torch.tensor(c['dkzx'], dtype=torch.float32)
    dkd = torch.tensor(c['dkd'], dtype=torch.float32)
    dz_e = cuda_cross.bwd_dz_3xtf32(*a32[:5], *a32[6:], dkzx)
    dz_p = cuda_cross.conv_rbf_cross_bwd_plain(*a32, True, dkzx, dkd)[1]
    scale = float(dz_p.abs().max())
    assert scale > 0
    assert float((dz_e - dz_p).abs().max()) <= 1e-3 * scale

    monkeypatch.setenv('DEEPCGP_PALLAS_FORCE', '1')
    monkeypatch.setenv('DEEPCGP_PALLAS_CROSS', '1')
    jk = _jax_kernel(c)
    X = jnp.asarray(c['X'].reshape(N_IMAGES, -1))
    _, vjp = jax.vjp(lambda Z: jk.Kzx_NM_and_Kdiag(Z, X), jnp.asarray(c['Z']))
    ref = np.asarray(vjp((jnp.asarray(c['dkzx']), jnp.asarray(c['dkd'])))[0])
    assert _dist(dz_e, ref) <= _dist(dz_p, ref) + MARGIN * np.abs(ref).max()


# ------------------------------------------------------------ planning


@pytest.mark.parametrize('P,group', [(1, 128), (9, 14), (36, 3), (42, 3),
                                     (64, 2), (100, 1), (128, 1), (129, 1),
                                     (576, 1)])
def test_fwd_group_fills_128_rows_with_whole_images(P, group):
    """A forward block takes as many whole images as fit its 128 rows, or
    one image in row tiles above P = 128."""
    assert cuda_cross.fwd_group(P) == group
    assert group * P <= cuda_cross.FWD_ROWS or group == 1


@pytest.mark.parametrize('N,P,M,with_kdiag,grid', [
    (640, 36, 384, True, (214, 4)),      # flagship serving: 3 Kzx tiles + gram
    (320, 36, 384, True, (107, 4)),      # flagship training
    (256, 42, 200, False, (86, 2)),      # stride 2, AdditivePatchKernel
    (3, 576, 1024, True, (3, 23)),       # P > 128: one image a block, the
                                         #   gram's 15 row-tile pairs apart
    (3, 576, 1024, False, (3, 8)),
])
def test_fwd_grid(N, P, M, with_kdiag, grid):
    assert cuda_cross.fwd_grid(N, P, M, with_kdiag) == grid


@pytest.mark.parametrize('N,P,M,L,cluster', [
    (320, 36, 384, 250, 16),  # flagship: 3 x 4 tiles, 192 blocks
    (256, 42, 200, 90, 16),   # stride 2: 2 x 2 tiles
    (320, 36, 384, 400, 13),  # L = 400: 3 x 7 tiles
    (2, 9, 16, 9, 2),         # 18 rows: two k-chunks
    (1, 1, 1, 1, 1),
])
def test_z_side_cluster(N, P, M, L, cluster):
    """Enough blocks a tile to put two on every SM of an H100, at most 16,
    never more than the tile's k-chunks."""
    assert cuda_cross.z_side_cluster(N, P, M, L, sms=132) == cluster


def test_shared_memory_of_the_new_blocks():
    """Two forward blocks and two Z-side blocks fit an H100 SM (228 KB,
    1 KB reserved a block); each is within one block's limit."""
    sm = 228 * 1024
    assert cuda_cross.FWD_SMEM == 99840
    assert cuda_cross.Z_SMEM == 88832
    assert 2 * (cuda_cross.FWD_SMEM + 1024) <= sm
    assert 2 * (cuda_cross.Z_SMEM + 1024) <= sm
    assert max(cuda_cross.FWD_SMEM, cuda_cross.Z_SMEM) <= cuda_cross.SMEM_LIMIT


def _old_fwd_smem_bytes(P, L):
    """The first forward kernel's shared memory, which set the route's
    envelope: the transposed patch matrix, norms and reduction buffers."""
    Ppad = -(-P // 8) * 8
    return 4 * (L * Ppad + Ppad + 128 + min(Ppad // 8, 8) * 128)


def test_envelope_answers_as_before():
    """The forward's shared memory no longer depends on the geometry, but
    the route's envelope (``supported``, and so ``fused_fits``) answers as
    it always has, over P up to 2048 and L up to 8000."""
    for P in list(range(1, 130)) + [144, 196, 256, 576, 1024, 2048]:
        for L in list(range(1, 600, 7)) + [800, 1445, 1446, 4000, 8000]:
            fits = cuda_cross.envelope_bytes(P, L) <= cuda_cross.SMEM_LIMIT
            assert fits == (_old_fwd_smem_bytes(P, L) <= cuda_cross.SMEM_LIMIT)
