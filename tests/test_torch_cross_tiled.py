"""The backward's row-tiled image side (K5 for P > 64,
``csrc/conv_rbf_cross_bwd.cu:bwd_image_kernel_tiled``) on the CPU: its
plan (units, grid, the partials' slots, shared memory) for every geometry
the gate admits, and ``cuda_cross.bwd_tiled_3xtf32``, its arithmetic
emulated unit by unit in split TF32, against the plain backward in
float32 (K5's chip rule, 1e-3 of each gradient's largest magnitude) and
in float64.  The kernel itself runs only on the card (``chip_smoke.py``,
``tools/torch_cross_probe.py``)."""

import numpy as np
import pytest
import torch

from deepcgp_tpu_torch.ops import cuda_cross

NAMES = ('images', 'Z', 'variance', 'gamma', 'u', 'wkd')
# (N, H, W, C, f, stride, M): the MNIST ConvKernel (P = 576, L = 25) at
# its M and a small one, and CIFAR with strides 2,1 (P = 100, L = 250).
GEOMETRIES = {'mnist': (2, 28, 28, 1, 5, 1, 1024),
              'mnist-small-m': (2, 28, 28, 1, 5, 1, 200),
              'cifar-strides-2-1': (3, 14, 14, 10, 5, 1, 384)}


def _inputs(geometry, with_kdiag, dtype=torch.float32, seed=0):
    N, H, W, C, f, s, M = geometry
    rng = np.random.RandomState(seed)
    L = f * f * C
    P = ((H - f) // s + 1) * ((W - f) // s + 1)
    X = torch.tensor(0.3 * rng.randn(N, H, W, C), dtype=dtype)
    Z = torch.tensor(0.3 * rng.randn(M, L), dtype=dtype)
    w = torch.tensor(rng.rand(P) + 0.5, dtype=dtype)
    var = torch.tensor(1.3, dtype=dtype)
    gamma = torch.tensor(-0.5 / L, dtype=dtype)
    dkzx = torch.tensor(rng.randn(N, M), dtype=dtype)
    dkd = torch.tensor(rng.randn(N), dtype=dtype)
    return (X, Z, var, gamma, w / P, w, f, s, 1, with_kdiag, dkzx, dkd)


def _f64(args):
    return tuple(a.double() if torch.is_tensor(a) else a for a in args)


def _rel(a, b):
    return float((a.double() - b.double()).abs().max()
                 / b.double().abs().max().clamp_min(1e-300))


@pytest.mark.parametrize('N,P,M,L,with_kdiag,with_dimg,expect', [
    # units = R T (+ R (R + 1) / 2), slots = T (+ R), Lx = 32 ceil(L / 32)
    (32, 576, 1024, 25, True, False, dict(row_tiles=5, col_tiles=8,
                                          units=55, slots=13, Lx=32)),
    (32, 576, 1024, 25, False, True, dict(row_tiles=5, col_tiles=8,
                                          units=40, slots=8, Lx=32)),
    (128, 576, 1024, 25, True, True, dict(row_tiles=5, col_tiles=8,
                                          units=55, slots=13, Lx=32)),
    (320, 100, 384, 250, True, True, dict(row_tiles=1, col_tiles=3,
                                          units=4, slots=4, Lx=256)),
    (6, 81, 8, 18, True, True, dict(row_tiles=1, col_tiles=1, units=2,
                                    slots=2, Lx=32)),
    (4, 129, 129, 512, True, False, dict(row_tiles=2, col_tiles=2,
                                         units=7, slots=4, Lx=512))])
def test_tiled_plan(N, P, M, L, with_kdiag, with_dimg, expect):
    """The launch the wrapper plans: R row tiles of 128 patches by T column
    tiles of M, the gram's pairs a <= b after them, a grid of (units, N),
    one shared-memory size, and a slot of each partial per unit."""
    plan = cuda_cross.tiled_plan(N, P, M, L, with_kdiag, with_dimg)
    for k, v in expect.items():
        assert plan[k] == v, k
    R, T, U = plan['row_tiles'], plan['col_tiles'], plan['units']
    assert plan['grid'] == (U, N)
    assert plan['smem'] == cuda_cross.TILED_SMEM
    assert plan['scalars'] == (N, U, 2)
    assert plan['du'] == (N, R, T, 128)
    assert plan['dwkd'] == ((N, R, R, 128) if with_kdiag else None)
    S, Lx = plan['slots'], plan['Lx']
    assert plan['rx'] == ((N, R, S, 128, Lx) if with_dimg else None)
    assert plan['rsum'] == ((N, R, S, 128) if with_dimg else None)
    units = cuda_cross.tiled_units(P, M, with_kdiag)
    assert len(units) == U
    assert units[:R * T] == [('cross', a, b) for a in range(R)
                             for b in range(T)]
    assert all(k == 'gram' and a <= b for k, a, b in units[R * T:])


@pytest.mark.parametrize('P,M', [(576, 1024), (576, 200), (100, 384),
                                  (81, 8), (129, 129), (1024, 1000)])
def test_tiled_units_write_every_slot_once(P, M):
    """Every slot of every partial is written by exactly one unit (the
    wrapper allocates them uninitialized), and the gram units cover every
    ordered pair of row tiles once: (a, b) and (b, a) by the pair a < b,
    (a, a) by the diagonal."""
    R, T = -(-P // 128), -(-M // 128)
    du, dw, rx = {}, {}, {}
    ordered = {}
    for k, a, b in cuda_cross.tiled_units(P, M, True):
        if k == 'cross':
            for d, key in ((du, (a, b)), (rx, (a, b))):
                d[key] = d.get(key, 0) + 1
            continue
        for x, y in {(a, b), (b, a)}:
            dw[(x, y)] = dw.get((x, y), 0) + 1
            rx[(x, T + y)] = rx.get((x, T + y), 0) + 1
            ordered[(x, y)] = ordered.get((x, y), 0) + 1
    assert du == {(a, b): 1 for a in range(R) for b in range(T)}
    assert dw == {(a, b): 1 for a in range(R) for b in range(R)}
    assert rx == {(a, s): 1 for a in range(R) for s in range(T + R)}
    assert ordered == {(a, b): 1 for a in range(R) for b in range(R)}


def test_tiled_shared_memory_within_the_card_for_every_admitted_geometry():
    """The row-tiled block's shared memory is the same at every geometry
    (the ring of K4 and the tile of T or S and the dpatches staging in its
    space, then norms, row and column sums, row tables, scalars: 26,000
    floats), two blocks an SM; the gate admits P > 64 exactly where L <=
    512, and nothing it admits needs more."""
    assert cuda_cross.TILED_SMEM == 4 * 26000 == 104000
    assert 2 * (cuda_cross.TILED_SMEM + 1024) <= 228 * 1024
    for P in range(65, 2049, 13):
        for L in range(1, 600, 7):
            route = cuda_cross.bwd_route(P, L)
            assert route == ('tiled' if L <= 512 else None), (P, L)
            if route == 'tiled':
                assert cuda_cross.TILED_SMEM <= cuda_cross.SMEM_LIMIT


@pytest.mark.parametrize('with_dimg', [True, False],
                         ids=['with-dimg', 'no-dimg'])
@pytest.mark.parametrize('with_kdiag', [True, False],
                         ids=['kdiag', 'no-kdiag'])
@pytest.mark.parametrize('name', sorted(GEOMETRIES))
def test_tiled_emulation_matches_the_plain_backward(name, with_kdiag,
                                                    with_dimg):
    """The row-tiled image side's arithmetic (split TF32 on 128-row tiles,
    the gram's pairs a <= b, the slots summed in order, d images by the
    gather) with the Z side on its T: each gradient within 1e-3 of its
    largest magnitude of the plain float32 backward (K5's rule on the
    card) and within 1e-4 of the plain float64 one; no d images unless
    asked."""
    args = _inputs(GEOMETRIES[name], with_kdiag)
    emu = cuda_cross.bwd_tiled_3xtf32(*args, with_dimg=with_dimg)
    ref = cuda_cross.conv_rbf_cross_bwd_plain(*args, with_dimg=with_dimg)
    ref64 = cuda_cross.conv_rbf_cross_bwd_plain(*_f64(args),
                                                with_dimg=with_dimg)
    assert (emu[0] is None) == (ref[0] is None) == (not with_dimg)
    for n, e, r, r64 in zip(NAMES, emu, ref, ref64):
        if r is None:
            continue
        if n == 'wkd' and not with_kdiag:
            assert float(e.abs().max()) == 0.0
            continue
        assert e.dtype == torch.float32 and e.shape == r.shape, n
        assert _rel(e, r) <= 1e-3, (n, _rel(e, r))
        assert _rel(e, r64) <= 1e-4, (n, _rel(e, r64))


@pytest.mark.parametrize('name', ['mnist', 'cifar-strides-2-1'])
def test_no_image_gradient_changes_no_other_gradient(name):
    """Asking for no d images leaves dZ, dvar, dgamma, du and dwkd as they
    were, bit for bit: in the emulation, in the plain backward, and through
    the autograd Function when the images need no gradient."""
    args = _inputs(GEOMETRIES[name], True)
    for fn in (cuda_cross.bwd_tiled_3xtf32,
               cuda_cross.conv_rbf_cross_bwd_plain):
        on = fn(*args, with_dimg=True)
        off = fn(*args, with_dimg=False)
        assert off[0] is None and on[0] is not None
        for n, a, b in zip(NAMES[1:], on[1:], off[1:]):
            assert torch.equal(a, b), (fn.__name__, n)
    X, Z, var, gamma, u, wkd, f, s, d, kd_on, dkzx, dkd = args
    grads = []
    for needs in (True, False):
        leaves = [t.clone().requires_grad_(True) for t in (Z, var, gamma, u,
                                                           wkd)]
        Xi = X.clone().requires_grad_(needs)
        kzx, kd = cuda_cross.fused_conv_rbf_cross(Xi, *leaves, f, s, d, kd_on)
        ((kzx * dkzx).sum() + (kd * dkd).sum()).backward()
        assert (Xi.grad is not None) == needs
        grads.append([t.grad for t in leaves])
    for n, a, b in zip(NAMES[1:], *grads):
        assert torch.equal(a, b), n
