"""The split of K6's and K7's work (``csrc/patches.cu``), modelled in numpy
on the CPU: K6's tasks cover each image's output exactly once, every
thread's carried (ox, oy, dy, dx, c) equals the one taken apart from its
index, its band holds every pixel its piece reads, and the emulated
kernel writes the plain extraction; K7 visits each patch element once, in
ascending (dy, dx) order for its pixel, and the emulated sum equals the
plain col2im.  ``cuda_patches.extract_plan`` is the launcher's split in
Python; chip_smoke.py holds it against the launcher's own on the card."""

import numpy as np
import pytest
import torch

from deepcgp_tpu_torch.ops import cuda_patches as cp
from deepcgp_tpu_torch.ops.patches import out_size, pixel_index

# (N, H, W, C, f, stride, dilation): chip_smoke.py's K6/K7 rows, then odd
# ones.
GEOMETRIES = [
    (32, 28, 28, 1, 5, 1, 1),      # MNIST ConvKernel training
    (320, 10, 10, 32, 5, 1, 1),    # CIFAR fm32
    (7, 9, 11, 3, 3, 2, 2),        # stride and dilation 2
    (320, 14, 14, 10, 5, 1, 1),    # CIFAR strides 2,1
    (128, 28, 28, 1, 5, 1, 1),     # MNIST ConvKernel serving
    (4, 40, 40, 40, 5, 1, 1),      # an image beyond a block's shared memory
    (2, 32, 32, 3, 5, 3, 1),       # CIFAR first layer, two images
    (3, 6, 6, 1, 3, 1, 2),         # dilation only
    (2, 5, 6, 520, 5, 1, 1),       # one patch's band beyond 48 KB
    (1, 3, 3, 1, 1, 1, 1),         # L = 1
    (320, 14, 14, 10, 3, 1, 1),    # chip_smoke.py's depth-3 hidden layer
    (320, 12, 12, 10, 3, 1, 1),    # and depth-3 last layer
]
IDS = ['x'.join(map(str, g)) for g in GEOMETRIES]


def _grid(H, W, f, s, d):
    return out_size(H, f, s, d), out_size(W, f, s, d)


def _plan(geometry, sms, unaligned):
    N, H, W, C, f, s, d = geometry
    vec = cp.vector_width(C, 4 if unaligned else 0)
    return cp.extract_plan(N, (H, W, C), f, s, d, sms, vec)


def _task(plan, r, Hout, Wout):
    """(ox0, oy0, kc, kr) of task r of an image."""
    ox0 = r // plan['tasks_y'] * plan['kc']
    oy0 = r % plan['tasks_y'] * plan['kr']
    return ox0, oy0, min(plan['kc'], Wout - ox0), min(plan['kr'], Hout - oy0)


def _emulate_task(plan, geometry, image, out, written, r):
    """One block's task on ``image`` [H, W, C]: stage the band, then every
    thread's passes with the kernel's carried indices, each checked
    against its index taken apart.  Writes ``out`` [P * Lv, vec] and
    counts into ``written``."""
    _, H, W, C, f, s, d = geometry
    Hout, Wout = _grid(H, W, f, s, d)
    vec = plan['vec']
    Cv = C // vec
    Lv = f * f * Cv
    ox0, oy0, kc, kr = _task(plan, r, Hout, Wout)
    p0 = ox0 * Hout + oy0
    count = kc * kr * Lv
    y0, x0 = oy0 * s, ox0 * s
    rows, cols = min(plan['bh'], H - y0), min(plan['bw'], W - x0)
    if plan['staged']:
        assert plan['bh'] * plan['bw'] * C * 4 <= cp.BAND_BYTES
        band = image[y0:y0 + rows, x0:x0 + cols]
    q = np.arange(cp.THREADS)
    p, l = np.divmod(p0 * Lv + q, Lv)
    ox, oy = np.divmod(p, Hout)
    dy, rest = np.divmod(l, f * Cv)
    dx, c = np.divmod(rest, Cv)
    sox, soy, sdy, sdx, sc = plan['step']
    while True:
        live = q < count
        if not live.any():
            break
        want_p, want_l = np.divmod(p0 * Lv + q[live], Lv)
        assert np.array_equal(ox[live] * Hout + oy[live], want_p)
        assert np.array_equal((dy[live] * f + dx[live]) * Cv + c[live], want_l)
        assert (oy[live] < Hout).all() and (ox[live] < Wout).all()
        y = oy[live] * s + dy[live] * d
        x = ox[live] * s + dx[live] * d
        ch = c[live][:, None] * vec + np.arange(vec)
        if plan['staged']:
            assert (y >= y0).all() and (y < y0 + rows).all()
            assert (x >= x0).all() and (x < x0 + cols).all()
            vals = band[(y - y0)[:, None], (x - x0)[:, None], ch]
        else:
            vals = image[y[:, None], x[:, None], ch]
        out[p0 * Lv + q[live]] = vals
        written[p0 * Lv + q[live]] += 1
        q = q + cp.THREADS
        c, dx, dy, oy, ox = c + sc, dx + sdx, dy + sdy, oy + soy, ox + sox
        carry = c >= Cv
        c, dx = c - Cv * carry, dx + carry
        carry = dx >= f
        dx, dy = dx - f * carry, dy + carry
        carry = dy >= f
        dy, oy = dy - f * carry, oy + carry
        carry = oy >= Hout
        oy, ox = oy - Hout * carry, ox + carry


@pytest.mark.parametrize('sms', [132, 16])
@pytest.mark.parametrize('geometry', GEOMETRIES, ids=IDS)
def test_extract_tasks_partition_every_output(geometry, sms):
    """The tasks' pieces of out, over all N images, tile [N, P, L] with no
    gap and no overlap, and each piece is one contiguous span."""
    N, H, W, C, f, s, d = geometry
    Hout, Wout = _grid(H, W, f, s, d)
    plan = _plan(geometry, sms, False)
    assert plan['tasks'] == N * plan['tasks_per_image']
    assert plan['kr'] == Hout or plan['kc'] == 1
    L = f * f * C
    spans = []
    for r in range(plan['tasks_per_image']):
        ox0, oy0, kc, kr = _task(plan, r, Hout, Wout)
        assert kc >= 1 and kr >= 1
        spans.append(((ox0 * Hout + oy0) * L, kc * kr * L))
    start = np.array([a for a, _ in spans])[None, :] + \
        (np.arange(N) * Hout * Wout * L)[:, None]
    length = np.broadcast_to(np.array([b for _, b in spans]), start.shape)
    order = np.argsort(start, axis=None)
    start, length = start.ravel()[order], length.ravel()[order]
    assert start[0] == 0
    assert np.array_equal(start[1:], (start + length)[:-1])
    assert start[-1] + length[-1] == N * Hout * Wout * L


@pytest.mark.parametrize('unaligned', [False, True])
@pytest.mark.parametrize('sms', [132, 16])
@pytest.mark.parametrize('geometry', GEOMETRIES, ids=IDS)
def test_extract_emulated_writes_plain_once(geometry, sms, unaligned):
    """Every task of the first and the last image, emulated thread by
    thread: each output vector written exactly once, from its band, equal
    to the plain extraction.  ``unaligned`` models a pointer that is not
    16-byte aligned (vectors of one float)."""
    N, H, W, C, f, s, d = geometry
    Hout, Wout = _grid(H, W, f, s, d)
    plan = _plan(geometry, sms, unaligned)
    vec = plan['vec']
    rng = np.random.RandomState(0)
    for n in sorted({0, N - 1}):
        image = rng.randn(H, W, C).astype(np.float32)
        out = np.zeros((Hout * Wout * f * f * C // vec, vec), np.float32)
        written = np.zeros(len(out), np.int64)
        for r in range(plan['tasks_per_image']):
            _emulate_task(plan, geometry, image, out, written, r)
        assert (written == 1).all()
        want = cp.extract_patches_transposed_plain(
            torch.from_numpy(image)[None], f, s, d)
        np.testing.assert_array_equal(out.reshape(want.shape),
                                      want.numpy())


def test_extract_plan_at_the_paths_shapes():
    """The split at 132 SMs (an H100 SXM) where the paths run."""
    def split(geometry):
        plan = _plan(geometry, 132, False)
        return (plan['vec'], plan['kc'], plan['kr'], plan['bh'], plan['bw'],
                plan['tasks'])
    assert split(GEOMETRIES[1]) == (4, 3, 6, 10, 7, 640)      # fm32
    assert split(GEOMETRIES[3]) == (2, 5, 10, 14, 9, 640)     # strides 2,1
    assert split(GEOMETRIES[0]) == (1, 2, 24, 28, 6, 384)     # MNIST Adam
    assert split(GEOMETRIES[4]) == (1, 5, 24, 28, 9, 640)     # serving
    assert split(GEOMETRIES[5]) == (4, 1, 9, 13, 5, 576)      # beyond smem
    assert split(GEOMETRIES[10]) == (2, 6, 12, 14, 8, 640)    # depth-3 hidden
    assert split(GEOMETRIES[11]) == (2, 5, 10, 12, 7, 640)    # depth-3 last
    plan = _plan(GEOMETRIES[8], 132, False)
    assert plan['staged'] == 0 and plan['bh'] == plan['bw'] == 0


@pytest.mark.parametrize('C,addresses,vec', [
    (32, (0, 256), 4), (32, (0, 4), 1), (32, (8, 0), 2), (10, (0, 0), 2),
    (10, (4, 0), 1), (3, (0, 0), 1), (1, (0, 0), 1), (40, (16, 32), 4)])
def test_vector_width(C, addresses, vec):
    assert cp.vector_width(C, *addresses) == vec


def _col2im_visits(geometry):
    """K7's loop for every pixel: [(y, x, dy, dx, oy, ox)] in the order
    a thread visits them (pixels in row-major order)."""
    _, H, W, C, f, s, d = geometry
    Hout, Wout = _grid(H, W, f, s, d)
    visits = []
    for y in range(H):
        for x in range(W):
            for dy in range(f):
                yy = y - dy * d
                if yy < 0:
                    break
                if yy % s or yy // s >= Hout:
                    continue
                for dx in range(f):
                    xx = x - dx * d
                    if xx < 0:
                        break
                    if xx % s or xx // s >= Wout:
                        continue
                    visits.append((y, x, dy, dx, yy // s, xx // s))
    return np.array(visits, np.int64).reshape(-1, 6)


@pytest.mark.parametrize('geometry', GEOMETRIES, ids=IDS)
def test_col2im_reads_each_element_once_in_order(geometry):
    """Over all pixels and channels K7's visits read every element of the
    [P, L] cotangent exactly once, each into the pixel the extraction
    read it from, and a pixel's visits run in ascending (dy, dx)."""
    _, H, W, C, f, s, d = geometry
    Hout, Wout = _grid(H, W, f, s, d)
    L = f * f * C
    v = _col2im_visits(geometry)
    y, x, dy, dx, oy, ox = v.T
    pixel = y * W + x
    assert (np.diff(pixel) >= 0).all()
    same = np.diff(pixel) == 0
    key = dy * f + dx
    assert (np.diff(key)[same] > 0).all()
    c = np.arange(C)
    element = (((ox * Hout + oy) * L + key * C)[:, None] + c).ravel()
    assert np.array_equal(np.sort(element), np.arange(Hout * Wout * L))
    source = pixel_index((H, W, C), f, s, d, transposed=True).numpy()
    np.testing.assert_array_equal(source[element],
                                  (pixel[:, None] * C + c).ravel())


@pytest.mark.parametrize('geometry', GEOMETRIES, ids=IDS)
def test_col2im_emulated_sum_equals_plain(geometry):
    """K7's sum in its order, in float32, over one image's cotangent:
    within 1e-6 of the plain col2im (the plain version sums in another
    order), and zero at pixels no patch covers."""
    _, H, W, C, f, s, d = geometry
    Hout, Wout = _grid(H, W, f, s, d)
    L = f * f * C
    g = np.random.RandomState(1).randn(Hout * Wout, L).astype(np.float32)
    y, x, dy, dx, oy, ox = _col2im_visits(geometry).T
    acc = np.zeros((H * W, C), np.float32)
    rows = g[ox * Hout + oy].reshape(-1, f * f, C)[np.arange(len(y)),
                                                     dy * f + dx]
    for k in range(len(y)):          # the visits' order, one add each
        acc[y[k] * W + x[k]] += rows[k]
    want = cp.col2im_transposed_plain(torch.from_numpy(g)[None], (H, W, C),
                                      f, s, d).numpy().reshape(H * W, C)
    scale = max(float(np.abs(want).max()), 1.0)
    assert float(np.abs(acc - want).max()) <= 1e-6 * scale
    covered = np.zeros(H * W, bool)
    covered[y * W + x] = True
    assert (acc[~covered] == 0).all()
