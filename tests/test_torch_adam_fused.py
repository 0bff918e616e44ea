"""The Adam step's kernels (``ops/cuda_adam.py``, ``csrc/adam.cu``) on the
CPU: which steps take them, the chunk planner and the tables it passes by
value, the kernels' uint32 dither hash and their float32 order of
operations emulated in numpy and held bit for bit against the plain
route, the trainer's kernel branch run through the plain versions against
its plain branch, and the wrappers' checks and launch path with the C
entries stubbed."""

import ctypes
import re
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from deepcgp_tpu_torch.models.builder import build_model
from deepcgp_tpu_torch.ops import cuda_adam
from deepcgp_tpu_torch.training import optim, trainer
from deepcgp_tpu_torch.utils import profiling

SOURCE = (Path(cuda_adam.__file__).resolve().parent.parent / 'csrc'
          / 'adam.cu').read_text()


def f32_leaves(*shapes, dtype=torch.float32):
    return [torch.zeros(s, dtype=dtype) for s in shapes]


# ------------------------------------------------------------------ route


@pytest.mark.parametrize('optimizer,dtype,card,want', [
    ('Adam', torch.float32, True, True),
    ('Adam', torch.float32, False, False),
    ('Adam', torch.float64, True, False),
    ('SGD', torch.float32, True, False),
    ('NatGrad', torch.float32, True, False),
])
def test_route(monkeypatch, optimizer, dtype, card, want):
    """Adam with every parameter float32 on the card takes the kernels;
    the CPU, float64, SGD and NatGrad keep the plain route."""
    if card:
        monkeypatch.setattr(cuda_adam, '_on_card', lambda t: True)
    params = f32_leaves((3, 4), (5,), dtype=dtype)
    assert cuda_adam.route(optimizer, params) is want


def test_route_needs_every_leaf(monkeypatch):
    """One float64 leaf among float32 ones, or no leaf, keeps the plain
    route."""
    monkeypatch.setattr(cuda_adam, '_on_card', lambda t: True)
    mixed = f32_leaves((3,)) + f32_leaves((2,), dtype=torch.float64)
    assert not cuda_adam.route('Adam', mixed)
    assert not cuda_adam.route('Adam', [])


# ---------------------------------------------------------------- planner

SIZES = {
    'one element': [1],
    'an empty leaf': [0, 5, 0],
    'chunk edges': [cuda_adam.CHUNK - 1, cuda_adam.CHUNK,
                    cuda_adam.CHUNK + 1, 3 * cuda_adam.CHUNK + 5],
    'mnist q_sqrt and the small leaves': [10 * 1024 * 1024, 1024 * 784,
                                          10240, 784, 1, 1],
    'more leaves than one table': list(np.random.RandomState(0).randint(
        0, 3 * cuda_adam.CHUNK, size=150)),
}


def fake_specs(sizes, base=1 << 20):
    """Row-major specs at 16-byte aligned, disjoint fake addresses."""
    return [(base + 64 * i, base + 64 * i + 16, base + 64 * i + 32,
             base + 64 * i + 48, int(n), i % 2 == 0, i, None)
            for i, n in enumerate(sizes)]


@pytest.mark.parametrize('case', list(SIZES))
def test_planner_covers_every_element_once(case):
    """Each launch holds at most MAX_LEAVES contiguous leaves; every
    element of every leaf lies in exactly one chunk, no chunk crosses a
    leaf or is longer than CHUNK, and the tables carry each leaf as
    given."""
    sizes = SIZES[case]
    specs = fake_specs(sizes)
    runs = cuda_adam.launches(len(sizes))
    assert [i for run in runs for i in run] == list(range(len(sizes)))
    assert len(runs) == -(-len(sizes) // cuda_adam.MAX_LEAVES)
    covered = [np.zeros(n, dtype=np.int64) for n in sizes]
    for run in runs:
        assert 0 < len(run) <= cuda_adam.MAX_LEAVES
        t = cuda_adam.table(specs[run.start:run.stop])
        assert t.leaves == len(run)
        assert t.chunks == sum(-(-int(sizes[i]) // cuda_adam.CHUNK)
                               for i in run)
        for k, i in enumerate(run):
            p, g, m, v, n, bf16, salt, _ = specs[i]
            leaf = t.leaf[k]
            assert (leaf.p, leaf.g, leaf.m, leaf.v, leaf.n, leaf.salt_index
                    ) == (p, g, m, v, n, salt)
            assert leaf.flags == ((cuda_adam.BF16 if bf16 else 0)
                                  | cuda_adam.VECTOR)
        for k, first, end in cuda_adam.table_chunks(t):
            n = sizes[run[k]]
            assert 0 <= first < end <= n and end - first <= cuda_adam.CHUNK
            assert first % cuda_adam.CHUNK == 0
            covered[run[k]][first:end] += 1
    assert all((c == 1).all() for c in covered)


def test_table_fits_the_parameter_space():
    """Each launch's by-value block (the table and the pointers beside
    it) fits a kernel's parameter space, and a table refuses more than
    MAX_LEAVES leaves."""
    table = ctypes.sizeof(cuda_adam.Table)
    assert table + 8 * cuda_adam.UPDATE_POINTERS <= cuda_adam.PARAM_BYTES
    assert table + 8 <= cuda_adam.PARAM_BYTES
    assert table == (80 * cuda_adam.MAX_LEAVES + 4 * cuda_adam.MAX_LEAVES
                     + 32)
    with pytest.raises(ValueError):
        cuda_adam.table(fake_specs([1] * (cuda_adam.MAX_LEAVES + 1)))


def test_unaligned_leaves_take_the_scalar_loop():
    """A leaf with a pointer off 16 bytes loses the VECTOR flag."""
    aligned = fake_specs([8])[0]
    t = cuda_adam.table([aligned, (aligned[0], aligned[1] + 4, *aligned[2:])])
    assert [t.leaf[i].flags & cuda_adam.VECTOR for i in (0, 1)] == [
        cuda_adam.VECTOR, 0]


@pytest.mark.parametrize('bf16', [True, False])
def test_a_mapped_leaf_carries_its_map(bf16):
    """A bf16 leaf laid out otherwise than row-major carries its map
    (unused dims of size 1) and takes 16-byte loads only where its
    innermost dim is a multiple of 4; a float32-moment leaf needs no map."""
    spec = list(fake_specs([8])[0])
    wide = cuda_adam.table([(*spec[:5], bf16, 0, [(12, 12), (12, 1),
                                                  (4, 144)])])
    odd = cuda_adam.table([(*spec[:5], bf16, 0, [(6, 3), (3, 1)])])
    for t, sizes, strides in ((wide, [12, 12, 4, 1], [12, 1, 144, 0]),
                              (odd, [6, 3, 1, 1], [3, 1, 0, 0])):
        leaf = t.leaf[0]
        assert bool(leaf.flags & cuda_adam.MAPPED) is bf16
        if bf16:
            assert (list(leaf.map_size), list(leaf.map_stride)) == (
                sizes, strides)
    assert wide.leaf[0].flags & cuda_adam.VECTOR
    assert bool(odd.leaf[0].flags & cuda_adam.VECTOR) is not bf16


def test_source_constants_are_the_wrappers():
    """csrc/adam.cu's table, chunk, flags and hash constants are the ones
    the wrapper builds its tables with and the tests emulate."""
    def const(name):
        m = re.search(rf'constexpr \w+ {name} = (0x[0-9A-Fa-f]+|\d+)u?;',
                      SOURCE)
        return int(m.group(1), 0)
    assert const('kMaxLeaves') == cuda_adam.MAX_LEAVES
    assert const('kChunk') == cuda_adam.CHUNK
    assert (const('kBf16'), const('kVector'), const('kMapped'),
            const('kMapDims')) == (cuda_adam.BF16, cuda_adam.VECTOR,
                                   cuda_adam.MAPPED, cuda_adam.MAP_DIMS)
    assert (const('kIndexMul'), const('kMix1'), const('kMix2'),
            const('kSaltStep')) == (cuda_adam.INDEX_MUL, cuda_adam.MIX1,
                                    cuda_adam.MIX2, cuda_adam.SALT_STEP)
    shifts = [int(s) for s in re.findall(r'h \^= h >> (\d+);', SOURCE)]
    assert tuple(shifts) == cuda_adam.SHIFTS
    assert cuda_adam.CONSTANTS == tuple(float(np.float32(x)) for x in (
        0.9, 1.0 - 0.9, 0.999, 1.0 - 0.999, 1e-8))


# ------------------------------------------------------ numpy emulation


def np_dither(index, salt):
    """The kernel's dither: uint32 wrapping products, logical shifts."""
    h = index.astype(np.uint32) * np.uint32(cuda_adam.INDEX_MUL) \
        + np.uint32(salt)
    h ^= h >> np.uint32(cuda_adam.SHIFTS[0])
    h *= np.uint32(cuda_adam.MIX1)
    h ^= h >> np.uint32(cuda_adam.SHIFTS[1])
    h *= np.uint32(cuda_adam.MIX2)
    h ^= h >> np.uint32(cuda_adam.SHIFTS[2])
    return h & np.uint32(0xFFFF)


def np_sr_bf16(x, salt, index=None):
    """The kernel's store of float32 ``x`` as bf16 bits, the element at
    ``x``'s position k dithered by flat index ``index[k]`` (default k):
    the dithered bit pattern's top half; a NaN comes out canonical
    (cvt.rn)."""
    index = np.arange(x.size) if index is None else index
    u = (x.reshape(-1).view(np.uint32)
         + np_dither(index, salt)) & np.uint32(0xFFFF0000)
    bits = (u >> np.uint32(16)).astype(np.uint16)
    bits[np.isnan(u.view(np.float32))] = 0x7FFF
    return bits.reshape(x.shape)


def np_flat_index(pairs, n):
    """The kernel's ``flat_index`` of memory offsets 0..n-1 through a
    leaf's map, in uint32."""
    rest = np.arange(n, dtype=np.uint32)
    if pairs is None:
        return rest
    index = np.zeros(n, dtype=np.uint32)
    for size, stride in pairs:
        index += rest % np.uint32(size) * np.uint32(stride & 0xFFFFFFFF)
        rest //= np.uint32(size)
    return index


def bf16_bits(t):
    return t.view(torch.int16).numpy().view(np.uint16)


def memory(t):
    """A dense tensor's elements in memory order, as numpy (bf16 as its
    uint16 bits)."""
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    flat = t.as_strided((t.numel(),), (1,)).numpy()
    return flat.view(np.uint16) if t.dtype == torch.int16 else flat


@pytest.mark.parametrize('salt', [0, 1, 0x9E3779B9, 0xFFFFFFFF, 123456789])
def test_uint32_hash_matches_sr_to_bf16(salt):
    """The 32-bit hash and rounding, from the wrapper's constants, bit for
    bit ``optim._sr_to_bf16`` on random magnitudes, zeros, denormals,
    exact bf16 values, the float32 extremes and infinities; a NaN stays
    NaN."""
    rng = np.random.RandomState(salt % 1000)
    x = np.concatenate([
        rng.randn(3000) * np.exp(rng.uniform(-30, 30, 3000)),
        [0.0, -0.0, 1e-40, -3e-42, 1.4e-45, 1.0, -2.0, 3.0, np.inf, -np.inf,
         np.finfo(np.float32).max, -np.finfo(np.float32).max,
         np.finfo(np.float32).tiny, np.nan]]).astype(np.float32)
    ours = np_sr_bf16(x, salt)
    ref = bf16_bits(optim._sr_to_bf16(torch.as_tensor(x), salt))
    finite = ~np.isnan(x)
    np.testing.assert_array_equal(ours[finite], ref[finite])
    assert ours[~finite].tolist() == [0x7FFF]
    nan = ref[~finite]
    assert ((nan & 0x7F80) == 0x7F80).all() and (nan & 0x7F).all()


LAYOUTS = {
    'row-major': ((3, 4, 5), (0, 1, 2)),
    'column-major matrices (a fresh q_sqrt)': ((4, 12, 12), (0, 2, 1)),
    'a permutation': ((3, 4, 5), (2, 0, 1)),
    'size-1 dims': ((1, 6, 1, 8), (3, 1, 0, 2)),
    'a 4-d permutation': ((2, 3, 4, 5), (3, 1, 2, 0)),
}


def laid_out(shape, order, values=None):
    """A tensor of ``shape`` whose dims lie in memory in ``order``
    (outermost first), holding ``values`` (default zeros)."""
    base = torch.zeros([shape[d] for d in order], dtype=torch.int64
                       if values is None else values.dtype)
    t = base.permute(*np.argsort(order))
    if values is not None:
        t.copy_(values)
    return t


@pytest.mark.parametrize('layout', list(LAYOUTS))
def test_index_map_gives_the_flat_index(layout):
    """A dense layout's map, walked as the kernel walks it, gives each
    memory offset the row-major flat index of the element there."""
    shape, order = LAYOUTS[layout]
    n = int(np.prod(shape))
    t = laid_out(shape, order, torch.arange(n).reshape(shape))
    pairs = cuda_adam.index_map(t.shape, t.stride())
    assert (pairs is None) == t.is_contiguous()
    np.testing.assert_array_equal(np_flat_index(pairs, n),
                                  memory(t).astype(np.uint32))


def test_index_map_refuses_what_the_kernel_cannot_walk():
    """A layout with gaps, and one of five dims no two of which merge."""
    with pytest.raises(ValueError):
        cuda_adam.index_map((4, 4), (8, 1))
    t = laid_out((2, 3, 2, 3, 2), (4, 3, 2, 1, 0))
    with pytest.raises(ValueError):
        cuda_adam.index_map(t.shape, t.stride())


def np_adam(p, g, m, v, c1, c2, lr):
    """The kernel's element arithmetic in float32, one rounding each.  The
    square root is torch's: on the CPU its vectorised float32 square root
    is not always the correctly rounded one numpy's is (on the card both
    torch's and the kernel's are, which chip_smoke.py holds bit for
    bit)."""
    b1, omb1, b2, omb2, eps = (np.float32(c) for c in cuda_adam.CONSTANTS)
    m = b1 * m + omb1 * g
    v = b2 * v + omb2 * (g * g)
    root = torch.sqrt(torch.as_tensor(v / c2)).numpy()
    u = (m / c1) / (root + eps)
    return p - lr * u, m, v


def np_kernel_step(leaf, c1, c2, lr, salt0):
    """The update kernel on one leaf, emulated: p, m and v walked in
    memory order, a bf16 moment dithered by the flat index its map gives.
    Returns the memory images of p', m', v'."""
    bf16 = leaf.m.dtype == torch.bfloat16

    def floats(t):
        x = memory(t)
        return (x.astype(np.uint32) << np.uint32(16)).view(np.float32) \
            if bf16 else x.copy()
    p, m, v = np_adam(memory(leaf.p).copy(), memory(leaf.g), floats(leaf.m),
                      floats(leaf.v), np.float32(c1), np.float32(c2),
                      np.float32(lr))
    if not bf16:
        return p, m, v
    index = np_flat_index(cuda_adam.index_map(leaf.p.shape, leaf.p.stride()),
                          leaf.p.numel())
    s = int(optim.moment_salt(salt0, leaf.salt_index))
    return (p, np_sr_bf16(m, s, index),
            np_sr_bf16(v, (s + cuda_adam.SALT_STEP) & 0xFFFFFFFF, index))


@pytest.mark.parametrize('layout', list(LAYOUTS)[:3])
@pytest.mark.parametrize('moments', ['float32', 'bf16'])
def test_kernel_arithmetic_matches_the_plain_route(moments, layout):
    """Four steps of the update kernel, emulated in numpy over memory
    (its order of operations, its dither index through the leaf's map),
    against ``cuda_adam.adam_step_plain`` (``optim.adam_leaf`` and the
    trainer's commit) on a parameter laid out as a fresh q_sqrt is, or
    otherwise: p, m and v bit-equal, and a step whose ``ok`` is False
    changes nothing.  The gradient arrives row-major and is copied into
    the parameter's layout (``cuda_adam.leaves``)."""
    rng = np.random.RandomState(3)
    shape, order = LAYOUTS[layout]
    mdtype = torch.bfloat16 if moments == 'bf16' else torch.float32
    p = laid_out(shape, order, torch.as_tensor(
        rng.randn(*shape).astype(np.float32)))
    m, v = torch.zeros_like(p, dtype=mdtype), torch.zeros_like(p, dtype=mdtype)
    state = {'mu': {'w': m}, 'nu': {'w': v}, 'salt_index': {'w': 3}}
    count = torch.zeros((), dtype=torch.int64)
    lr = torch.tensor(0.01, dtype=torch.float32)
    for step, ok in enumerate([True, True, False, True]):
        g = torch.as_tensor((rng.randn(*shape) * 10.0 ** rng.uniform(
            -6, 2, shape)).astype(np.float32))
        leaf, = cuda_adam.leaves({'w': p}, {'w': g}, state)
        assert leaf.g.stride() == p.stride() and torch.equal(leaf.g, g)
        new_count, salt0 = optim.adam_count(count)
        c1, c2 = optim.adam_bias(new_count, torch.float32)
        before = [t.clone() for t in (p, m, v)]
        want = np_kernel_step(leaf, c1, c2, lr, salt0)
        cuda_adam.adam_step_plain([leaf], c1, c2, lr, salt0,
                                  torch.tensor(ok))
        assert [t.stride() for t in (p, m, v)] == [
            t.stride() for t in before]
        if not ok:
            assert all(torch.equal(a, b) for a, b in zip(before, (p, m, v)))
            continue
        count = new_count
        for name, got, w in zip('pmv', (p, m, v), want):
            np.testing.assert_array_equal(
                memory(got).view(np.uint16 if w.dtype == np.uint16
                                 else np.uint32),
                w.view(np.uint16 if w.dtype == np.uint16 else np.uint32),
                f'{name} at step {step}')


# ------------------------------------------------- the trainer's branches

IMAGE = (8, 8, 1)


def small_state(seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(48, *IMAGE).astype(np.float32)
    Y = rng.randint(0, 10, size=(48, 1))
    flags = types.SimpleNamespace(
        M='6,8', feature_maps='2', filter_sizes='3,3', strides='1,1',
        base_kernel='rbf', last_kernel='conv', white=False,
        identity_mean=False, num_samples=2)
    model = build_model(flags, IMAGE, images=X,
                        generator=torch.Generator().manual_seed(seed),
                        device='cpu')
    config = trainer.TrainConfig(optimizer='Adam', batch_size=8)
    state = trainer.init_state(model, config, seed=seed)
    return (state, config, torch.as_tensor(X.reshape(48, -1)),
            torch.as_tensor(Y))


def state_bits(state) -> dict:
    out = {f'p {k}': p.detach().clone() for k, p in state.params.items()}
    for m in ('mu', 'nu'):
        out.update({f'{m} {k}': t.clone()
                    for k, t in state.opt_state[m].items()})
    out['count'] = state.opt_state['count'].clone()
    out['step'] = state.step.clone()
    return out


@pytest.mark.parametrize('bf16_from', [1 << 22, 48])
def test_trainer_kernel_branch_equals_the_plain_branch(monkeypatch,
                                                       bf16_from):
    """The trainer's kernel branch (one finiteness flag, the scalars once
    a step, the wrappers' in-place commit), run on the CPU through the
    wrappers' plain versions, against the plain branch from the same
    state: five steps, the third with a NaN planted in one gradient; every
    parameter, moment, the count and the ELBOs bit-equal, the NaN step
    changing nothing but the step counter.  With ``bf16_from`` 48 the
    layers' q_sqrt and Z leaves take bf16 moments."""
    monkeypatch.setattr(optim, 'AUTO_BF16_MIN_ELEMENTS', bf16_from)
    real = trainer.loss_and_grads
    calls = {'n': 0}

    def planted(state, xb, yb, noise=None):
        loss, grads = real(state, xb, yb, noise)
        calls['n'] += 1
        if calls['n'] % 5 == 3:
            name = sorted(grads)[0]
            grads[name] = grads[name].clone()
            grads[name].view(-1)[0] = float('nan')
        return loss, grads

    monkeypatch.setattr(trainer, 'loss_and_grads', planted)
    runs = {}
    for fused in (False, True):
        monkeypatch.setattr(cuda_adam, 'route',
                            lambda optimizer, params, f=fused: f)
        state, config, X, Y = small_state()
        if bf16_from < 1 << 22:
            assert any(m.dtype == torch.bfloat16
                       for m in state.opt_state['mu'].values())
        steps = profiling.COUNTERS['fused adam steps']
        trace, bits = [], []
        for _ in range(5):
            trace.append(trainer.run_chunk(state, config, X, Y, 1)[0])
            bits.append(state_bits(state))
        assert profiling.COUNTERS['fused adam steps'] - steps == (
            5 if fused else 0)
        runs[fused] = torch.stack(trace), bits
    plain, fused = runs[False], runs[True]
    assert torch.equal(plain[0], fused[0])
    for a, b in zip(plain[1], fused[1]):
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].stride() == b[k].stride()
            assert np.array_equal(memory(a[k]).view(np.uint8),
                                  memory(b[k]).view(np.uint8)), k
    # The NaN step (the third) committed nothing.
    before, after = fused[1][1], fused[1][2]
    assert all(torch.equal(before[k], after[k]) for k in before if k != 'step')
    assert int(after['count']) == 2 and int(after['step']) == 3


def test_cpu_wrappers_launch_nothing():
    """On CPU tensors the wrappers run their plain versions and count no
    launch."""
    launches = cuda_adam.adam_step.launches
    p, g, m, v = f32_leaves((4, 3), (4, 3), (4, 3), (4, 3))
    items = [cuda_adam.Leaf(p, g, m, v)]
    ok = cuda_adam.all_finite(items)
    assert ok.dtype == torch.bool and bool(ok)
    count, salt0 = optim.adam_count(torch.zeros((), dtype=torch.int64))
    cuda_adam.adam_step(items, *optim.adam_bias(count, torch.float32),
                        torch.tensor(0.01), salt0, ok)
    assert cuda_adam.adam_step.launches == launches


# ------------------------------------------- the launch path, C stubbed


@pytest.fixture
def stubbed(monkeypatch):
    """The wrappers' card path on CPU tensors: every tensor counts as on
    the card, each C entry is a stub that records the table it is given
    (read back from its address) and returns success."""
    calls = []

    def function(symbol, pointers):
        def entry(table, *args):
            t = cuda_adam.Table.from_address(table)
            calls.append((symbol, t.leaves, t.chunks,
                          [(t.leaf[i].p, t.leaf[i].n, t.leaf[i].flags,
                            t.leaf[i].salt_index) for i in range(t.leaves)],
                          args))
            return 0
        return entry

    monkeypatch.setattr(cuda_adam, '_on_card', lambda t: True)
    monkeypatch.setattr(cuda_adam, '_function', function)
    monkeypatch.setattr(cuda_adam, '_launch_args', lambda device: (132, 0))
    return calls


def scalars():
    count, salt0 = optim.adam_count(torch.zeros((), dtype=torch.int64))
    return (*optim.adam_bias(count, torch.float32), torch.tensor(0.01),
            salt0, torch.tensor(True))


@pytest.mark.parametrize('n_leaves', [13, cuda_adam.MAX_LEAVES,
                                      cuda_adam.MAX_LEAVES + 1, 150])
def test_launch_path_counts_and_tables(stubbed, n_leaves):
    """Two launches a step (one of each pass) per table of MAX_LEAVES
    leaves; the tables hold the tensors' own pointers, sizes, moment
    types and salt indices; p, m and v have their version counters bumped
    (what is keyed by them, as cuda_cross's padded Z, sees the kernel's
    write); the launch records' bytes are 4 B an element for the
    finiteness pass, 20 B (bf16 moments) or 28 B (float32) for the
    update."""
    rng = np.random.RandomState(n_leaves)
    items = []
    for i in range(n_leaves):
        n = int(rng.randint(1, 3000))
        mdtype = torch.bfloat16 if i % 3 == 0 else torch.float32
        items.append(cuda_adam.Leaf(
            torch.zeros(n), torch.zeros(n), torch.zeros(n, dtype=mdtype),
            torch.zeros(n, dtype=mdtype), salt_index=i // 3))
    tables = -(-n_leaves // cuda_adam.MAX_LEAVES)
    launches = cuda_adam.adam_step.launches
    versions = [[t._version for t in (x.p, x.m, x.v)] for x in items]
    with profiling.observe_launches() as record:
        cuda_adam.all_finite(items)
        cuda_adam.adam_step(items, *scalars())
    assert cuda_adam.adam_step.launches - launches == 2 * tables
    # Written in place behind autograd: every p, m and v counts as written.
    assert all(t._version > v for x, vs in zip(items, versions)
               for t, v in zip((x.p, x.m, x.v), vs))
    assert [c[0] for c in stubbed] == (['adam_all_finite'] * tables
                                       + ['adam_update'] * tables)
    for symbol in ('adam_all_finite', 'adam_update'):
        got = [leaf for c in stubbed if c[0] == symbol for leaf in c[3]]
        assert got == [(x.p.data_ptr(), x.p.numel(),
                        (cuda_adam.BF16 if x.m.dtype == torch.bfloat16
                         else 0) | (cuda_adam.VECTOR if x.p.data_ptr() % 16
                                    == 0 and x.g.data_ptr() % 16 == 0
                                    and x.m.data_ptr() % 16 == 0
                                    and x.v.data_ptr() % 16 == 0 else 0),
                        x.salt_index) for x in items]
    n32 = sum(x.p.numel() for x in items if x.m.dtype == torch.float32)
    n16 = sum(x.p.numel() for x in items if x.m.dtype == torch.bfloat16)
    finite = sum(r[1] for r in record if r[0] == 'adam_all_finite')
    update = sum(r[1] + r[2] for r in record if r[0] == 'adam_update')
    assert finite == 4 * (n32 + n16)
    assert update == 28 * n32 + 20 * n16


@pytest.mark.parametrize('broken', ['strided g', 'float64', 'shape',
                                    'mixed moments', 'float16 moments',
                                    'not dense'])
def test_wrappers_raise_on_what_the_kernels_do_not_take(stubbed, broken):
    """A card input the kernels do not take raises before any launch."""
    p, g, m, v = f32_leaves((4, 6), (4, 6), (4, 6), (4, 6))
    if broken == 'strided g':
        g = torch.zeros(6, 4).t()
    elif broken == 'float64':
        p, g = p.double(), g.double()
    elif broken == 'shape':
        m = torch.zeros(24)
    elif broken == 'mixed moments':
        m = m.bfloat16()
    elif broken == 'not dense':
        p, g, m, v = (torch.zeros(4, 12)[:, :6] for _ in range(4))
    else:
        m, v = m.half(), v.half()
    items = [cuda_adam.Leaf(p, g, m, v)]
    with pytest.raises((ValueError, TypeError)):
        cuda_adam.adam_step(items, *scalars())
    with pytest.raises((ValueError, TypeError)):
        cuda_adam.all_finite(items)
    assert stubbed == []


@pytest.mark.parametrize('which', ['c1', 'lr', 'salt0', 'ok'])
def test_update_raises_on_a_scalar_of_another_dtype(stubbed, which):
    """The step's scalars: float32 c1, c2 and lr, int64 salt0, bool ok."""
    items = [cuda_adam.Leaf(*f32_leaves((8,), (8,), (8,), (8,)))]
    c1, c2, lr, salt0, ok = scalars()
    args = dict(c1=c1, c2=c2, lr=lr, salt0=salt0, ok=ok)
    args[which] = args[which].double() if which != 'ok' else args[which].int()
    with pytest.raises(ValueError):
        cuda_adam.adam_step(items, **args)
    assert stubbed == []
