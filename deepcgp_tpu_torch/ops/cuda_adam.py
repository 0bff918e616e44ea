"""The Adam step of every float32 leaf and its guarded commit, in two
launches of ``csrc/adam.cu``.

:func:`all_finite` reads every gradient of a table of leaves and writes
one device flag, True when all are finite (the commit guard's gradient
half); :func:`adam_step` then forms, for each element of each leaf, the
moments, the bias-corrected update and the new parameter in registers,
stores bf16 moments by the stochastic rounding of
``training.optim._sr_to_bf16`` (its hash in uint32), and writes p, m and v
in place only where the device flag ``ok`` is set.  Both are bit for bit
``optim.adam_updates`` followed by the trainer's ``torch.where`` commit,
which is their plain version (:func:`all_finite_plain`,
:func:`adam_step_plain`): on a CPU tensor the wrappers run it, on a CUDA
tensor they launch the kernels or raise.

The leaves travel by value in the kernels' parameter space, as a
multi-tensor apply passes them: :func:`launches` cuts a list of leaves
into launches of at most ``MAX_LEAVES`` leaves, :func:`table` each leaf
into chunks of ``CHUNK`` elements (:func:`table_chunks` walks them as a
block does).  A captured step keeps the table in its graph node, so the
parameters, the moments and the graph pool's gradients, which keep their
addresses across replays, are all a replay needs.

``adam_step.launches`` counts the launches of both kernels.
:func:`route` is where the trainer takes them: Adam, on the card, every
leaf float32.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from deepcgp_tpu_torch.ops import cuda_build
from deepcgp_tpu_torch.training import optim
from deepcgp_tpu_torch.utils import profiling

# The kernels' constants (csrc/adam.cu): leaves of one table, elements of
# a chunk, and a kernel's parameter space in bytes.
MAX_LEAVES = 40
CHUNK = 2048
PARAM_BYTES = 4096
# Leaf flags: bf16 moments; 16-byte loads (every pointer 16-byte aligned
# and, for a mapped leaf, its innermost dim a multiple of 4); a layout
# other than row-major, whose dither index goes through the leaf's map of
# at most MAP_DIMS dims.
BF16, VECTOR, MAPPED = 1, 2, 4
MAP_DIMS = 4
# The dither hash of ``optim._sr_to_bf16``: index multiplier, the two
# mixing products, the shifts of its three xor-shifts, and the salt step
# between moment streams.
INDEX_MUL, MIX1, MIX2 = 2654435761, 0x2C1B3C6D, 0x297A2D39
SHIFTS = (15, 12, 15)
SALT_STEP = 0x85EBCA77
# b1, 1 - b1, b2, 1 - b2 and eps as float32, as torch casts the Python
# scalars of ``optim.adam_updates`` for a float32 tensor.
CONSTANTS = tuple(float(np.float32(x)) for x in (
    optim.ADAM_B1, 1.0 - optim.ADAM_B1, optim.ADAM_B2, 1.0 - optim.ADAM_B2,
    optim.ADAM_EPS))


class _Leaf(ctypes.Structure):
    _fields_ = [('p', ctypes.c_void_p), ('g', ctypes.c_void_p),
                ('m', ctypes.c_void_p), ('v', ctypes.c_void_p),
                ('n', ctypes.c_int64), ('flags', ctypes.c_int32),
                ('salt_index', ctypes.c_uint32),
                ('map_size', ctypes.c_uint32 * MAP_DIMS),
                ('map_stride', ctypes.c_uint32 * MAP_DIMS)]


class Table(ctypes.Structure):
    """``AdamTable`` of csrc/adam.cu: one launch's leaves, the running
    count of their chunks, and the float32 constants."""
    _fields_ = [('leaf', _Leaf * MAX_LEAVES),
                ('chunk_end', ctypes.c_int32 * MAX_LEAVES),
                ('leaves', ctypes.c_int32), ('chunks', ctypes.c_int32),
                ('b1', ctypes.c_float), ('omb1', ctypes.c_float),
                ('b2', ctypes.c_float), ('omb2', ctypes.c_float),
                ('eps', ctypes.c_float)]


# The pointer arguments adam_update takes beside its table.
UPDATE_POINTERS = 5


@dataclasses.dataclass(frozen=True)
class Leaf:
    """One Adam leaf: the parameter, its gradient, its moments, and its
    number among the bf16 leaves (the dither salt's index; 0 for a leaf
    with exact moments)."""
    p: torch.Tensor
    g: torch.Tensor
    m: torch.Tensor
    v: torch.Tensor
    salt_index: int = 0


def _layout(t: torch.Tensor) -> tuple:
    """The strides of ``t``'s dims of more than one element."""
    return tuple(s for s, n in zip(t.stride(), t.shape) if n != 1)


def leaves(params: dict, grads: dict, opt_state: dict) -> list:
    """The Leaf of every gradient's parameter, in the order of ``grads``;
    a gradient whose layout is not its parameter's is copied into it (the
    kernels walk the four tensors' memory side by side)."""
    salt = opt_state['salt_index']
    out = []
    for k, g in grads.items():
        p = params[k]
        if _layout(g) != _layout(p):
            g = torch.empty_like(p).copy_(g)
        out.append(Leaf(p, g, opt_state['mu'][k], opt_state['nu'][k],
                        salt.get(k, 0)))
    return out


def _on_card(t: torch.Tensor) -> bool:
    return t.device.type == 'cuda'


def route(optimizer: str, params) -> bool:
    """True where the trainer's Adam step takes the kernels: Adam (not SGD,
    not NatGrad, whose Adam half commits through its rollback), every
    parameter on the card and float32, whatever its moments' dtype."""
    params = list(params)
    return (optimizer == 'Adam' and bool(params)
            and all(_on_card(p) and p.dtype == torch.float32 for p in params))


# ------------------------------------------------------------ the table


def _aligned(*ptrs) -> bool:
    return all(p % 16 == 0 for p in ptrs)


def index_map(shape, strides) -> list | None:
    """The map of a dense layout: [(size, row-major stride)] of its dims
    in memory order, innermost first, runs that are contiguous in both
    orders merged (so the element at memory offset o has the flat index
    sum_k (o // prod_{j<k} size_j % size_k) * stride_k); None for a
    row-major layout.  Raises on a layout that is not dense or needs more
    than MAP_DIMS dims."""
    row = [1] * len(shape)
    for d in range(len(shape) - 2, -1, -1):
        row[d] = row[d + 1] * shape[d + 1]
    pairs, extent = [], 1
    for d in sorted((d for d in range(len(shape)) if shape[d] != 1),
                    key=lambda d: strides[d]):
        if strides[d] != extent:
            raise ValueError(f'adam: layout {tuple(strides)} of '
                             f'{tuple(shape)} is not dense')
        extent *= shape[d]
        if pairs and pairs[-1][0] * pairs[-1][1] == row[d]:
            pairs[-1] = (pairs[-1][0] * shape[d], pairs[-1][1])
        else:
            pairs.append((shape[d], row[d]))
    if len(pairs) <= 1:
        return None
    if len(pairs) > MAP_DIMS:
        raise ValueError(f'adam: layout {tuple(strides)} of {tuple(shape)} '
                         f'needs {len(pairs)} dims, more than {MAP_DIMS}')
    return pairs


def table(specs: list) -> Table:
    """The table of one launch over ``specs`` [(p, g, m, v pointers,
    elements, bf16 moments, salt index, index map)], at most MAX_LEAVES of
    them: each leaf cut into ceil(n / CHUNK) chunks."""
    if len(specs) > MAX_LEAVES:
        raise ValueError(f'adam: {len(specs)} leaves in one table')
    t = Table()
    t.b1, t.omb1, t.b2, t.omb2, t.eps = CONSTANTS
    chunks = 0
    for i, (p, g, m, v, n, bf16, salt, pairs) in enumerate(specs):
        mapped = bf16 and pairs is not None
        vector = _aligned(p, g, m, v) and not (mapped and pairs[0][0] % 4)
        leaf = _Leaf(p, g, m, v, n, (BF16 if bf16 else 0)
                     | (VECTOR if vector else 0)
                     | (MAPPED if mapped else 0), salt)
        for k, (size, stride) in enumerate(pairs if mapped else []):
            leaf.map_size[k], leaf.map_stride[k] = size, stride & 0xFFFFFFFF
        for k in range(len(pairs) if mapped else 0, MAP_DIMS):
            leaf.map_size[k], leaf.map_stride[k] = 1, 0
        t.leaf[i] = leaf
        chunks += -(-n // CHUNK)
        t.chunk_end[i] = chunks
    t.leaves, t.chunks = len(specs), chunks
    return t


def launches(count: int) -> list:
    """The leaves of each launch over ``count`` leaves: contiguous runs of
    at most MAX_LEAVES."""
    return [range(s, min(s + MAX_LEAVES, count))
            for s in range(0, count, MAX_LEAVES)]


def table_chunks(t: Table) -> list:
    """[(leaf, first, end)] of every chunk of ``t``, as the kernels' blocks
    find them (chunk c lies in the first leaf whose chunk_end exceeds c)."""
    out, leaf = [], 0
    for c in range(t.chunks):
        while c >= t.chunk_end[leaf]:
            leaf += 1
        first = (c - (t.chunk_end[leaf - 1] if leaf else 0)) * CHUNK
        out.append((leaf, first, min(first + CHUNK, t.leaf[leaf].n)))
    return out


def _specs(items: list) -> list:
    """Check every leaf the kernels take (p, g, m and v on the card, of
    one shape and one dense layout, float32 parameters and gradients,
    float32 or bf16 moments); its table spec."""
    specs = []
    for x in items:
        for name, t in (('p', x.p), ('g', x.g), ('m', x.m), ('v', x.v)):
            if not _on_card(t):
                raise ValueError(f'adam: {name} is on {t.device}, not the card')
            if t.shape != x.p.shape or _layout(t) != _layout(x.p):
                raise ValueError(f'adam: {name} {tuple(t.shape)} strides '
                                 f'{t.stride()} for a parameter '
                                 f'{tuple(x.p.shape)} strides {x.p.stride()}')
        if x.p.numel() >= 1 << 31:
            raise ValueError(f'adam: {x.p.numel()} elements in one leaf')
        pairs = index_map(x.p.shape, x.p.stride())
        if x.p.dtype != torch.float32 or x.g.dtype != torch.float32:
            raise TypeError(f'adam: float32 parameters and gradients only, '
                            f'got {x.p.dtype}, {x.g.dtype}')
        if (x.m.dtype != x.v.dtype
                or x.m.dtype not in (torch.float32, torch.bfloat16)):
            raise TypeError(f'adam: float32 or bf16 moments, got '
                            f'{x.m.dtype}, {x.v.dtype}')
        specs.append((x.p.data_ptr(), x.g.data_ptr(), x.m.data_ptr(),
                      x.v.data_ptr(), x.p.numel(),
                      x.m.dtype == torch.bfloat16, x.salt_index, pairs))
    return specs


def _check_scalars(**scalars) -> None:
    dtypes = {'c1': torch.float32, 'c2': torch.float32, 'lr': torch.float32,
              'salt0': torch.int64, 'ok': torch.bool}
    for name, t in scalars.items():
        if t.dtype != dtypes[name] or t.numel() != 1 or not _on_card(t):
            raise ValueError(f'adam: {name} must be one {dtypes[name]} on '
                             f'the card, got {t.dtype} {tuple(t.shape)} on '
                             f'{t.device}')


def _function(symbol: str, pointers: int):
    fn = cuda_build.function(
        'adam', symbol,
        [ctypes.c_void_p] * pointers + [ctypes.c_int, ctypes.c_void_p])
    size = cuda_build.function('adam', 'adam_table_bytes', [])()
    if size != ctypes.sizeof(Table):
        raise RuntimeError(f'adam: the library\'s table is {size} bytes, the '
                           f'wrapper\'s {ctypes.sizeof(Table)}')
    return fn


def _launch_args(device):
    return (torch.cuda.get_device_properties(device).multi_processor_count,
            torch.cuda.current_stream(device).cuda_stream)


# ------------------------------------------------------------ the passes


def all_finite_plain(items: list) -> torch.Tensor:
    """Plain version of :func:`all_finite`: the trainer's per-leaf
    ``isfinite().all()``."""
    ok = torch.ones((), dtype=torch.bool, device=items[0].g.device)
    for x in items:
        ok = ok & torch.isfinite(x.g).all()
    return ok


def all_finite(items: list) -> torch.Tensor:
    """A bool device scalar: every gradient of ``items`` (Leaf) finite.
    On the card one memset and one launch per table; a CPU tensor takes
    :func:`all_finite_plain`."""
    if not _on_card(items[0].g):
        return all_finite_plain(items)
    specs = _specs(items)
    fn = _function('adam_all_finite', 2)
    sms, stream = _launch_args(items[0].g.device)
    flag = None
    for run in launches(len(items)):
        part = torch.empty((), dtype=torch.bool, device=items[0].g.device)
        t = table(specs[run.start:run.stop])
        with profiling.launch('adam_all_finite',
                              [items[i].g for i in run], (part,)):
            cuda_build.check(fn(ctypes.addressof(t), part.data_ptr(), sms,
                                stream), 'adam_all_finite')
        adam_step.launches += 1
        flag = part if flag is None else flag & part
    return flag


def adam_step_plain(items: list, c1, c2, lr, salt0, ok) -> None:
    """Plain version of :func:`adam_step`: ``optim.adam_leaf`` on each
    leaf, committed by ``torch.where`` and ``copy_`` where ``ok``."""
    for x in items:
        u, m, v = optim.adam_leaf(x.g, x.m, x.v, c1, c2, salt0,
                                  x.salt_index)
        x.m.copy_(torch.where(ok, m, x.m))
        x.v.copy_(torch.where(ok, v, x.v))
        x.p.copy_(torch.where(ok, x.p - lr.to(x.p.dtype) * u, x.p))


def adam_step(items: list, c1: torch.Tensor, c2: torch.Tensor,
              lr: torch.Tensor, salt0: torch.Tensor, ok: torch.Tensor) -> None:
    """One Adam step of every leaf of ``items`` (Leaf), written in place
    where the device flag ``ok`` holds: ``c1``, ``c2`` the step's bias
    corrections, ``lr`` its learning rate, ``salt0`` its dither salt
    (``optim.adam_count``).  On the card one launch per table, after
    which p, m and v count as written in place (their version counters
    bumped); a CPU tensor takes :func:`adam_step_plain`.

    ``adam_step.launches`` counts this kernel's and :func:`all_finite`'s
    launches."""
    if not _on_card(items[0].p):
        return adam_step_plain(items, c1, c2, lr, salt0, ok)
    specs = _specs(items)
    _check_scalars(c1=c1, c2=c2, lr=lr, salt0=salt0, ok=ok)
    fn = _function('adam_update', 1 + UPDATE_POINTERS)
    sms, stream = _launch_args(ok.device)
    for run in launches(len(items)):
        touched = [x for i in run for x in (items[i].p, items[i].m,
                                             items[i].v)]
        t = table(specs[run.start:run.stop])
        with profiling.launch('adam_update',
                              touched + [items[i].g for i in run], touched):
            cuda_build.check(fn(ctypes.addressof(t), c1.data_ptr(),
                                c2.data_ptr(), lr.data_ptr(),
                                salt0.data_ptr(), ok.data_ptr(), sms, stream),
                             'adam_update')
        adam_step.launches += 1
        # The kernel wrote behind the tensors' version counters: bump them,
        # so that what is keyed by a version (cuda_cross's padded copies
        # of Z) sees the write, as after the plain version's copy_.
        for x in touched:
            torch.autograd.graph.increment_version(x)


adam_step.launches = 0
