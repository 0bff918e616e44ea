#!/usr/bin/env python3
"""Which op makes a training path differ run to run: from one snapshot,
two eager chunks of the same steps, every op's output logged in order.

    python tools/torch_determinism_probe.py [--paths acos-natgrad,...]
        [--steps 6] [--device cuda|cpu]

Each path is built from a seed, trained two eager steps, snapshot (every
tensor of the state and its generator), then run twice from that
snapshot for ``--steps`` eager steps.  During each run a
``TorchDispatchMode`` logs every aten op in dispatch order with an
order-sensitive digest of its outputs and of its inputs (the int32 words
of each tensor, summed plain and weighted by position in int64, which
wraps the same in any order), and each hand-kernel wrapper of the port
logs the digest of what it returns.  Outputs of the allocating ops
(``empty*``), whose contents are whatever memory held, and of views,
which may still show unwritten memory of their base, are not logged.
The first entry whose output digest differs between the runs is the
source: an aten op whose inputs were equal, or a hand kernel.  A third
run under ``torch.use_deterministic_algorithms(True, warn_only=True)``
names the library ops PyTorch knows to be nondeterministic on the device
(a cross-check; cuBLAS's workspace warning is listed apart).

Paths: ``acos-natgrad`` and ``acos-adam`` (the flagship's geometry with
an ArcCosine hidden layer and the identity mean, chip_smoke.py's ``cli
cifar acos identity``), ``partial-adam`` (chip_smoke.py's partial-view
model), and ``flagship-adam`` (bit-equal, a control).  Prints one JSON
line a path; writes the whole logs' first differences to
``chiprun_out/determinism_probe.jsonl``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import types
import warnings

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402

ACOS = dict(cs.FLAGSHIP, base_kernel='acos', identity_mean=True)
PATHS = {'acos-natgrad': ('acos', 'NatGrad'), 'acos-adam': ('acos', 'Adam'),
         'partial-adam': ('partial', 'Adam'),
         'flagship-adam': ('flagship', 'Adam')}
# Ops whose output is uninitialised memory.
ALLOCATING = ('empty', 'empty_like', 'empty_strided', 'new_empty',
              'new_empty_strided')


def digest(torch, t):
    """[2] int64 on t's device: the sum and the position-weighted sum of
    t's 32-bit words (bytes where its size is not a multiple of 4)."""
    t = t.detach()
    if t.numel() == 0:
        return torch.zeros(2, dtype=torch.int64, device=t.device)
    b = t.contiguous().reshape(-1).view(torch.uint8)
    v = (b.view(torch.int32) if b.numel() % 4 == 0 else b).to(torch.int64)
    w = torch.arange(1, v.numel() + 1, dtype=torch.int64, device=t.device)
    return torch.stack([v.sum(), (v * (w * 2654435761 + 97)).sum()])


def tensors_in(x):
    import torch
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for y in x for t in tensors_in(y)]
    return []


class Log:
    """The entries of one run: (name, shapes, output digest, input digest,
    on the main thread)."""

    def __init__(self, torch):
        self.torch = torch
        self.entries = []
        self.main = threading.get_ident()

    def add(self, name, outputs, inputs):
        torch = self.torch
        outs = [t for t in tensors_in(outputs) if t.is_floating_point()
                or t.dtype in (torch.int64, torch.int32, torch.bool)]
        ins = [t for t in tensors_in(inputs)
               if isinstance(t, torch.Tensor) and t.layout == torch.strided]
        od = [digest(torch, t) for t in outs if t.layout == torch.strided]
        idg = [digest(torch, t) for t in ins]
        self.entries.append((name, [tuple(t.shape) for t in outs],
                             torch.stack(od) if od else None,
                             torch.stack(idg) if idg else None,
                             threading.get_ident() == self.main))

    def host(self):
        """The entries with their digests on the host."""
        return [(n, s, None if o is None else o.cpu().numpy(),
                 None if i is None else i.cpu().numpy(), m)
                for n, s, o, i, m in self.entries]


def digest_mode(torch, log):
    from torch.utils._python_dispatch import TorchDispatchMode

    class Mode(TorchDispatchMode):
        def __torch_dispatch__(self, func, types_, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = func.overloadpacket.__name__
            # A view's contents at this point may still be unwritten
            # memory of its base (a block of a buffer filled later).
            if name not in ALLOCATING and not func.is_view:
                log.add(f'aten.{func.__name__}', out,
                        list(args) + list((kwargs or {}).values()))
            return out
    return Mode()


def hook_kernels(torch, log):
    """Replace every hand-kernel wrapper, wherever the port's modules
    hold it, by one that logs the digest of what it returns.  Returns the
    undo."""
    from torch.utils._python_dispatch import _disable_current_modes
    originals = cs.kernel_counters()
    swapped = []
    for name, fn in originals.items():
        def wrapper(*a, _fn=fn, _name=name, **k):
            out = _fn(*a, **k)
            with _disable_current_modes():
                log.add(f'kernel.{_name}', out, [])
            return out
        wrapper.launches = 0
        for mod in list(sys.modules.values()):
            if not getattr(mod, '__name__', '').startswith('deepcgp_tpu_torch'):
                continue
            for attr, val in list(vars(mod).items()):
                if val is fn:
                    setattr(mod, attr, wrapper)
                    swapped.append((mod, attr, fn))

    def undo():
        for mod, attr, fn in swapped:
            setattr(mod, attr, fn)
    return undo


def build(torch, kind, seed, dev):
    """(model, X [N, D], Y [N, 1]) on ``dev``, from ``seed``."""
    from deepcgp_tpu_torch.models import builder as mbuilder
    from deepcgp_tpu_torch.training import data
    if kind == 'partial':
        rng = np.random.RandomState(seed)
        X = rng.randn(cs.PV_IMAGES, *cs.PV_IMAGE).astype(np.float32)
        Y = rng.randint(0, 10, size=(cs.PV_IMAGES, 1))
        model = cs.partial_view_model(torch, X, seed, dev)
    else:
        X, Y = data.learnable_blobs(cs.TRAIN_IMAGES, cs.IMAGE, 10, 0)
        flags = ACOS if kind == 'acos' else cs.FLAGSHIP
        model = mbuilder.build_model(
            types.SimpleNamespace(**flags, num_samples=cs.TRAIN_SAMPLES),
            cs.IMAGE, images=X, generator=torch.Generator().manual_seed(seed),
            device=dev)
    Xd = torch.as_tensor(X.reshape(len(X), -1), device=dev)
    Yd = torch.as_tensor(Y, device=dev)
    return model, Xd, Yd


def first_difference(a, b):
    """The first index where two hosted logs differ, and how."""
    for i, (x, y) in enumerate(zip(a, b)):
        if x[0] != y[0] or x[1] != y[1]:
            return i, 'control flow'
        if (x[2] is None) != (y[2] is None) or (
                x[2] is not None and not np.array_equal(x[2], y[2])):
            inputs_equal = (x[3] is None and y[3] is None) or (
                x[3] is not None and y[3] is not None
                and np.array_equal(x[3], y[3]))
            return i, 'output' + (' (inputs equal)' if inputs_equal
                                  else ' (inputs differ)')
    if len(a) != len(b):
        return min(len(a), len(b)), 'length'
    return None, 'none'


def probe(torch, label, steps, seed, dev):
    from deepcgp_tpu_torch.training import trainer
    kind, optimizer = PATHS[label]
    model, Xd, Yd = build(torch, kind, seed, dev)
    config = trainer.TrainConfig(optimizer=optimizer,
                                 batch_size=cs.TRAIN_BATCH, lr=0.01,
                                 gamma=0.001)
    state = trainer.init_state(model, config, seed=seed)
    trainer.run_chunk(state, config, Xd, Yd, 2, graphed=False)
    snap = cs.state_values(state)
    logs, finals, traces = [], [], []
    for _ in range(2):
        cs.restore_values(torch, state, snap)
        log = Log(torch)
        undo = hook_kernels(torch, log)
        try:
            with digest_mode(torch, log):
                trace = trainer.run_chunk(state, config, Xd, Yd, steps,
                                          graphed=False)
        finally:
            undo()
        if dev.type == 'cuda':
            torch.cuda.synchronize()
        logs.append(log.host())
        finals.append(cs.state_values(state))
        traces.append(trace.cpu())
    state_diff = cs.bit_diff(torch, finals[0], finals[1])
    index, how = first_difference(*logs)
    # The cross-check: PyTorch's own list of nondeterministic device ops.
    cs.restore_values(torch, state, snap)
    warned = {}
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter('always')
            trainer.run_chunk(state, config, Xd, Yd, 1, graphed=False)
            if dev.type == 'cuda':
                torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    for w in caught:
        msg = str(w.message).split('\n')[0][:200]
        warned[msg] = warned.get(msg, 0) + 1
    a = logs[0]
    context = None
    if index is not None:
        context = [{'i': j, 'op': a[j][0], 'shapes': a[j][1],
                    'main_thread': a[j][4],
                    'out_equal': (a[j][2] is None and logs[1][j][2] is None)
                    or (a[j][2] is not None and logs[1][j][2] is not None
                        and np.array_equal(a[j][2], logs[1][j][2]))}
                   for j in range(max(0, index - 12),
                                  min(len(a), len(logs[1]), index + 4))]
    per_step = len(a) / steps
    line = {'path': label, 'steps': steps, 'device': str(dev),
            'entries': [len(x) for x in logs],
            'entries_off_main_thread': sum(1 for e in a if not e[4]),
            'kernel_entries': sum(1 for e in a if e[0].startswith('kernel.')),
            'entries_per_step': per_step,
            'trace_equal': bool(torch.equal(traces[0], traces[1])),
            'trace_abs_diff': (traces[0] - traces[1]).abs().tolist(),
            'state_leaves_differing': len(state_diff),
            'state_diff': state_diff,
            'first_difference': None if index is None else {
                'index': index, 'step': int(index // per_step), 'kind': how,
                'op': a[index][0], 'shapes': a[index][1]},
            'context': context,
            'nondeterministic_warnings': warned}
    print(json.dumps({k: line[k] for k in line if k != 'context'}), flush=True)
    return line


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--paths', default='acos-natgrad,acos-adam,partial-adam,'
                                       'flagship-adam')
    ap.add_argument('--steps', type=int, default=6)
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--device', default='cuda')
    args = ap.parse_args()
    import torch
    dev = torch.device(args.device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        print('no CUDA device', file=sys.stderr)
        return 2
    os.makedirs('chiprun_out', exist_ok=True)
    with open(os.path.join('chiprun_out', 'determinism_probe.jsonl'),
              'a') as f:
        for label in args.paths.split(','):
            f.write(json.dumps(probe(torch, label, args.steps, args.seed,
                                     dev)) + '\n')
    return 0


if __name__ == '__main__':
    sys.exit(main())
