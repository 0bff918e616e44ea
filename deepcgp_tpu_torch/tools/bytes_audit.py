"""Per-op bytes roofline of a graphed training step (counterpart of the JAX
repository's ``tools/bytes_audit.py``).

The JAX tool reads each fused op's operand and output buffers from the
optimized HLO.  The port has no HLO: every kernel of a replayed step
carries the bytes of the operation that launched it in the eager step
``roofline.py`` joins the replays to, position by position:

* an aten operator: its inputs' bytes from the trace's ``record_shapes``
  (Input Dims times the size of each Input type; a tensor list, whose
  element types the trace leaves out, takes the dispatch log's count of
  the operator's inputs) plus its outputs' bytes from the dispatch log
  that ``roofline.OpBytes`` keeps in dispatch order: a
  ``TorchDispatchMode`` that runs each operator inside a trace region
  ``aten#<index>``, so a kernel's launching operator finds its entry
  exactly;
* a hand kernel: the tensors its wrapper passes to
  ``utils.profiling.launch``, in launch order, which for K1, K2, K3, K6
  and K7 equal PERF.md's byte formulas (:func:`formula_bytes`).

An operator that launches several kernels carries its bytes on the
first.  Kernels outside the steps (NatGrad's final check, the trace's
copy) carry none.  The convention and its caveat are the JAX tool's:
bytes(op) = operand + output bytes, an UPPER bound on the op's memory
traffic -- an operand another kernel left in L2 is still counted, so an
op reading well above the card's memory rate is cache-resident, not
magic.  Per bucket: us, MB and achieved GB/s a step; the program's MB a
step against the analytic model-minimal traffic
(``utils.flops.training_step_min_bytes``).

    python -m deepcgp_tpu_torch.tools.bytes_audit --config flagship
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import math

from deepcgp_tpu_torch.tools import roofline

# Bytes of an element, by the type names record_shapes writes.
TYPE_BYTES = {'float': 4, 'double': 8, 'c10::Half': 2, 'c10::BFloat16': 2,
              'long int': 8, 'long': 8, 'int': 4, 'short int': 2, 'short': 2,
              'signed char': 1, 'unsigned char': 1, 'bool': 1,
              'c10::complex<float>': 8, 'c10::complex<double>': 16}
# The size of K1's and K2's diagonal blocks, whose inverses they write.
BLOCK = 32


def shape_bytes(dims, types):
    """(bytes of the tensors among an operator's recorded inputs, whether
    one of them is a tensor list, whose element type is not recorded)."""
    total, listed = 0, False
    for d, t in zip(dims, types):
        if t in TYPE_BYTES and isinstance(d, list):
            total += math.prod(d) * TYPE_BYTES[t]
        elif isinstance(d, list) and d and isinstance(d[0], list):
            listed = True
    return total, listed


def formula_bytes(name: str, shapes: list):
    """PERF.md's bytes of one launch of a hand kernel, from the shapes of
    the tensors its wrapper passes (reads, then writes); None for K4 and
    K5, whose bytes are their wrappers' padded tensors as passed.

    K1 reads A and writes L and its diagonal blocks' inverses, K3 reads L
    (and those inverses) and writes L^-1: 4 B (2 M^2 + 32 M) each, 8 B M^2
    for K3 without the inverses; K2 reads G's lower triangle and writes
    its factor and inverses: 4 B (M(M+1)/2 + M^2 + 32 M); K6 and K7 read
    one of the image [N, H, W, C] and the patches [N, P, L] and write the
    other: 4 N (H W C + P L)."""
    if name in ('chol_factor_blocked', 'tri_inv_blocked'):
        B, M, _ = shapes[0]
        return 4 * B * (2 * M * M + (BLOCK * M if len(shapes) == 3 else 0))
    if name == 'chol_upper_blocked':
        B, M, _ = shapes[0]
        return 4 * B * (M * (M + 1) // 2 + M * M + BLOCK * M)
    if name in ('extract_patches_transposed', 'col2im_transposed'):
        image, patches = shapes if len(shapes[0]) == 4 else shapes[::-1]
        N, H, W, C = image
        _, P, L = patches
        return 4 * N * (H * W * C + P * L)
    return None


def step_bytes(ref: roofline.Trace, eager: list, span, ops: list,
               launches: list):
    """Bytes at each position of the eager step's device events (host
    ``span``), the hand kernels' launches [(name, bytes, formula bytes,
    shapes)], and the counts of operators whose inputs came from the
    dispatch log and of events no operator owns."""
    records = {c: iter([r for r in launches if r[0] == c])
               for c in roofline.LAUNCHES}
    out, hand, seen = [], [], set()
    fallback = unmatched = 0
    for e, op in zip(eager, roofline.launching_ops(ref, eager, span)):
        if op is None:
            unmatched += 1
            out.append(0)
        elif op['name'] in roofline.LAUNCHES and op.get('cat') == \
                'user_annotation':
            name, reads, writes, shapes = next(records[op['name']])
            hand.append((name, reads + writes, formula_bytes(name, shapes),
                         shapes))
            out.append(reads + writes)
        elif id(op) in seen or op['region'] is None:
            unmatched += op['region'] is None
            out.append(0)
        else:
            seen.add(id(op))
            _, written, read = ops[op['region']]
            inputs, listed = shape_bytes(op['args'].get('Input Dims', []),
                                         op['args'].get('Input type', []))
            if listed:
                inputs, fallback = read, fallback + 1
            out.append(inputs + written)
    return out, hand, fallback, unmatched


@dataclasses.dataclass
class Audit:
    roofline: roofline.Roofline
    rows: list               # [(name, source, bucket, us a step, bytes)]
    hand: list
    min_bytes: float
    fallback: int
    unmatched: int

    @property
    def us_step(self) -> float:
        return self.roofline.total_us / self.roofline.steps

    @property
    def mb_step(self) -> float:
        return sum(r[4] for r in self.rows) / 1e6


def audit(result: roofline.Roofline, ref: roofline.Trace, meta: dict) -> Audit:
    eager, span = roofline.eager_step(ref, meta['cpu'])
    nbytes, hand, fallback, unmatched = step_bytes(
        ref, eager, span, meta['ops'], meta['hand_launches'])
    steps = result.steps
    rows = [(name, source, roofline.bucket_of(name), us / steps, b)
            for (name, source, _, _), us, b in zip(
                result.reference, result.position_us, nbytes)]
    return Audit(result, rows, hand, meta.get('min_bytes', float('nan')),
                 fallback, unmatched)


def report(a: Audit, top: int = 30) -> None:
    """The JAX tool's tables, per step."""
    r = a.roofline
    us_total, mb_total = a.us_step, a.mb_step
    print(f"== {r.config} bytes roofline: {us_total:.1f} us/step device, "
          f"{mb_total:.1f} MB/step (the eager step's operators; "
          f"{a.fallback} inputs from the dispatch log, {a.unmatched} events "
          f"unowned), program bandwidth {mb_total / us_total:.2f} TB/s ==")
    if a.min_bytes == a.min_bytes:
        print(f"model-minimal traffic: {a.min_bytes / 1e6:.1f} MB/step -> "
              f"program moves {mb_total * 1e6 / a.min_bytes:.1f}x the floor "
              f"(see utils/flops.training_step_min_bytes convention)")
    buckets_t = collections.Counter()
    buckets_b = collections.Counter()
    for _, _, bk, us, b in a.rows:
        buckets_t[bk] += us
        buckets_b[bk] += b / 1e6
    outside = us_total - sum(buckets_t.values())
    buckets_t[roofline.OUTSIDE] += outside
    print("-- buckets (per step) --")
    print(f"{'bucket':24s} {'us':>9s} {'MB':>9s} {'GB/s':>8s}")
    for bk, us in buckets_t.most_common():
        mb = buckets_b[bk]
        bw = mb / us * 1e3 if us else float('nan')
        print(f"{bk:24s} {us:9.1f} {mb:9.2f} {bw:8.0f}")
    print("-- hand kernels (per launch: the wrapper's tensors; PERF.md's "
          "formula) --")
    for name, b, formula, shapes in a.hand:
        print(f"{name:28s} {b / 1e6:9.3f} MB  formula "
              f"{'-' if formula is None else f'{formula / 1e6:.3f} MB'}  "
              f"{shapes}")
    rows = [(name, source.split(' > ')[-1], us, b / 1e6,
             b / us / 1e3 if us else float('nan'))
            for name, source, _, us, b in a.rows]
    print(f"-- top {top} ops by MB/step --")
    for name, source, us, mb, gbps in sorted(rows, key=lambda x: -x[3])[:top]:
        print(f"{mb:8.2f} MB {us:8.1f} us {gbps:8.0f} GB/s  {name[:60]}  "
              f"| {source[:90]}")
    print(f"-- top {top} ops by us/step (with their bytes) --")
    for name, source, us, mb, gbps in sorted(rows, key=lambda x: -x[2])[:top]:
        print(f"{us:8.1f} us {mb:8.2f} MB {gbps:8.0f} GB/s  {name[:60]}  "
              f"| {source[:90]}")


def main(argv=None, device=None) -> Audit:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--config', default='flagship',
                    choices=list(roofline.CONFIGS))
    ap.add_argument('--steps', type=int, default=200)
    ap.add_argument('--trace-dir', default=None,
                    help='where the traces go (default: '
                         '$TMPDIR/deepcgp_torch_roofline/<config>)')
    ap.add_argument('--top', type=int, default=30)
    ap.add_argument('--parse-only', action='store_true',
                    help="re-parse the traces saved under --trace-dir "
                         "without touching the card")
    args = ap.parse_args(argv)
    trace_dir = args.trace_dir or roofline.default_trace_dir(args.config)
    if args.parse_only:
        result, ref, meta = roofline.load(trace_dir)
    else:
        result, ref, _, _ = roofline.measure(args.config, args.steps, device,
                                             trace_dir)
        meta = roofline.read_meta(trace_dir)
    out = audit(result, ref, meta)
    report(out, args.top)
    return out


if __name__ == '__main__':
    main()
