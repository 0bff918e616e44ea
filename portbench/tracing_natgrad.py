"""Device time of a NatGrad training step by the program's source
function: the frozen ``tracing.SOURCE_BUCKETS`` with one bucket placed
before them, 'natgrad', for everything the natural-gradient step runs
(``training/optim.py``'s ``natgrad_step_with_backoff`` and what it calls,
K2 and K3 of its solve too)."""

from __future__ import annotations

import collections
import re

from portbench import tracing

SOURCE_BUCKETS = [('natgrad', r'optim\.py:natgrad')] + tracing.SOURCE_BUCKETS


def source_bucket_of(source: str) -> str:
    for bucket, pat in SOURCE_BUCKETS:
        if re.search(pat, source):
            return bucket
    return 'other'


def source_us(ref: tracing.Trace, chunk: tracing.Trace, steps: int) -> dict:
    """``tracing.source_us`` with these buckets: device microseconds over
    the ``steps`` replayed steps of the chunk's traced stretch by source
    bucket, each replayed step joined to the eager step of ``ref``; what
    the stretch launched outside them (the chunk's final check among it)
    is ``tracing.OUTSIDE``."""
    eager, span = tracing.eager_step(ref)
    window = tracing.window_span(chunk)
    replays = tracing.replayed_steps(chunk, within=window)
    if len(replays) != steps:
        raise tracing.JoinError(f'{len(replays)} replayed steps in a chunk '
                                f'of {steps}')
    for replay in replays:
        tracing.join(eager, replay)
    buckets = [source_bucket_of(s)
               for s in tracing.attribute(ref, eager, span)]
    out = collections.Counter()
    for replay in replays:
        for e, b in zip(replay, buckets):
            out[b] += e['dur']
    inside = sum(out.values())
    out[tracing.OUTSIDE] += sum(
        e['dur'] for e in chunk.events if e['host_ts'] is not None
        and window[0] <= e['host_ts'] <= window[1]) - inside
    return dict(out)
