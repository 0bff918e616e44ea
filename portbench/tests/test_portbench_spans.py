"""The program's spans in the benchmark's trace reading: an idle gap that
program spans surround is charged to the innermost of them, the spans
appear as regions of a profiled request, and the operators inside them
keep the program's own frames, so the source buckets do not move."""

import json

import numpy as np
import pytest
import torch

from portbench import tracing


def _event(cat, name, ts, dur, **args):
    return {'ph': 'X', 'cat': cat, 'name': name, 'ts': ts, 'dur': dur,
            'pid': 0 if cat == 'kernel' else 1, 'tid': 7 if cat == 'kernel'
            else 1, 'args': args}


def test_a_gap_inside_program_spans_is_charged_to_the_innermost(tmp_path):
    """A request span [10, 190] over 'serve key' [20, 60] and the replay
    [60, 100]; the card runs [0, 15] and [100, 150]: the gap [15, 100]
    (middle 57.5) is the key walk's, [150, 200] (middle 175) the
    request's own."""
    events = [
        _event('user_annotation', tracing.WINDOW, 0, 200),
        _event('user_annotation', 'predict_proba', 10, 180),
        _event('user_annotation', 'serve key', 20, 40),
        _event('user_annotation', 'graph replay predict_proba', 60, 40),
        _event('cuda_runtime', tracing.GRAPH_LAUNCH, 62, 30, correlation=1),
        _event('kernel', 'k0', 0, 15),
        _event('kernel', 'k1', 100, 50, correlation=1),
    ]
    path = tmp_path / 't.json'
    path.write_text(json.dumps({'traceEvents': events}))
    trace = tracing.parse_trace(str(path))
    gaps = dict(tracing.breakdown(trace)['idle_gaps'])
    assert gaps == {'serve key': pytest.approx(85e-6),
                    'predict_proba': pytest.approx(50e-6)}
    assert tracing.replay_counts(trace, 'graph replay predict_proba') == [1]


def test_a_profiled_request_holds_the_spans_and_the_programs_frames():
    import types

    from deepcgp_tpu_torch.models.builder import build_model
    from deepcgp_tpu_torch.serving import Predictor
    flags = types.SimpleNamespace(
        M='6,8', feature_maps='2', filter_sizes='5,3', strides='2,1',
        base_kernel='rbf', last_kernel='conv', white=False,
        identity_mean=False, num_samples=2)
    X = np.random.RandomState(0).randn(12, 12, 12, 1)
    model = build_model(flags, (12, 12, 1), images=X,
                        generator=torch.Generator().manual_seed(0),
                        device='cpu')
    pred = Predictor(model, batch_size=8, device='cpu')

    def stretch():
        with torch.profiler.record_function(tracing.WINDOW):
            pred.predict_proba(X)
    trace = tracing.profile(stretch, with_stack=True)
    assert {'predict_proba', 'serve prepare', 'serve h2d', 'serve batch',
            'serve wait', 'serve finish'} <= set(trace.regions)
    frames = [op['frames'] for op in trace.ops.values() if op['frames']]
    assert frames and not any('utils/profiling.py' in f for fs in frames
                              for f in fs)
    assert any(fs[-1] == 'serving.py:_batches' for fs in frames)
