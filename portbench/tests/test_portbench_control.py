"""The control at a size a test run can hold: the reference computed in
TF32 (every product's operands rounded to a 10-bit mantissa), put in the
program's place, comes out not correct against the cell's limits, and
the program on the same inputs comes out correct.  On the card the same
readings are taken at the cells' own sizes by ``portbench/calibrate.py``."""

from portbench import calibrate


def fails(readings: dict, limits: dict) -> list:
    return [k for k, limit in limits.items() if not readings[k] <= limit]


def test_the_training_control_fails_and_the_program_passes(tiny_spec):
    spec = tiny_spec('train')
    out = calibrate.training(spec, 11, 'cpu', lambda msg: None)
    assert fails(out['program'], spec['limits']) == []
    assert 'grad_err_median' in fails(out['control'], spec['limits'])
    assert set(fails(out['half_batch'], spec['limits'])) >= {
        'loss_rel', 'grad_gap', 'change_gap'}


def test_the_serving_control_fails_and_the_program_passes(tiny_spec):
    spec = tiny_spec('serve')
    out = calibrate.serving(spec, 11, 0.3, 'cpu', lambda msg: None)
    assert fails(out['program'], spec['limits']) == []
    assert fails(out['control'], spec['limits']) == ['prob_gap']
