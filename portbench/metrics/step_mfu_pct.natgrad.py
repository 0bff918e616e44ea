"""Model FLOP utilization of NatGrad training while the device works, in
percent: the model FLOPs of the traced stretch's steps
(``yardstick_natgrad.training_step_flops`` a step: the SVGP's forward and
backward and the natural-gradient update) over the seconds in which an
operation ran on the device in that stretch, over the compute peak.  The
stretch's idle share is ``device_idle_pct.natgrad``'s."""

from portbench import yardstick, yardstick_natgrad


def read(r):
    if r.kind != 'train_natgrad' or not r.busy_s:
        return None
    flops = yardstick_natgrad.training_step_flops(r.config,
                                                  r.traffic['batch'])
    return 100.0 * flops * r.units / r.busy_s / yardstick.COMPUTE_PEAK_FLOPS
