"""Model FLOP utilization of training while the device works, in percent:
the model FLOPs of the traced stretch's steps
(``yardstick.training_step_flops`` a step) over the seconds in which an
operation ran on the device in that stretch, over the compute peak.  The
stretch's idle share is ``device_idle_pct.train``'s."""

from portbench import yardstick


def read(r):
    if r.kind != 'train' or not r.busy_s:
        return None
    flops = yardstick.training_step_flops(r.config, r.traffic['batch'],
                                          r.traffic['samples'])
    return 100.0 * flops * r.units / r.busy_s / yardstick.COMPUTE_PEAK_FLOPS
