"""Model FLOP utilization of serving while the device works, in percent:
the model FLOPs of the traced stretch's requests
(``yardstick.request_flops``, the forward at the request's rows and
samples) over the seconds in which an operation ran on the device in that
stretch, over the compute peak.  The stretch's idle share is
``device_idle_pct.serve``'s."""

from portbench import yardstick


def read(r):
    if r.kind != 'serve' or not r.busy_s:
        return None
    flops = yardstick.request_flops(r.config, r.traffic['rows'],
                                    r.traffic['samples'])
    return 100.0 * flops * r.units / r.busy_s / yardstick.COMPUTE_PEAK_FLOPS
