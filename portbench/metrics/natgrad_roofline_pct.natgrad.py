"""The natural-gradient update's share of its roofline, in percent: the
least time of one update of every GP's (q_mu, q_sqrt)
(``yardstick_natgrad.natgrad_least_s``, from the configuration's shapes:
W^T dW, K2's factor, the W R^-T solve and the mean update) over the device
time a step spends in the 'natgrad' source bucket."""

from portbench import yardstick_natgrad


def read(r):
    if (r.kind != 'train_natgrad' or not r.sources
            or not r.sources.get('natgrad')):
        return None
    s = yardstick_natgrad.shapes(r.config)
    least_s, _ = yardstick_natgrad.natgrad_least_s(s['R'], s['M'])
    measured_s = r.sources['natgrad'] / 1e6 / r.units
    return 100.0 * least_s / measured_s
