"""The cross-covariance's share of its roofline, in percent: the least
time of a training step's cross-covariance work, forward and backward
(``yardstick.cross_covariance_least_s``, from the configuration's
shapes), over the device time a step spends in the cross-covariance's
source bucket (the kernels, patches and distances modules)."""

from portbench import yardstick


def read(r):
    if r.kind != 'train' or not r.sources or not r.sources.get('conv-Kuf'):
        return None
    least_s, _ = yardstick.cross_covariance_least_s(
        r.config, r.traffic['batch'], r.traffic['samples'])
    measured_s = r.sources['conv-Kuf'] / 1e6 / r.units
    return 100.0 * least_s / measured_s
