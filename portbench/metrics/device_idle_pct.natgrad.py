"""Share of the traced stretch of NatGrad training steps in which no
operation ran on the device, in percent."""


def read(r):
    if r.kind != 'train_natgrad' or not r.window_s:
        return None
    return 100.0 * (1.0 - r.busy_s / r.window_s)
