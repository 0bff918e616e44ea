"""Device milliseconds a NatGrad training step in the optimizer's source
bucket (``training/optim.py`` outside the natural-gradient step, which
the 'natgrad' bucket takes first, and the trainer's update: Adam on Z and
the kernel, and the guarded commit of every leaf), over the traced
stretch's replayed steps."""


def read(r):
    if (r.kind != 'train_natgrad' or not r.sources
            or 'optimizer' not in r.sources):
        return None
    return r.sources['optimizer'] / 1e3 / r.units
