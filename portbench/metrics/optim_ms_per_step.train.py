"""Device milliseconds a training step in the optimizer's source bucket
(``training/optim.py`` and the trainer's update), over the traced
stretch's replayed steps."""


def read(r):
    if r.kind != 'train' or not r.sources or 'optimizer' not in r.sources:
        return None
    return r.sources['optimizer'] / 1e3 / r.units
