"""Device milliseconds a NatGrad training step in the 'natgrad' source
bucket (``portbench/tracing_natgrad.py``: ``training/optim.py``'s
natural-gradient step and what it calls, K2 and K3 of its solve too),
over the traced stretch's replayed steps."""


def read(r):
    if r.kind != 'train_natgrad' or not r.sources or 'natgrad' not in r.sources:
        return None
    return r.sources['natgrad'] / 1e3 / r.units
