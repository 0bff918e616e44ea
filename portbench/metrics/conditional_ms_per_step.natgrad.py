"""Device milliseconds a NatGrad training step in the conditional's source
bucket (``ops/conditional.py``: the SVGP's solves against Kuu and the
q_sqrt term), over the traced stretch's replayed steps."""


def read(r):
    if (r.kind != 'train_natgrad' or not r.sources
            or 'qsqrt-term' not in r.sources):
        return None
    return r.sources['qsqrt-term'] / 1e3 / r.units
