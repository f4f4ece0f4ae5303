"""k1_roofline: the least time of the traced requests' K1 work (the frozen
bound, reference/bounds.py) over the device time of the kernels of group
k1 (metrics/kernels/k1/), in %."""

UNIT = "%"


def read(t):
    return t.roofline("k1")
