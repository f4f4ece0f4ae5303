"""k2_roofline: the least time of the traced requests' K2 work (the frozen
bound, reference/bounds.py) over the device time of the kernels of group
k2 (metrics/kernels/k2/), in %."""

UNIT = "%"


def read(t):
    return t.roofline("k2")
