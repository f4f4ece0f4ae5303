"""k4_roofline: the least time of the traced requests' K4 work (the frozen
bound, reference/bounds.py) over the device time of the kernels of group
k4 (metrics/kernels/k4/), in %."""

UNIT = "%"


def read(t):
    return t.roofline("k4")
