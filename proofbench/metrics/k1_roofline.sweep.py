"""k1_roofline.sweep: the least time of the traced requests' K1 work (the
frozen bound, reference/bounds.py) over the device time of the kernels of
group k1 (metrics/kernels/k1/), in %.

The sweep's copy of k1_roofline, which moves proofs_per_s: the sweep cell
reports no request_ms_p95."""

UNIT = "%"


def read(t):
    return t.roofline("k1")
