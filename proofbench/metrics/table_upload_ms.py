"""table_upload_ms: host ms of the sweep's witness upload (the pool and
the per-proof arrays copied to the card, inside the table build), a call:
the program's span `zkp.sweep.upload` over the traced stretch."""

from proofbench.metrics._spans import per_request_ms

UNIT = "ms"


def read(t):
    return per_request_ms(t, "zkp.sweep.upload")
