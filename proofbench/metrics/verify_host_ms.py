"""verify_host_ms: host ms of the pooled main path
(ops.mpt.verify_proofs_pooled) from its entry to its return, every launch
queued (the pool hash and the walk), a request: the program's span
`zkp.verify` over the traced stretch."""

from proofbench.metrics._spans import per_request_ms

UNIT = "ms"


def read(t):
    return per_request_ms(t, "zkp.verify")
