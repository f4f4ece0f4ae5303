"""storage_host_ms: host ms of the two-level storage entry
(models.verifier.verify_storage_pooled) from its entry to its return, every
launch of both levels queued, a request: the program's span `zkp.storage`
over the traced stretch."""

from proofbench.metrics._spans import per_request_ms

UNIT = "ms"


def read(t):
    return per_request_ms(t, "zkp.storage")
