"""copy_in_ms: host ms of a service batch's host-to-device copies
(witness_bridge.packed_to_tensors in BatchVerifier), a request: the
program's span `zkp.copy_in` over the traced stretch."""

from proofbench.metrics._spans import per_request_ms

UNIT = "ms"


def read(t):
    return per_request_ms(t, "zkp.copy_in")
