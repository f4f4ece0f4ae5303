"""pack_proofs_ms: host ms of the packer's encoding (witness.pack_proofs,
RLP nodes to padded arrays) inside BatchVerifier.pack, a request: the
program's span `zkp.pack.proofs` over the traced stretch."""

from proofbench.metrics._spans import per_request_ms

UNIT = "ms"


def read(t):
    return per_request_ms(t, "zkp.pack.proofs")
