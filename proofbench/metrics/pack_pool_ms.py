"""pack_pool_ms: host ms of the packer's pool (PackedProofs.pool: the
dedup and the pack-time hints) inside BatchVerifier.pack, a request: the
program's span `zkp.pack.pool` over the traced stretch."""

from proofbench.metrics._spans import per_request_ms

UNIT = "ms"


def read(t):
    return per_request_ms(t, "zkp.pack.pool")
