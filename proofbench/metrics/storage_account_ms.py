"""storage_account_ms: host ms of the storage entry's account level (the
account proof's pooled verify and the decode of its value), what the
second level costs before a slot is walked, a request: the program's span
`zkp.storage.account` over the traced stretch."""

from proofbench.metrics._spans import per_request_ms

UNIT = "ms"


def read(t):
    return per_request_ms(t, "zkp.storage.account")
