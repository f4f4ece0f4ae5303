"""L0 bit-exact pure-Python oracle: keccak-256, RLP, hexary MPT.

Small, slow, trusted: witnesses are built and checked with it. The port's
own copy of `zk_state_proofs_tpu.oracle` (the tests hold the two equal).
"""

from .keccak import keccak256, keccak_f1600
from . import rlp
from .trie import (
    EMPTY_ROOT,
    EthTrie,
    MissingKeyError,
    TrieError,
    bytes_to_nibbles,
    hp_decode,
    hp_encode,
    verify_merkle_proof,
    walk_proof,
)

__all__ = [
    "keccak256",
    "keccak_f1600",
    "rlp",
    "EMPTY_ROOT",
    "EthTrie",
    "MissingKeyError",
    "TrieError",
    "bytes_to_nibbles",
    "hp_decode",
    "hp_encode",
    "verify_merkle_proof",
    "walk_proof",
]
