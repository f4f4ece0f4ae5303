"""Pure-Python hexary Merkle-Patricia-Trie oracle — bit-exact reference.

The port's own copy of `zk_state_proofs_tpu.oracle.trie`.

Re-creates the capabilities the reference framework gets from the external
`eth_trie` crate (reference: used at crypto-ops/src/lib.rs:8-23 and
trie-utils/src/proofs/transaction.rs:41-68): insert, root_hash, get_proof,
verify_proof, plus the top-level `verify_merkle_proof` semantics
(hash each proof node into a DB, reconstruct from the trusted root, walk the
key's nibble path, return the leaf value).

Node model (canonical Ethereum MPT):
  - Leaf:      RLP[ hp_encode(nibbles, leaf=True),  value ]
  - Extension: RLP[ hp_encode(nibbles, leaf=False), child_ref ]
  - Branch:    RLP[ c0 .. c15, value ]          (17 items)
  child_ref = keccak(rlp(node)) if len(rlp(node)) >= 32 else rlp-decoded
  inline node (the structure itself is embedded in the parent).
  The ROOT node is always referenced by hash: root = keccak(rlp(root_node)).
"""

from __future__ import annotations

from typing import Optional

from .keccak import keccak256
from . import rlp

EMPTY_ROOT = bytes.fromhex(
    "56e81f171bcc55a6ff8345e692c0f86e5b48e01b996cadc001622fb5e363b421"
)  # keccak256(rlp(b'')) == keccak256(0x80)


class TrieError(ValueError):
    """Invalid proof / malformed trie structure."""


class MissingKeyError(TrieError):
    """Key does not exist (exclusion) — distinct from an invalid proof,
    mirroring the reference's separate panic paths
    (crypto-ops/src/lib.rs:14 'Invalid merkle proof' vs :22 'Key does not
    exist!')."""


def bytes_to_nibbles(key: bytes) -> list[int]:
    out = []
    for b in key:
        out.append(b >> 4)
        out.append(b & 0x0F)
    return out


def hp_encode(nibbles: list[int], is_leaf: bool) -> bytes:
    """Hex-prefix encoding: flag nibble (2 = leaf) + odd-length marker."""
    flag = 2 if is_leaf else 0
    if len(nibbles) % 2 == 1:
        prefixed = [flag + 1] + nibbles
    else:
        prefixed = [flag, 0] + nibbles
    return bytes(
        (prefixed[i] << 4) | prefixed[i + 1] for i in range(0, len(prefixed), 2)
    )


def hp_decode(data: bytes) -> tuple[list[int], bool]:
    """Inverse of hp_encode -> (nibbles, is_leaf)."""
    if not data:
        raise TrieError("empty hex-prefix path")
    flag = data[0] >> 4
    is_leaf = flag >= 2
    nibbles = bytes_to_nibbles(data)
    if flag % 2 == 1:  # odd: first data nibble is low nibble of byte 0
        return nibbles[1:], is_leaf
    if nibbles[1] != 0:
        raise TrieError("non-zero padding nibble in hex-prefix path")
    return nibbles[2:], is_leaf


# ---------------------------------------------------------------------------
# In-memory trie (build + prove)
# ---------------------------------------------------------------------------

_LEAF, _EXT, _BRANCH = 0, 1, 2


class _Node:
    __slots__ = ("kind", "path", "value", "children", "child")

    def __init__(self, kind, path=None, value=None, children=None, child=None):
        self.kind = kind
        self.path = path or []       # leaf/ext nibble path
        self.value = value           # leaf value or branch value
        self.children = children     # branch: list of 16 (node | None)
        self.child = child           # ext: node


class EthTrie:
    """In-memory MPT supporting insert / get / root_hash / get_proof.

    API shape mirrors the `eth_trie` crate used by the reference
    (crypto-ops/src/lib.rs:14, trie-utils/src/proofs/transaction.rs:41-68).
    """

    def __init__(self, hasher=None) -> None:
        self._root: Optional[_Node] = None
        self.db: dict[bytes, bytes] = {}
        # per-node encoding memo, invalidated on every insert (nodes are
        # only mutated by inserts) — makes repeated get_proof calls O(path)
        self._enc_cache: dict[int, bytes] = {}
        # node-hash function: the pure-Python keccak by default (trusted
        # reference); large witness generators pass native.keccak256 —
        # digests are identical (tests/test_native.py parity), only speed
        # differs (~1000x at 65k-account scale)
        self._hash = hasher if hasher is not None else keccak256

    # -- mutation ----------------------------------------------------------
    def insert(self, key: bytes, value: bytes) -> None:
        if not value:
            raise ValueError("empty values are deletions; not supported")
        self._enc_cache.clear()
        self._root = self._insert(self._root, bytes_to_nibbles(key), value)

    def _insert(self, node: Optional[_Node], nibs: list[int], value: bytes) -> _Node:
        if node is None:
            return _Node(_LEAF, path=nibs, value=value)
        if node.kind == _BRANCH:
            if not nibs:
                node.value = value
                return node
            idx = nibs[0]
            node.children[idx] = self._insert(node.children[idx], nibs[1:], value)
            return node
        # leaf or extension: split on common prefix
        common = 0
        while (
            common < len(node.path)
            and common < len(nibs)
            and node.path[common] == nibs[common]
        ):
            common += 1
        if node.kind == _LEAF:
            if common == len(node.path) == len(nibs):
                node.value = value
                return node
            branch = _Node(_BRANCH, children=[None] * 16)
            self._attach(branch, node.path[common:], node.value, None)
            self._attach(branch, nibs[common:], value, None)
            return self._wrap_ext(nibs[:common], branch)
        # extension
        if common == len(node.path):
            node.child = self._insert(node.child, nibs[common:], value)
            return node
        branch = _Node(_BRANCH, children=[None] * 16)
        # remainder of the extension path
        ext_rest = node.path[common:]
        sub = node.child if len(ext_rest) == 1 else _Node(
            _EXT, path=ext_rest[1:], child=node.child
        )
        branch.children[ext_rest[0]] = sub
        self._attach(branch, nibs[common:], value, None)
        return self._wrap_ext(nibs[:common], branch)

    def _attach(self, branch: _Node, nibs: list[int], value, _) -> None:
        if not nibs:
            branch.value = value
        else:
            branch.children[nibs[0]] = self._insert(
                branch.children[nibs[0]], nibs[1:], value
            )

    @staticmethod
    def _wrap_ext(prefix: list[int], node: _Node) -> _Node:
        return _Node(_EXT, path=prefix, child=node) if prefix else node

    # -- lookup ------------------------------------------------------------
    def get(self, key: bytes) -> Optional[bytes]:
        node, nibs = self._root, bytes_to_nibbles(key)
        while node is not None:
            if node.kind == _LEAF:
                return node.value if nibs == node.path else None
            if node.kind == _EXT:
                if nibs[: len(node.path)] != node.path:
                    return None
                nibs = nibs[len(node.path) :]
                node = node.child
                continue
            if not nibs:
                return node.value
            node, nibs = node.children[nibs[0]], nibs[1:]
        return None

    # -- hashing -----------------------------------------------------------
    def _encode_node(self, node: _Node) -> bytes:
        cached = self._enc_cache.get(id(node))
        if cached is not None:
            return cached
        if node.kind == _LEAF:
            enc = rlp.encode([hp_encode(node.path, True), node.value])
        elif node.kind == _EXT:
            enc = rlp.encode([hp_encode(node.path, False), self._ref(node.child)])
        else:
            items = [
                self._ref(child) if child is not None else b""
                for child in node.children
            ]
            items.append(node.value if node.value is not None else b"")
            enc = rlp.encode(items)
        self._enc_cache[id(node)] = enc
        return enc

    def _ref(self, node: _Node):
        """Child reference: hash for nodes >= 32 bytes, inline structure else."""
        encoded = self._encode_node(node)
        if len(encoded) < 32:
            return rlp.decode(encoded)  # embed the decoded structure in parent
        h = self._hash(encoded)
        self.db[h] = encoded
        return h

    def root_hash(self) -> bytes:
        if self._root is None:
            return EMPTY_ROOT
        encoded = self._encode_node(self._root)
        h = self._hash(encoded)
        self.db[h] = encoded
        return h

    # -- proofs ------------------------------------------------------------
    def get_proof(self, key: bytes) -> list[bytes]:
        """Proof = encodings of every hash-referenced node on the key's path
        (root node always included; inline nodes travel inside parents)."""
        self.root_hash()  # ensure db is populated
        proof: list[bytes] = []
        node, nibs = self._root, bytes_to_nibbles(key)
        if node is None:
            return proof
        first = True
        while node is not None:
            encoded = self._encode_node(node)
            if first or len(encoded) >= 32:
                proof.append(encoded)
            first = False
            if node.kind == _LEAF:
                return proof
            if node.kind == _EXT:
                if nibs[: len(node.path)] != node.path:
                    return proof
                nibs = nibs[len(node.path) :]
                node = node.child
                continue
            if not nibs:
                return proof
            node, nibs = node.children[nibs[0]], nibs[1:]
        return proof


# ---------------------------------------------------------------------------
# Stateless verification (walking RLP-encoded proof nodes)
# ---------------------------------------------------------------------------

def walk_proof(
    root_hash: bytes, key: bytes, proof_db: dict[bytes, bytes]
) -> Optional[bytes]:
    """Walk the nibble path of `key` from `root_hash` through `proof_db`
    (node-encoding keyed by keccak). Returns the value, or None when the
    key provably does not exist. Raises TrieError when a referenced node is
    missing or malformed (invalid proof)."""
    nibs = bytes_to_nibbles(key)
    if root_hash == EMPTY_ROOT and not proof_db:
        return None
    enc = proof_db.get(root_hash)
    if enc is None:
        raise TrieError("invalid proof: root node missing")
    node = rlp.decode(enc)
    while True:
        if not isinstance(node, list):
            raise TrieError("invalid proof: node is not a list")
        if len(node) == 17:
            if not nibs:
                value = node[16]
                return value if value else None
            child = node[nibs[0]]
            nibs = nibs[1:]
            if child == b"":
                return None  # exclusion
            node = _deref(child, proof_db)
            continue
        if len(node) == 2:
            path, is_leaf = hp_decode(node[0])
            if is_leaf:
                return node[1] if nibs == path else None
            if nibs[: len(path)] != path:
                return None  # exclusion (path diverges)
            nibs = nibs[len(path) :]
            node = _deref(node[1], proof_db)
            continue
        raise TrieError(f"invalid proof: node with {len(node)} items")


def _deref(ref, proof_db: dict[bytes, bytes]):
    if isinstance(ref, list):
        return ref  # inline embedded node
    if len(ref) == 32:
        enc = proof_db.get(bytes(ref))
        if enc is None:
            raise TrieError("invalid proof: referenced node missing")
        return rlp.decode(enc)
    raise TrieError("invalid proof: malformed child reference")


def verify_merkle_proof(root_hash: bytes, proof: list[bytes], key: bytes) -> bytes:
    """Semantics of the reference's core primitive
    (crypto-ops/src/lib.rs:8-23): hash every proof node into a DB keyed by
    keccak, walk `key` from the trusted `root_hash`, return the value.
    Raises TrieError for an invalid proof and MissingKeyError when the key
    does not exist (the reference's two distinct panic messages)."""
    proof_db = {keccak256(node): bytes(node) for node in proof}
    value = walk_proof(bytes(root_hash), bytes(key), proof_db)
    if value is None:
        raise MissingKeyError("Key does not exist!")
    return value
