"""ctypes bindings for the native host runtime (`native/zkp_host.cpp` and
the port's own `pool_pack.cpp`), and for the serving layer's entries walk
(`entry_walk.cpp`).

The port's own counterpart of `zk_state_proofs_tpu.native`. Both runtime
sources are compiled with g++ into one library at first use, on the
machine that runs it, into the gitignored `_kernels_build/` beside the
package (keyed on a hash of the sources and flags). The build is portable
(no `-march=native`), so a library built on one host runs on another.
Without g++ or the sources every caller takes its pure-Python fallback:
same results, slower host packing and hashing.

The entries walk reads Python objects through the C API, so it is a
library of its own, built against the running interpreter's headers
(keyed on their path and the interpreter's version and ABI, so it never
loads into another Python) and called through `ctypes.PyDLL`, holding
the interpreter lock. Without `Python.h` or g++ it does not load, and
its caller encodes with `encode_entries`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
import sysconfig
from itertools import chain
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent
_SRCS = (_PKG.parent / "native" / "zkp_host.cpp", _PKG / "pool_pack.cpp")
_WALK_SRC = _PKG / "entry_walk.cpp"
BUILD_DIR = _PKG / "_kernels_build"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")

_lib = None
_load_failed = False
_walk = None  # zkp_walk_entries once loaded; False where it cannot build or load


def _build(stem: str = "host", srcs=_SRCS, flags=CXX_FLAGS, salt: str = "") -> Path | None:
    """Path of libzkp_<stem>.so built from `srcs` with g++ `flags` and
    keyed on them and `salt` (building it if needed), or None."""
    if not all(src.exists() for src in srcs):
        return None
    h = hashlib.sha256((" ".join(flags) + salt).encode())
    for src in srcs:
        h.update(src.read_bytes())
    out_dir = BUILD_DIR / f"{stem}-{h.hexdigest()[:16]}"
    so = out_dir / f"libzkp_{stem}.so"
    if so.exists():
        return so
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"libzkp_{stem}.{os.getpid()}.tmp.so"
    try:
        subprocess.run(["g++", *flags, "-o", str(tmp), *map(str, srcs)],
                       check=True, capture_output=True, timeout=300)
    except (OSError, subprocess.SubprocessError):
        return None
    os.replace(tmp, so)
    return so


def get_lib():
    """The loaded native library, or None if it cannot be built or loaded."""
    global _lib, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    so = _build()
    try:
        lib = ctypes.CDLL(str(so)) if so is not None else None
    except OSError:
        lib = None
    if lib is None:
        _load_failed = True
        return None
    lib.zkp_keccak256.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_char_p]
    if hasattr(lib, "zkp_keccak256_batch"):
        lib.zkp_keccak256_batch.restype = None
        lib.zkp_keccak256_batch.argtypes = [
            ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    lib.zkp_pack_proofs.restype = ctypes.c_int
    lib.zkp_build_node_pool.restype = ctypes.c_int
    lib.zkp_build_node_pool.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
    ]
    lib.zkp_item_offsets.restype = None
    lib.zkp_item_offsets.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.zkp_pack_pool.restype = ctypes.c_int
    lib.zkp_pack_pool.argtypes = (
        [ctypes.c_char_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_char_p,
         ctypes.c_char_p, ctypes.c_void_p] + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 9)
    _lib = lib
    return _lib


def available() -> bool:
    return get_lib() is not None


def keccak256(data: bytes) -> bytes:
    """Native legacy Keccak-256; falls back to the Python oracle."""
    lib = get_lib()
    if lib is None:
        from .oracle.keccak import keccak256 as py_keccak

        return py_keccak(data)
    out = ctypes.create_string_buffer(32)
    lib.zkp_keccak256(data, len(data), out)
    return out.raw


def keccak256_batch(messages) -> list[bytes]:
    """Native legacy Keccak-256 of each byte string in `messages`, in one
    call (zkp_keccak256_batch over the concatenated messages and their
    offsets); falls back to the Python oracle without the native library
    or the symbol."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "zkp_keccak256_batch"):
        from .oracle.keccak import keccak256 as py_keccak

        return [py_keccak(m) for m in messages]
    blob = b"".join(messages)
    offsets = np.zeros(len(messages) + 1, dtype=np.int64)
    np.cumsum([len(m) for m in messages], out=offsets[1:])
    out = np.empty((len(messages), 32), dtype=np.uint8)
    lib.zkp_keccak256_batch(blob, offsets.ctypes.data_as(ctypes.c_void_p), len(messages),
                            out.ctypes.data_as(ctypes.c_void_p))
    return [bytes(row) for row in out]


def build_node_pool_native(nodes, node_lens, num_nodes,
                           pad_multiple: int = 128, min_rows: int = 0):
    """Native unique-node pool construction (zkp_build_node_pool),
    byte-identical to witness.pack.build_node_pool. Returns (pool_nodes,
    pool_lens, pool_idx), or None without the native library."""
    lib = get_lib()
    if lib is None:
        return None
    nodes = np.ascontiguousarray(nodes, dtype=np.uint8)
    node_lens = np.ascontiguousarray(node_lens, dtype=np.int32)
    num_nodes = np.ascontiguousarray(num_nodes, dtype=np.int32)
    b, d, n = nodes.shape
    cap = int(num_nodes.sum()) + 1
    cap = max(-(-cap // pad_multiple) * pad_multiple, min_rows)
    pool_nodes = np.zeros((cap, n), dtype=np.uint8)
    pool_lens = np.zeros(cap, dtype=np.int32)
    pool_idx = np.zeros((b, d), dtype=np.int32)
    used = lib.zkp_build_node_pool(
        nodes.ctypes.data_as(ctypes.c_void_p),
        node_lens.ctypes.data_as(ctypes.c_void_p),
        num_nodes.ctypes.data_as(ctypes.c_void_p),
        b, d, n,
        pool_nodes.ctypes.data_as(ctypes.c_void_p),
        pool_lens.ctypes.data_as(ctypes.c_void_p),
        pool_idx.ctypes.data_as(ctypes.c_void_p),
        cap,
    )
    if used < 0:
        from .witness.pack import PackingError

        raise PackingError("node pool exceeded its capacity bound")
    u = max(-(-used // pad_multiple) * pad_multiple, min_rows)
    return pool_nodes[:u], pool_lens[:u], pool_idx


def item_offsets_native(rows):
    """Native per-node RLP offset-hint scan (zkp_item_offsets): rows u8
    [N, L] -> u8 [N, 36], or None without the native library."""
    lib = get_lib()
    if lib is None:
        return None
    rows = np.ascontiguousarray(rows, dtype=np.uint8)
    n, row_len = rows.shape
    out = np.empty((n, 36), dtype=np.uint8)
    lib.zkp_item_offsets(rows.ctypes.data_as(ctypes.c_void_p), n, row_len,
                         out.ctypes.data_as(ctypes.c_void_p))
    return out


def _offsets(parts) -> np.ndarray:
    """i64 [len(parts) + 1]: where each of `parts` starts in their join."""
    out = np.zeros(len(parts) + 1, dtype=np.int64)
    np.cumsum(np.fromiter(map(len, parts), dtype=np.int64, count=len(parts)), out=out[1:])
    return out


def encode_entries(entries) -> tuple:
    """The native packers' inputs from (root, proof, key) entries:
    (node_blob, node_offsets i64 [T + 1], counts i32 [B], roots_blob,
    key_blob, key_offsets i64 [B + 1]), every proof's nodes joined in
    order."""
    roots, proofs, keys = zip(*entries)
    nodes = list(chain.from_iterable(proofs))
    counts = np.fromiter(map(len, proofs), dtype=np.int32, count=len(proofs))
    return (b"".join(nodes), _offsets(nodes), counts, b"".join(roots), b"".join(keys),
            _offsets(keys))


def _walk_entries_fn():
    """zkp_walk_entries (entry_walk.cpp) through ctypes.PyDLL, or None
    where Python.h or g++ is missing or the library does not load."""
    global _walk
    if _walk is None:
        _walk = False
        include = sysconfig.get_paths()["include"]
        so = None
        if Path(include, "Python.h").exists():
            so = _build("walk", (_WALK_SRC,), (*CXX_FLAGS, f"-I{include}"),
                        salt=f"{sys.version} {sysconfig.get_config_var('SOABI')}")
        try:
            lib = ctypes.PyDLL(str(so)) if so is not None else None
        except OSError:
            lib = None
        if lib is not None:
            fn = lib.zkp_walk_entries
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.py_object] + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 6
            _walk = fn
    return _walk or None


def walk_available() -> bool:
    return _walk_entries_fn() is not None


class EntryStaging:
    """Host buffers that walk_entries writes a batch's entries into: the
    arrays of encode_entries for up to `batch` entries within the bucket
    (node_blob, node_offsets, counts, roots, key_blob, key_offsets, flat
    and C-contiguous), allocated and touched once, so a walk faults no
    page in."""

    FIELDS = ("node_blob", "node_offsets", "counts", "roots", "key_blob", "key_offsets")

    def __init__(self, batch: int, max_nodes: int, node_len: int, key_nibbles: int):
        self.bucket = (batch, max_nodes, node_len, key_nibbles)
        self.arrays = {}
        for name, dtype, size in self.layout(*self.bucket):
            a = np.empty(size, dtype=dtype)
            a.fill(0)
            self.arrays[name] = a

    @classmethod
    def layout(cls, batch: int, max_nodes: int, node_len: int, key_nibbles: int) -> tuple:
        """(name, dtype, elements) of each buffer, in FIELDS order."""
        u8, i32, i64 = np.dtype(np.uint8), np.dtype(np.int32), np.dtype(np.int64)
        return tuple(zip(cls.FIELDS, (u8, i64, i32, u8, u8, i64), (
            batch * max_nodes * node_len, batch * max_nodes + 1, batch, batch * 32,
            batch * (key_nibbles // 2), batch + 1)))


def walk_entries(entries, staging: EntryStaging):
    """encode_entries(entries), written by one native walk into
    `staging`: its arrays' views, equal to encode_entries's byte for
    byte. None where the walk does not load (walk_available) or cannot
    read an object in place (an entry other than a 3-item list or tuple,
    a proof other than a list or tuple, a root, key or node other than
    exactly bytes): encode_entries takes those. Raises the PackingError
    that pack_pool_native raises on encode_entries's arrays for a root
    not 32 bytes long or a proof past the bucket, writing nothing past
    the staging."""
    from .witness.pack import PackingError

    fn = _walk_entries_fn()
    if fn is None:
        return None
    batch, max_nodes, node_len, key_nibbles = staging.bucket
    a = staging.arrays
    for name, dtype, size in staging.layout(*staging.bucket):
        if a[name].dtype != dtype or a[name].shape != (size,) or not a[name].flags.c_contiguous:
            raise ValueError(f"{name}: {a[name].dtype} {a[name].shape} is not a "
                             f"C-contiguous {dtype} ({size},)")
    rc = fn(entries, max_nodes, node_len, key_nibbles, batch,
            *(_ptr(a[name]) for name in staging.FIELDS))
    if rc == -2:
        return None
    if rc == -1:
        raise PackingError("root must be 32 bytes")
    if rc > 0:
        raise _bucket_error(rc, max_nodes, node_len, key_nibbles)
    b = len(entries)
    counts, key_offsets = a["counts"][:b], a["key_offsets"][:b + 1]
    t = int(counts.sum())
    node_offsets = a["node_offsets"][:t + 1]
    return (a["node_blob"][:node_offsets[t]], node_offsets, counts, a["roots"][:32 * b],
            a["key_blob"][:key_offsets[b]], key_offsets)


def _bucket_error(rc: int, max_nodes: int, node_len: int, key_nibbles: int):
    from .witness.pack import PackingError

    return PackingError(f"proof {rc - 1} exceeds bucket (max_nodes={max_nodes}, "
                        f"node_len={node_len}, key_nibbles={key_nibbles})")


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def _cbuf(data):
    """char* to `data`: bytes, or a C-contiguous uint8 array (walk_entries)."""
    return ctypes.c_char_p(data if isinstance(data, bytes) else data.ctypes.data)


def pack_proofs_native(entries, max_nodes: int, node_len: int, key_nibbles: int):
    """Native packing path for witness.pack_proofs. Returns the packed
    numpy arrays, or None without the native library."""
    lib = get_lib()
    if lib is None:
        return None
    node_blob, node_offsets, counts, roots_blob, key_blob, key_offsets = \
        encode_entries(entries)
    b = len(counts)
    nodes = np.empty((b, max_nodes, node_len), dtype=np.uint8)
    node_lens = np.empty((b, max_nodes), dtype=np.int32)
    num_nodes = np.empty(b, dtype=np.int32)
    out_roots = np.empty((b, 32), dtype=np.uint8)
    knib = np.empty((b, key_nibbles), dtype=np.uint8)
    key_lens = np.empty(b, dtype=np.int32)

    rc = lib.zkp_pack_proofs(
        ctypes.c_char_p(node_blob), _ptr(node_offsets), _ptr(counts),
        ctypes.c_char_p(roots_blob), ctypes.c_char_p(key_blob), _ptr(key_offsets),
        b, max_nodes, node_len, key_nibbles,
        _ptr(nodes), _ptr(node_lens), _ptr(num_nodes), _ptr(out_roots), _ptr(knib),
        _ptr(key_lens),
    )
    if rc != 0:
        raise _bucket_error(rc, max_nodes, node_len, key_nibbles)
    return nodes, node_lens, num_nodes, out_roots, knib, key_lens


def pool_pass_layout(batch: int, max_nodes: int, node_len: int, key_nibbles: int,
                     pool_rows: int) -> tuple:
    """(name, dtype, shape) of each array zkp_pack_pool writes, in its
    argument order."""
    u8, i32 = np.dtype(np.uint8), np.dtype(np.int32)
    return (("pool_nodes", u8, (pool_rows, node_len)), ("pool_lens", i32, (pool_rows,)),
            ("pool_hints", u8, (pool_rows, 36)), ("pool_idx", i32, (batch, max_nodes)),
            ("num_nodes", i32, (batch,)), ("roots", u8, (batch, 32)),
            ("key_nibbles", u8, (batch, key_nibbles)), ("key_lens", i32, (batch,)))


def pack_pool_native(encoded, max_nodes: int, node_len: int, key_nibbles: int,
                     out: dict) -> int:
    """Pool-first packing (zkp_pack_pool): `encoded` entries
    (encode_entries or walk_entries) straight into `out`, C-contiguous
    NumPy arrays laid out as pool_pass_layout gives them for the batch and R =
    out["pool_nodes"].shape[0] pool rows, every byte of which it writes:
    byte for byte `witness.pack_proofs(entries, max_nodes, node_len,
    key_nibbles).pool(min_rows=R)`, its `pool_hints()` and its per-proof
    scalars. Returns the pool rows used; raises the PackingError that
    pack_proofs or pool() raises for the batch, and ValueError for an
    `out` array of another dtype, shape or layout. The native library must
    load (available)."""
    from .witness.pack import PackingError

    node_blob, node_offsets, counts, roots_blob, key_blob, key_offsets = encoded
    b = len(counts)
    if len(roots_blob) != 32 * b:
        raise PackingError("root must be 32 bytes")
    pool_rows = out["pool_nodes"].shape[0]
    layout = pool_pass_layout(b, max_nodes, node_len, key_nibbles, pool_rows)
    for name, dtype, shape in layout:
        a = out[name]
        if a.dtype != dtype or a.shape != shape or not a.flags.c_contiguous:
            raise ValueError(f"{name}: {a.dtype} {a.shape} is not a C-contiguous "
                             f"{dtype} {shape}")
    used = ctypes.c_int32(0)
    rc = get_lib().zkp_pack_pool(
        _cbuf(node_blob), _ptr(node_offsets), _ptr(counts),
        _cbuf(roots_blob), _cbuf(key_blob), _ptr(key_offsets),
        b, max_nodes, node_len, key_nibbles, pool_rows,
        *(_ptr(out[name]) for name, _, _ in layout), ctypes.byref(used),
    )
    if rc > 0:
        raise _bucket_error(rc, max_nodes, node_len, key_nibbles)
    if rc < 0:
        raise PackingError(f"node pool needs {-(-used.value // 128) * 128} rows > bucket "
                           f"pool_rows={pool_rows}")
    return used.value
