// The entries walk of the serving layer's pool-first route
// (models/service.py): a request's (root, proof, key) entries, as Python
// objects, copied in one pass into host staging laid out as the inputs of
// zkp_pack_pool (pool_pack.cpp) and zkp_pack_proofs: the node blob and its
// offsets, the proof counts, the roots, the key blob and its offsets.
//
// Built on its own by native.py against the running interpreter's headers
// and loaded with ctypes.PyDLL: the walk reads Python objects, so it runs
// holding the interpreter lock, and calls no Python code. Single-threaded.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cstdint>
#include <cstring>

namespace {

constexpr int kBadRoot = -1;
constexpr int kUnreadable = -2;

// The items of a list or a tuple, or false for any other object.
inline bool items_of(PyObject* o, PyObject*** items, Py_ssize_t* n) {
  if (!PyList_Check(o) && !PyTuple_Check(o)) return false;
  *items = PySequence_Fast_ITEMS(o);
  *n = PySequence_Fast_GET_SIZE(o);
  return true;
}

}  // namespace

extern "C" {

// Walk `entries`, a list or tuple of at most `batch` entries, each a
// 3-item list or tuple (root, proof, key): root and key exactly bytes,
// proof a list or tuple of exactly-bytes nodes. Writes, for the entries
// in order (the layout of native.encode_entries):
//   node_blob: every node's bytes, joined; node_offsets i64 [T + 1]
//   counts i32 [b]; roots u8 [b * 32]
//   key_blob: every key's bytes, joined; key_offsets i64 [b + 1]
// The caller's buffers hold what `batch` entries within the bucket need:
// node_blob batch * max_nodes * node_len bytes, node_offsets
// batch * max_nodes + 1, key_blob batch * (key_nib / 2) bytes.
//
// Returns 0 when every entry was written; kUnreadable (nothing more
// written) where an object is of another type or shape, or the entries are
// more than `batch`; else kBadRoot where a root is not 32 bytes long; else
// the 1-based index of the first proof that breaks the bucket (more than
// max_nodes nodes, a node over node_len bytes, a key over key_nib
// nibbles), as zkp_pack_pool reports it. Past a bad root or a broken
// proof nothing more is written: the walk reads on only to tell those
// outcomes apart, so the buffers are never overrun.
int zkp_walk_entries(PyObject* entries, int max_nodes, int node_len, int key_nib,
                     int batch, uint8_t* node_blob, int64_t* node_offsets,
                     int32_t* counts, uint8_t* roots, uint8_t* key_blob,
                     int64_t* key_offsets) {
  PyObject** es;
  Py_ssize_t b;
  if (!items_of(entries, &es, &b) || b > batch) return kUnreadable;
  bool bad_root = false;
  int first_break = 0;
  int64_t t = 0, at = 0, key_at = 0;
  node_offsets[0] = 0;
  key_offsets[0] = 0;
  for (Py_ssize_t i = 0; i < b; ++i) {
    PyObject** f;
    Py_ssize_t nf;
    if (!items_of(es[i], &f, &nf) || nf != 3) return kUnreadable;
    PyObject* root = f[0];
    PyObject* key = f[2];
    PyObject** nodes;
    Py_ssize_t cnt;
    if (!PyBytes_CheckExact(root) || !PyBytes_CheckExact(key) ||
        !items_of(f[1], &nodes, &cnt))
      return kUnreadable;
    const Py_ssize_t klen = PyBytes_GET_SIZE(key);
    bad_root = bad_root || PyBytes_GET_SIZE(root) != 32;
    bool copy = !bad_root && first_break == 0;
    if (copy && (cnt > max_nodes || 2 * klen > key_nib)) {
      first_break = static_cast<int>(i) + 1;
      copy = false;
    }
    for (Py_ssize_t j = 0; j < cnt; ++j) {
      PyObject* node = nodes[j];
      if (!PyBytes_CheckExact(node)) return kUnreadable;
      if (!copy) continue;
      const Py_ssize_t len = PyBytes_GET_SIZE(node);
      if (len > node_len) {
        first_break = static_cast<int>(i) + 1;
        copy = false;
        continue;
      }
      std::memcpy(node_blob + at, PyBytes_AS_STRING(node), static_cast<size_t>(len));
      at += len;
      node_offsets[t + j + 1] = at;
    }
    if (!copy) continue;
    t += cnt;
    counts[i] = static_cast<int32_t>(cnt);
    std::memcpy(roots + 32 * i, PyBytes_AS_STRING(root), 32);
    std::memcpy(key_blob + key_at, PyBytes_AS_STRING(key), static_cast<size_t>(klen));
    key_at += klen;
    key_offsets[i + 1] = key_at;
  }
  return bad_root ? kBadRoot : first_break;
}

}  // extern "C"
