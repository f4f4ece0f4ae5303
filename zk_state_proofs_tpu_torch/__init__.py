"""zk_state_proofs_tpu_torch — the PyTorch / CUDA port of zk_state_proofs_tpu.

The pooled account-proof verification path of the JAX package, re-built on
PyTorch with hand-written CUDA kernels for Hopper (sm_90a):

  ops/keccak.py      plain batched Keccak-256 (the CPU path and the reference
                     of kernel K1)
  ops/keccak_cuda.py K1: one-thread-per-message Keccak-256 sponge
                     (csrc/keccak.cu)
  ops/rlp.py         RLP header/node decoding as indexed loads
  ops/mpt.py         plain walk (the CPU path and the reference of K2), pool
                     hashing, scatter, and the verify entry points
  ops/mpt_cuda.py    K2: one-thread-per-proof fused MPT walk, modes `hinted`
                     and `exact` (csrc/mpt_walk.cu)
  models/            verifier workloads and the bucket-pinned BatchVerifier
  witness_bridge.py  PackedProofs -> tensors

Host layers that hold no JAX (`oracle`, `witness`, `native`) are imported from
the JAX package. Importing this package loads neither JAX nor CUDA: kernels
are built at their first launch, and dispatch follows the tensor's device (a
CPU tensor takes the plain version, a CUDA tensor launches the kernel).
"""

__version__ = "0.1.0"
