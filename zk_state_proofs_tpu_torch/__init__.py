"""zk_state_proofs_tpu_torch — the PyTorch / CUDA port of zk_state_proofs_tpu.

The pooled account-proof, two-level storage and block (transaction and
receipt trie, ERC20 extraction) verification paths of the JAX package,
re-built on PyTorch with hand-written CUDA kernels for Hopper (sm_90a):

  ops/keccak.py      plain batched Keccak-256 (the CPU path and the reference
                     of kernels K1 and K3)
  ops/keccak_cuda.py K1: one-thread-per-message Keccak-256 sponge; K3: the
                     same from raw little-endian words (csrc/keccak.cu)
  ops/rlp.py         RLP header/node decoding as indexed loads
  ops/mpt.py         plain walk (the CPU path and the reference of K2), pool
                     hashing, scatter, and the verify entry points
  ops/mpt_cuda.py    K2: one-thread-per-proof fused MPT walk in all the TPU
                     kernel's modes: `hinted` and its variants `hinted4`,
                     `hinted1`, `ordered`, `pairskip` (`hint_mode`),
                     `bounded` and `exact` (csrc/mpt_walk.cu)
  models/            verifier workloads (accounts, two-level storage, block
                     tx/receipt tries) and the bucket-pinned BatchVerifier
  witness_bridge.py  PackedProofs -> tensors, and the witness recipes
  oracle/, witness/, native.py
                     the port's own copies of the JAX package's host layers
                     (pure-Python oracle, packer, tx/receipt encoders, block
                     trie builders, fixtures, C++ host runtime bindings)

The port imports nothing of the JAX package. Importing it loads neither JAX
nor CUDA: kernels are built at their first launch, and dispatch follows the
tensor's device (a CPU tensor takes the plain version, a CUDA tensor
launches the kernel).
"""

__version__ = "0.1.0"
