"""The plain reference and the frozen arithmetic of the benchmark: Keccak-256,
the Merkle-Patricia proof walk and the kernels' least times. Imports torch
alone, and nothing of the system under test."""
