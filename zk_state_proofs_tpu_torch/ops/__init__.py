"""Device compute path: keccak, RLP decode, MPT walk."""

from .keccak import keccak256, keccak_f1600, keccak256_fixed

__all__ = ["keccak256", "keccak_f1600", "keccak256_fixed"]
