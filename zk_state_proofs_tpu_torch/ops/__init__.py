"""Device compute path: keccak, RLP decode, MPT walk."""
