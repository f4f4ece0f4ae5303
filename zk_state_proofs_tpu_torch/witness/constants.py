"""Pinned endpoints and test fixtures — parity with the reference's
constants (reference: trie-utils/src/constants.rs:1-24).

The port's own copy of `zk_state_proofs_tpu.witness.constants`.
"""

NODE_RPC_URL = "https://mainnet.infura.io/v3/"
OPTIMISM_RPC_URL = "https://mainnet.optimism.io/"
ARBITRUM_ONE_RPC_URL = "https://arb1.arbitrum.io/rpc"

# pinned mainnet block (used for reproducible tx/receipt trie tests)
DEFAULT_BLOCK_HASH = (
    "0x8230bd00f36e52e68dd4a46bfcddeceacbb689d808327f4c76dbdf8d33d58ca8"
)
DEFAULT_OPTIMISM_BLOCK_HASH = (
    "0xda01e7fa47eb8261260369794b4eb1afe06470f2f7b047eadaf031737a3038e8"
)
DEFAULT_ARBITRUM_ONE_BLOCK_HASH = (
    "0x4f1ab3cfc6ce0b2cf989b4e7a1811e38647b0e0fd6695b923fe8870eab1aaf24"
)

# USDT contract addresses per network
USDT_CONTRACT_ADDRESS = "0xdAC17F958D2ee523a2206206994597C13D831ec7"
USDT_CONTRACT_ADDRESS_OPTIMISM = "0x94b008aA00579c1307B0EF2c499aD98a8ce58e58"
USDT_CONTRACT_ADDRESS_ARBITRUM = "0xFd086bC7CD5C481DCC9C85ebE478A1C0b69FCbb9"

# totalSupply storage slots for USDT
DEFAULT_STORAGE_KEY_ETHEREUM = (
    "0x0000000000000000000000000000000000000000000000000000000000000000"
)
DEFAULT_STORAGE_KEY_OPTIMISM = (
    "0x0000000000000000000000000000000000000000000000000000000000000002"
)
