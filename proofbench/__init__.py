"""proofbench: the benchmark of the PyTorch and CUDA port of the state-proof
verifier. `python -m proofbench.run --workload <cell> --seed <n> --seconds
<s> --trace <0|1>` runs one cell once and prints one JSON line."""
