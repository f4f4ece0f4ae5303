"""The port's benchmark programs, each the counterpart of one of the JAX
package's (each module's docstring names its file and lines). Each runs on
the card as `python -m zk_state_proofs_tpu_torch.bench.<module>` and prints
JSON lines on stdout; without a card each exits non-zero.

  common    the card line, JSON lines, the perturbation counter and the
            accumulator fold, timers on CUDA events, launch counts and the
            kernels' bounds (`bound_ms`)
  headline  bench.py: the headline pooled verify, the hot trie, the
            resident epoch sweep and K1's rates
  configs   bench_configs.py: BASELINE configs 1-6
  scaling   bench_scaling.py: proofs/s over 1, 2, 4, ... cards
  ab        analysis/ab_walk.py and analysis/ab_keccak.py: in-process A/B
            runs of K2's hint modes and of K1's pool-hash variants

Importing a module initialises no CUDA and loads no JAX.
"""
