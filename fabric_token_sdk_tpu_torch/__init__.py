"""fabric_token_sdk_tpu_torch — the PyTorch + CUDA port of fabric_token_sdk_tpu.

Grows slice by slice beside the JAX package, which stays the reference.
It imports torch and numpy, never jax and nothing of the JAX package:
host-only modules are carried over as copies.

Layers (mirroring the JAX package):
  ops/     256-bit words, BN254 Fp, G1, row stages; CUDA wrappers and
           their plain torch versions
  csrc/    hand-written CUDA kernels for sm_90a (H100)
  crypto/  ZK protocol layer (host copies) and the batched verifiers
  native/  C host library (BN254 host math, batch SHA-256), built with cc
  utils/   counters, gauges and spans (cut-down host copy)

Entry points run on the card unless the caller passes device="cpu".
"""

__version__ = "0.1.0"
