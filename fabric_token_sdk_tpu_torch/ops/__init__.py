"""GPU compute path: 256-bit words, the BN254 field and tower, G1, G2,
the pairing, row stages.

The port of `fabric_token_sdk_tpu/ops`. Elements are `(..., 8)` int32
tensors of 32-bit words; the hand-written CUDA kernels live in `csrc/`
and are built at first use by `_build.py`; every kernel has a plain
torch version beside its wrapper that the CPU runs.
"""
