"""Token services. Only `interop` (the HTLC scripts that the identity
layer's `htlc` branch verifies) is ported so far; the network, vault,
selector and transaction services of the JAX package come later.

Reference: `token/services/*`.
"""
