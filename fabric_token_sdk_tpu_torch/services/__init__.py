"""Token services. Ported so far: `network` (the block validation path:
orderer, pipelined block engine, ledger, WAL) and `interop` (the HTLC
scripts that the identity layer's `htlc` branch verifies); the vault,
selector and transaction services, the remote server and replication of
the JAX package come later.

Reference: `token/services/*`.
"""
