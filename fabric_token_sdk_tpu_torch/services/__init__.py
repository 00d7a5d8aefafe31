"""Token services. Ported: `network` (the block validation path: orderer,
pipelined block engine, ledger, WAL), `interop` (the HTLC scripts that
the identity layer's `htlc` branch verifies), and the client side: `ttx`
(parties, transactions, the pipelined prove-and-submit client), `vault`,
`selector`, `ttxdb`, `auditor`, `owner`, `query`, `certifier` and
`nfttx`. The remote server and replication of the JAX package come later.

Reference: `token/services/*`.
"""
