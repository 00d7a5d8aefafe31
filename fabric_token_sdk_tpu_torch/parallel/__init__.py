from .sharding import (  # noqa: F401
    DeviceMesh,
    MeshConfig,
    make_mesh,
    run_rows_dp,
    shard_rows,
    sharded_pairing_product,
    sharded_schnorr_rows,
)
