from .sharding import (  # noqa: F401
    DeviceMesh,
    MeshBound,
    MeshConfig,
    make_mesh,
    mesh_on_device,
    run_rows_dp,
    same_device,
    shard_rows,
    sharded_pairing_product,
    sharded_schnorr_rows,
)
