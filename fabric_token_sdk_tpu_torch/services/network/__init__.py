"""The block validation path: orderer, pipelined block engine, ledger and
WAL. Counterpart of `fabric_token_sdk_tpu/services/network/` without its
remote server and replication."""

from .ledger import Block, FinalityEvent, Network, TxStatus  # noqa: F401
from .orderer import (  # noqa: F401
    Backpressure, BlockPolicy, DevicePlaneError, Orderer, Submission,
)
from .pipeline import BusyClock, PipelinedBlockEngine  # noqa: F401
from .wal import WALError, WriteAheadLog  # noqa: F401
