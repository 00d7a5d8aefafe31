"""The block validation path and the network plane: orderer, pipelined
block engine, ledger, WAL, the remote ledger node and client, and WAL
shipping replication. Counterpart of `fabric_token_sdk_tpu/services/network/`."""

from . import replication  # noqa: F401
from .ledger import Block, FinalityEvent, Network, TxStatus  # noqa: F401
from .orderer import (  # noqa: F401
    Backpressure, BlockPolicy, DevicePlaneError, Orderer, Submission,
)
from .pipeline import BusyClock, PipelinedBlockEngine  # noqa: F401
from .remote import LedgerServer, RemoteError, RemoteNetwork  # noqa: F401
from .replication import NotLeader, StaleEpoch  # noqa: F401
from .wal import WALError, WriteAheadLog  # noqa: F401
