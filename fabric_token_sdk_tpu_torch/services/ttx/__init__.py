from .party import Party  # noqa: F401
from .pipeline import PipelinedSubmitter, pipelined_submit  # noqa: F401
from .transaction import Transaction  # noqa: F401
