"""The BSP engine of the port at one worker (counterpart:
``alink_tpu/engine``), with its superstep checkpoints and resume
(``recovery.py``)."""

from .context import ComContext
from .comqueue import IterativeComQueue, ComputeFunction, ComQueueResult
from .communication import (AllGather, AllReduce, BroadcastFromWorker0,
                            CommunicateFunction)

__all__ = [
    "ComContext", "IterativeComQueue", "ComputeFunction", "ComQueueResult",
    "CommunicateFunction", "AllReduce", "AllGather", "BroadcastFromWorker0",
]
