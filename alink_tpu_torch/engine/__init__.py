"""The BSP engine of the port at one worker (counterpart:
``alink_tpu/engine``). ``recovery.py`` (checkpoints) is not ported."""

from .context import ComContext
from .comqueue import IterativeComQueue, ComputeFunction, ComQueueResult
from .communication import AllReduce, CommunicateFunction

__all__ = [
    "ComContext", "IterativeComQueue", "ComputeFunction", "ComQueueResult",
    "CommunicateFunction", "AllReduce",
]
