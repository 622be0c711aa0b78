"""alink_tpu_torch.serving — the serving tier of the port
(counterpart: ``alink_tpu/serving``).

* :class:`CompiledPredictor` — pads request tables to shape buckets and
  scores them on the device through the mapper's ``ServingKernel``;
  hot model swap flips a double-buffered slot.
* :class:`PredictServer` — the micro-batcher: concurrent single-row
  requests coalesce into bucket-sized device batches.
"""

from .predictor import CompiledPredictor, ServingKernel, serve_buckets
from .server import PredictServer, RequestFuture

__all__ = ["CompiledPredictor", "ServingKernel", "serve_buckets",
           "PredictServer", "RequestFuture"]
