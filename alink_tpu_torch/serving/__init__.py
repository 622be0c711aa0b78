"""alink_tpu_torch.serving — the serving tier of the port
(counterpart: ``alink_tpu/serving``).

* :class:`CompiledPredictor` — pads request tables to shape buckets and
  scores them on the device through the mapper's ``ServingKernel``;
  hot model swap flips a double-buffered slot (``swap_model``, and
  ``swap_weights`` for same-geometry device weights).
* :class:`PredictServer` — the micro-batcher: concurrent single-row
  requests coalesce into bucket-sized device batches, with deadlines
  and shedding, a per-model-version :class:`CircuitBreaker` over the
  device dispatch and a supervised serving loop.
* :class:`ModelStreamFeeder` / :class:`DeviceWeightsFeeder` — swap the
  served model per FTRL snapshot (through a host model table, or as
  device weights), supervised.
* :class:`LoadGenerator` — the closed-loop load generator (QPS, p50,
  p99); :func:`serial_qps` the serial-dispatch baseline.

Left out: the multi-tenant fleet and the sharded / replicated serving
of the JAX package (ROADMAP A9).
"""

from .loadgen import LoadGenerator, LoadReport, percentile, serial_qps
from .plan import ServingPlan
from .predictor import (CompiledPredictor, ServingKernel, serve_buckets,
                        serve_compiled_enabled)
from .resilience import (CircuitBreaker, DeadlineExceeded, ReplicaCrashed,
                         RequestCancelled, TenantQuotaExceeded,
                         serve_breaker_enabled)
from .server import (DeviceWeightsFeeder, ModelStreamFeeder, PredictServer,
                     RequestFuture)

__all__ = [
    "CompiledPredictor", "ServingKernel", "ServingPlan", "PredictServer",
    "RequestFuture", "ModelStreamFeeder", "DeviceWeightsFeeder",
    "LoadGenerator", "LoadReport", "percentile", "serial_qps",
    "serve_buckets", "serve_compiled_enabled", "CircuitBreaker",
    "DeadlineExceeded", "ReplicaCrashed", "RequestCancelled",
    "TenantQuotaExceeded", "serve_breaker_enabled",
]
