"""Stream sinks (counterpart: ``alink_tpu/operator/stream/sink``)."""

from .sinks import BaseSinkStreamOp, CollectSinkStreamOp

__all__ = ["BaseSinkStreamOp", "CollectSinkStreamOp"]
