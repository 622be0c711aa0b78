"""Online learning stream operators (counterpart:
``alink_tpu/operator/stream/onlinelearning``)."""

from .ftrl import FtrlPredictStreamOp, FtrlTrainStreamOp

__all__ = ["FtrlPredictStreamOp", "FtrlTrainStreamOp"]
