"""Batch recommendation operators of the port (counterpart:
``alink_tpu/operator/batch/recommendation``): ALS."""

from .als_ops import (AlsModelData, AlsModelDataConverter,
                      AlsPredictBatchOp, AlsRater, AlsTopKPredictBatchOp,
                      AlsTrainBatchOp)

__all__ = ["AlsTrainBatchOp", "AlsPredictBatchOp", "AlsTopKPredictBatchOp",
           "AlsModelData", "AlsModelDataConverter", "AlsRater"]
