"""Batch clustering operators of the port (counterpart:
``alink_tpu/operator/batch/clustering``): KMeans. LDA, GMM and bisecting
KMeans wait for their slices (ROADMAP A7)."""

from .kmeans_ops import (KMeansModelData, KMeansModelDataConverter,
                         KMeansModelMapper, KMeansPredictBatchOp,
                         KMeansTrainBatchOp)

__all__ = ["KMeansTrainBatchOp", "KMeansPredictBatchOp", "KMeansModelData",
           "KMeansModelDataConverter", "KMeansModelMapper"]
