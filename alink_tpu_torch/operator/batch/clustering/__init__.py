"""Batch clustering operators of the port (counterpart:
``alink_tpu/operator/batch/clustering``): KMeans and LDA. GMM and
bisecting KMeans wait for their slices (ROADMAP A7(c))."""

from .kmeans_ops import (KMeansModelData, KMeansModelDataConverter,
                         KMeansModelMapper, KMeansPredictBatchOp,
                         KMeansTrainBatchOp)
from .lda_ops import (LdaModelData, LdaModelDataConverter, LdaModelMapper,
                      LdaPredictBatchOp, LdaTrainBatchOp)

__all__ = ["KMeansTrainBatchOp", "KMeansPredictBatchOp", "KMeansModelData",
           "KMeansModelDataConverter", "KMeansModelMapper",
           "LdaTrainBatchOp", "LdaPredictBatchOp", "LdaModelData",
           "LdaModelDataConverter", "LdaModelMapper"]
