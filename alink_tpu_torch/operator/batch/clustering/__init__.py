"""Batch clustering operators of the port (counterpart:
``alink_tpu/operator/batch/clustering``): KMeans, LDA, GMM and bisecting
KMeans."""

from .gmm_bisecting import (BisectingKMeansPredictBatchOp,
                            BisectingKMeansTrainBatchOp,
                            GmmModelDataConverter, GmmModelMapper,
                            GmmPredictBatchOp, GmmTrainBatchOp)
from .kmeans_ops import (KMeansModelData, KMeansModelDataConverter,
                         KMeansModelMapper, KMeansPredictBatchOp,
                         KMeansTrainBatchOp)
from .lda_ops import (LdaModelData, LdaModelDataConverter, LdaModelMapper,
                      LdaPredictBatchOp, LdaTrainBatchOp)

__all__ = ["KMeansTrainBatchOp", "KMeansPredictBatchOp", "KMeansModelData",
           "KMeansModelDataConverter", "KMeansModelMapper",
           "LdaTrainBatchOp", "LdaPredictBatchOp", "LdaModelData",
           "LdaModelDataConverter", "LdaModelMapper",
           "GmmTrainBatchOp", "GmmPredictBatchOp", "GmmModelDataConverter",
           "GmmModelMapper", "BisectingKMeansTrainBatchOp",
           "BisectingKMeansPredictBatchOp"]
