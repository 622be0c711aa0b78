"""Batch operators of the port (counterpart: ``alink_tpu/operator/batch``).

The operators live in the subpackages; the model families of slice 23
(naive Bayes, the multilayer perceptron, GMM and bisecting KMeans, GLM,
isotonic and AFT regression), ``SegmentBatchOp`` and the ops of slice 24
(the feature ops, statistics, the indexers and vector ops, sampling,
similarity and SOS) and of slice 25 (the SQL ops, association rules and
the function ops) are exported here as well, on first access (a module
``__getattr__``: importing this package imports no operator)."""

import importlib

_LAZY = {n: ".classification" for n in (
    "NaiveBayesTextTrainBatchOp", "NaiveBayesTextPredictBatchOp",
    "NaiveBayesTrainBatchOp", "NaiveBayesPredictBatchOp",
    "MultilayerPerceptronTrainBatchOp", "MultilayerPerceptronPredictBatchOp")}
_LAZY.update((n, ".regression") for n in (
    "GlmTrainBatchOp", "GlmPredictBatchOp", "GlmEvaluationBatchOp",
    "IsotonicRegTrainBatchOp", "IsotonicRegPredictBatchOp",
    "AftSurvivalRegTrainBatchOp", "AftSurvivalRegPredictBatchOp"))
_LAZY.update((n, ".clustering") for n in (
    "GmmTrainBatchOp", "GmmPredictBatchOp", "BisectingKMeansTrainBatchOp",
    "BisectingKMeansPredictBatchOp"))
_LAZY["SegmentBatchOp"] = ".nlp"
_LAZY.update((n, ".feature.feature_ops") for n in (
    "OneHotTrainBatchOp", "OneHotPredictBatchOp",
    "QuantileDiscretizerTrainBatchOp", "QuantileDiscretizerPredictBatchOp",
    "BucketizerBatchOp", "BinarizerBatchOp", "FeatureHasherBatchOp",
    "ChiSqSelectorBatchOp", "VectorChiSqSelectorBatchOp", "PcaTrainBatchOp",
    "PcaPredictBatchOp", "DCTBatchOp"))
_LAZY.update((n, ".statistics.stat_ops") for n in (
    "SummarizerBatchOp", "VectorSummarizerBatchOp", "CorrelationBatchOp",
    "VectorCorrelationBatchOp", "ChiSquareTestBatchOp",
    "VectorChiSquareTestBatchOp"))
_LAZY.update((n, ".dataproc.indexers") for n in (
    "StringIndexerTrainBatchOp", "StringIndexerPredictBatchOp",
    "MultiStringIndexerTrainBatchOp", "MultiStringIndexerPredictBatchOp",
    "IndexToStringPredictBatchOp"))
_LAZY.update((n, ".dataproc.vector_ops") for n in (
    "VectorAssemblerBatchOp", "VectorSliceBatchOp", "VectorNormalizeBatchOp",
    "VectorElementwiseProductBatchOp", "VectorInteractionBatchOp",
    "VectorPolynomialExpandBatchOp", "VectorSizeHintBatchOp",
    "VectorToColumnsBatchOp", "VectorStandardScalerTrainBatchOp",
    "VectorStandardScalerPredictBatchOp", "VectorMinMaxScalerTrainBatchOp",
    "VectorMinMaxScalerPredictBatchOp", "VectorMaxAbsScalerTrainBatchOp",
    "VectorMaxAbsScalerPredictBatchOp", "VectorImputerTrainBatchOp",
    "VectorImputerPredictBatchOp", "VectorSerializeBatchOp"))
_LAZY.update((n, ".dataproc") for n in (
    "SampleBatchOp", "SampleWithSizeBatchOp", "WeightSampleBatchOp",
    "SplitBatchOp", "FirstNBatchOp", "AppendIdBatchOp", "ShuffleBatchOp",
    "NumericalTypeCastBatchOp", "JsonValueBatchOp"))
_LAZY.update((n, ".similarity") for n in (
    "StringSimilarityPairwiseBatchOp", "TextSimilarityPairwiseBatchOp",
    "ApproxVectorSimilarityJoinLSHBatchOp",
    "ApproxVectorSimilarityTopNLSHBatchOp"))
_LAZY["SosBatchOp"] = ".outlier"
_LAZY.update((n, ".sql") for n in (
    "SelectBatchOp", "AsBatchOp", "WhereBatchOp", "FilterBatchOp",
    "DistinctBatchOp", "OrderByBatchOp", "GroupByBatchOp", "UnionAllBatchOp",
    "UnionBatchOp", "IntersectBatchOp", "IntersectAllBatchOp", "MinusBatchOp",
    "MinusAllBatchOp", "JoinBatchOp", "LeftOuterJoinBatchOp",
    "RightOuterJoinBatchOp", "FullOuterJoinBatchOp", "CrossBatchOp"))
_LAZY.update((n, ".associationrule") for n in ("FpGrowthBatchOp",
                                               "PrefixSpanBatchOp"))
_LAZY.update((n, ".utils") for n in (
    "UDFBatchOp", "UDTFBatchOp", "FlatMapBatchOp", "PrintBatchOp",
    "DataSetWrapperBatchOp"))

__all__ = sorted(_LAZY)


def __getattr__(name):
    if name not in _LAZY:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(_LAZY[name], __name__), name)
    globals()[name] = value
    return value
