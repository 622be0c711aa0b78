"""Batch operators of the port (counterpart: ``alink_tpu/operator/batch``).

The operators live in the subpackages; the model families of slice 23
(naive Bayes, the multilayer perceptron, GMM and bisecting KMeans, GLM,
isotonic and AFT regression) and ``SegmentBatchOp`` are exported here as
well, on first access (a module ``__getattr__``: importing this package
imports no operator)."""

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

__all__ = sorted(_LAZY)


def __getattr__(name):
    if name not in _LAZY:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(_LAZY[name], __name__), name)
    globals()[name] = value
    return value
