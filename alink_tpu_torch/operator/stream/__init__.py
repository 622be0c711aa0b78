"""Stream layer of the port (counterpart: ``alink_tpu/operator/stream``).
The sinks, the evaluation ops, the ``*PredictStreamOp`` twins and
``AlsPredictStreamOp`` are exported here, as there; the other stream ops
are imported from their modules. The sinks are imported with the
package; the others on first access (a module ``__getattr__``), since
the kernel modules reach this package through ``stream/prefetch.py``
while the batch ops the twins wrap import them."""

import importlib

from .sink import (BaseSinkStreamOp, CheckpointSinkStreamOp,
                   CollectSinkStreamOp, CsvSinkStreamOp, LibSvmSinkStreamOp,
                   TextSinkStreamOp)

_LAZY = {"EvalBinaryClassStreamOp": ".evaluation",
         "EvalMultiClassStreamOp": ".evaluation",
         "EvalRegressionStreamOp": ".evaluation",
         "AlsPredictStreamOp": ".recommendation"}
# the twins' names (predict_ops' __all__, spelled out so that importing
# this package imports no batch op)
_LAZY.update((f"{n}PredictStreamOp", ".predict_ops") for n in (
    "LogisticRegression", "LinearSvm", "Softmax", "Perceptron", "Gbdt",
    "GbdtReg", "RandomForest", "RandomForestReg", "DecisionTree",
    "DecisionTreeReg", "LinearReg", "RidgeReg", "LassoReg", "LinearSvr",
    "KMeans", "StandardScaler", "MinMaxScaler", "MaxAbsScaler", "Imputer",
    "Fm", "DocCountVectorizer", "DocHashCountVectorizer", "Word2Vec"))

__all__ = ["BaseSinkStreamOp", "CheckpointSinkStreamOp",
           "CollectSinkStreamOp", "CsvSinkStreamOp", "LibSvmSinkStreamOp",
           "TextSinkStreamOp"] + sorted(_LAZY)


def __getattr__(name):
    if name not in _LAZY:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(_LAZY[name], __name__), name)
    globals()[name] = value
    return value
