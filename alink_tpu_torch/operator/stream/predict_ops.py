"""Stream predict twins of the model-backed batch operators.

Counterpart: ``alink_tpu/operator/stream/predict_ops.py``. The reference
ships a ``*PredictStreamOp`` next to nearly every ``*PredictBatchOp``
(operator/stream/{classification,regression,clustering,dataproc}/); all
have one shape: load the batch-trained model once a drain and map every
micro-batch through the batch op's model mapper
(stream/utils/ModelMapStreamOp). Here each twin is generated from its
batch class: the same mapper and the same params.

Ported, for the families the port has (23 twins): the linear ones
(``LogisticRegression``, ``LinearSvm``, ``Softmax``, ``Perceptron``,
``LinearReg``, ``RidgeReg``, ``LassoReg``, ``LinearSvr``), the trees
(``Gbdt``, ``GbdtReg``, ``RandomForest``, ``RandomForestReg``,
``DecisionTree``, ``DecisionTreeReg``), ``Fm``, ``KMeans``, the column
scalers (``StandardScaler``, ``MinMaxScaler``, ``MaxAbsScaler``,
``Imputer``) and the NLP ones (``DocCountVectorizer``,
``DocHashCountVectorizer``, ``Word2Vec``). A twin takes ``device=`` as
the port's entry points do (``cuda`` unless the caller asks for the CPU;
raises without CUDA) and hands it to a mapper that takes one (KMeans
assigns there); the other mappers map on the host, as their batch ops
do. With ``ALINK_TPU_SERVE_COMPILED`` on, a twin whose mapper has a
serving kernel (the linear, tree and FM ones) scores through
``CompiledPredictor`` on its device (``ModelMapStreamOp``'s compiled
route; FM's through the FM score kernel, ``kernels/fm.py``).

Waiting with their batch ops (ROADMAP A7(c)): ``NaiveBayesText``,
``NaiveBayes``, ``MultilayerPerceptron``, ``Glm``, ``IsotonicReg``,
``AftSurvivalReg``, ``Gmm``, ``BisectingKMeans``, the vector scalers and
imputer (``VectorStandardScaler``, ``VectorMinMaxScaler``,
``VectorMaxAbsScaler``, ``VectorImputer``), the indexers
(``StringIndexer``, ``MultiStringIndexer``, ``IndexToString``),
``OneHot``, ``QuantileDiscretizer`` and ``Pca``.
"""

from __future__ import annotations

import importlib
import inspect
from typing import Dict, Optional

from ...common.device import resolve_device
from ...common.params import Params
from ..base import BatchOperator
from .utils import ModelMapStreamOp

_BATCH_PREDICT_OPS = {
    # classification
    "LogisticRegressionPredictStreamOp": ("..batch.classification.linear", "LogisticRegressionPredictBatchOp"),
    "LinearSvmPredictStreamOp": ("..batch.classification.linear", "LinearSvmPredictBatchOp"),
    "SoftmaxPredictStreamOp": ("..batch.classification.linear", "SoftmaxPredictBatchOp"),
    "PerceptronPredictStreamOp": ("..batch.classification.linear", "PerceptronPredictBatchOp"),
    "GbdtPredictStreamOp": ("..batch.classification.tree_ops", "GbdtPredictBatchOp"),
    "GbdtRegPredictStreamOp": ("..batch.classification.tree_ops", "GbdtRegPredictBatchOp"),
    "RandomForestPredictStreamOp": ("..batch.classification.tree_ops", "RandomForestPredictBatchOp"),
    "RandomForestRegPredictStreamOp": ("..batch.classification.tree_ops", "RandomForestRegPredictBatchOp"),
    "DecisionTreePredictStreamOp": ("..batch.classification.tree_ops", "DecisionTreePredictBatchOp"),
    "DecisionTreeRegPredictStreamOp": ("..batch.classification.tree_ops", "DecisionTreeRegPredictBatchOp"),
    "FmPredictStreamOp": ("..batch.classification.fm_ops", "FmPredictBatchOp"),
    # regression
    "LinearRegPredictStreamOp": ("..batch.regression.linear", "LinearRegPredictBatchOp"),
    "RidgeRegPredictStreamOp": ("..batch.regression.linear", "RidgeRegPredictBatchOp"),
    "LassoRegPredictStreamOp": ("..batch.regression.linear", "LassoRegPredictBatchOp"),
    "LinearSvrPredictStreamOp": ("..batch.regression.linear", "LinearSvrPredictBatchOp"),
    # clustering
    "KMeansPredictStreamOp": ("..batch.clustering.kmeans_ops", "KMeansPredictBatchOp"),
    # dataproc
    "StandardScalerPredictStreamOp": ("..batch.dataproc.scalers", "StandardScalerPredictBatchOp"),
    "MinMaxScalerPredictStreamOp": ("..batch.dataproc.scalers", "MinMaxScalerPredictBatchOp"),
    "MaxAbsScalerPredictStreamOp": ("..batch.dataproc.scalers", "MaxAbsScalerPredictBatchOp"),
    "ImputerPredictStreamOp": ("..batch.dataproc.scalers", "ImputerPredictBatchOp"),
    # nlp
    "DocCountVectorizerPredictStreamOp": ("..batch.nlp", "DocCountVectorizerPredictBatchOp"),
    "DocHashCountVectorizerPredictStreamOp": ("..batch.nlp", "DocHashCountVectorizerPredictBatchOp"),
    "Word2VecPredictStreamOp": ("..batch.nlp", "Word2VecPredictBatchOp"),
}

__all__ = sorted(_BATCH_PREDICT_OPS)


class PredictStreamOp(ModelMapStreamOp):
    """A generated twin: the batch op's mapper over every micro-batch,
    on ``device`` when the mapper takes one."""

    BATCH_CLS: Optional[type] = None

    def __init__(self, model_op: Optional[BatchOperator] = None,
                 params: Optional[Params] = None, device=None, **kwargs):
        super().__init__(model_op, params, **kwargs)
        self.device = resolve_device(device)

    def _open(self, in_schema):
        model_table = self._model_op.get_output_table()
        takes_device = "device" in inspect.signature(
            self.MAPPER_CLS.__init__).parameters
        self._mapper = self.MAPPER_CLS(
            model_table.schema, in_schema, self.params,
            **({"device": self.device} if takes_device else {}))
        self._mapper.load_model(model_table)
        self._open_predictor()
        return self._mapper.get_output_schema()


PREDICT_STREAM_OPS: Dict[str, type] = {}

for _name, (_module, _batch_name) in _BATCH_PREDICT_OPS.items():
    _bcls = getattr(importlib.import_module(_module, package=__package__),
                    _batch_name)
    PREDICT_STREAM_OPS[_name] = type(PredictStreamOp)(_name, (PredictStreamOp,), {
        "BATCH_CLS": _bcls, "MAPPER_CLS": _bcls.MAPPER_CLS,
        "_PARAM_INFOS": _bcls.param_infos(),
        "__doc__": f"Stream twin of {_batch_name} (reference stream predict "
                   f"op of the same family).",
        "__module__": __name__})

globals().update(PREDICT_STREAM_OPS)
