"""Pipeline wrappers: the tree family.

Counterpart: ``alink_tpu/pipeline/tree.py`` (the reference's
pipeline/classification and pipeline/regression tree shells):
``GbdtClassifier``, ``GbdtRegressor``, ``RandomForestClassifier``,
``RandomForestRegressor``, ``DecisionTreeClassifier`` and
``DecisionTreeRegressor``, each with its model. The estimator trains on
``cuda`` unless given ``device=`` (``Trainer.fit``); the model maps
through ``TreeModelMapper`` on the host. ``_wrap`` is a copy of the JAX
package's ``pipeline/fm_nb.py::_wrap``, whose module waits for its ops.
"""

from ..operator.batch.classification.tree_ops import (
    DecisionTreeRegTrainBatchOp, DecisionTreeTrainBatchOp, GbdtRegTrainBatchOp,
    GbdtTrainBatchOp, RandomForestRegTrainBatchOp, RandomForestTrainBatchOp,
    TreeModelMapper)
from ..params.shared import (HasPredictionCol, HasPredictionDetailCol,
                             HasReservedCols)
from .base import MapModel, Trainer, caller_module


def _wrap(name, train_op, mapper):
    """An estimator ``name`` over ``train_op`` and its ``name + "Model"``
    over ``mapper``, both carrying the train op's params and the predict
    columns, minted in the caller's module."""
    mod = caller_module()
    model_cls = type(name + "Model", (MapModel,),
                     {"MAPPER_CLS": mapper, "__module__": mod})
    cls = type(name, (Trainer,), {"TRAIN_OP_CLS": train_op,
                                  "MODEL_CLS": model_cls, "__module__": mod})
    extra = {i.name: i for i in (HasPredictionCol.PREDICTION_COL,
                                 HasPredictionDetailCol.PREDICTION_DETAIL_COL,
                                 HasReservedCols.RESERVED_COLS)}
    cls._PARAM_INFOS = {**train_op._PARAM_INFOS, **extra, **cls._PARAM_INFOS}
    model_cls._PARAM_INFOS = dict(cls._PARAM_INFOS)
    return cls, model_cls


GbdtClassifier, GbdtClassifierModel = _wrap("GbdtClassifier", GbdtTrainBatchOp,
                                            TreeModelMapper)
GbdtRegressor, GbdtRegressorModel = _wrap("GbdtRegressor", GbdtRegTrainBatchOp,
                                          TreeModelMapper)
RandomForestClassifier, RandomForestClassifierModel = _wrap(
    "RandomForestClassifier", RandomForestTrainBatchOp, TreeModelMapper)
RandomForestRegressor, RandomForestRegressorModel = _wrap(
    "RandomForestRegressor", RandomForestRegTrainBatchOp, TreeModelMapper)
DecisionTreeClassifier, DecisionTreeClassifierModel = _wrap(
    "DecisionTreeClassifier", DecisionTreeTrainBatchOp, TreeModelMapper)
DecisionTreeRegressor, DecisionTreeRegressorModel = _wrap(
    "DecisionTreeRegressor", DecisionTreeRegTrainBatchOp, TreeModelMapper)
