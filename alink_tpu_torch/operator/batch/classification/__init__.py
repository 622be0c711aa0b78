"""Batch classification (and regression) operators of the port
(counterpart: ``alink_tpu/operator/batch/classification``). The tree
family and logistic regression are ported; the other linear trainers,
FM, MLPC and naive Bayes wait for later slices."""

from .linear import (BaseLinearTrainBatchOp, LinearModelPredictBatchOp,
                     LogisticRegressionPredictBatchOp,
                     LogisticRegressionTrainBatchOp)

from .tree_ops import (DecisionTreePredictBatchOp, DecisionTreeRegPredictBatchOp,
                       DecisionTreeRegTrainBatchOp, DecisionTreeTrainBatchOp,
                       GbdtPredictBatchOp, GbdtRegPredictBatchOp,
                       GbdtRegTrainBatchOp, GbdtTrainBatchOp,
                       RandomForestPredictBatchOp,
                       RandomForestRegPredictBatchOp,
                       RandomForestRegTrainBatchOp, RandomForestTrainBatchOp,
                       TreeModelData, TreeModelDataConverter, TreeModelMapper)

__all__ = ["GbdtTrainBatchOp", "GbdtRegTrainBatchOp",
           "RandomForestTrainBatchOp", "RandomForestRegTrainBatchOp",
           "DecisionTreeTrainBatchOp", "DecisionTreeRegTrainBatchOp",
           "GbdtPredictBatchOp", "GbdtRegPredictBatchOp",
           "RandomForestPredictBatchOp", "RandomForestRegPredictBatchOp",
           "DecisionTreePredictBatchOp", "DecisionTreeRegPredictBatchOp",
           "TreeModelData", "TreeModelDataConverter", "TreeModelMapper",
           "BaseLinearTrainBatchOp", "LogisticRegressionTrainBatchOp",
           "LinearModelPredictBatchOp", "LogisticRegressionPredictBatchOp"]
