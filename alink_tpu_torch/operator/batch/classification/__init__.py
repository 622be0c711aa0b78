"""Batch classification (and regression) operators of the port
(counterpart: ``alink_tpu/operator/batch/classification``). Only the
tree family is ported; the linear, FM, MLPC and naive Bayes trainers
wait for later slices."""

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
           "TreeModelData", "TreeModelDataConverter", "TreeModelMapper"]
