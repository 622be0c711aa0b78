"""Batch classification (and tree regression) operators of the port
(counterpart: ``alink_tpu/operator/batch/classification``). The tree
family, the linear classifiers (logistic regression, linear SVM,
Softmax, the perceptron) and FM are ported; MLPC and naive Bayes wait for
later slices."""

from .fm_ops import (BaseFmTrainBatchOp, FmClassifierPredictBatchOp,
                     FmClassifierTrainBatchOp, FmModelData,
                     FmModelDataConverter, FmModelInfo, FmModelInfoBatchOp,
                     FmModelMapper, FmPredictBatchOp,
                     FmRegressorPredictBatchOp, FmRegressorTrainBatchOp)

from .linear import (BaseLinearTrainBatchOp, LinearModelPredictBatchOp,
                     LinearSvmPredictBatchOp, LinearSvmTrainBatchOp,
                     LogisticRegressionPredictBatchOp,
                     LogisticRegressionTrainBatchOp,
                     PerceptronPredictBatchOp, PerceptronTrainBatchOp,
                     SoftmaxPredictBatchOp, SoftmaxTrainBatchOp)

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
           "LinearModelPredictBatchOp", "LogisticRegressionPredictBatchOp",
           "LinearSvmTrainBatchOp", "LinearSvmPredictBatchOp",
           "SoftmaxTrainBatchOp", "SoftmaxPredictBatchOp",
           "PerceptronTrainBatchOp", "PerceptronPredictBatchOp",
           "BaseFmTrainBatchOp", "FmClassifierTrainBatchOp",
           "FmRegressorTrainBatchOp", "FmPredictBatchOp",
           "FmClassifierPredictBatchOp", "FmRegressorPredictBatchOp",
           "FmModelData", "FmModelDataConverter", "FmModelInfo",
           "FmModelInfoBatchOp", "FmModelMapper"]
