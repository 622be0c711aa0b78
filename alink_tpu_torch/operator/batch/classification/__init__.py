"""Batch classification (and tree regression) operators of the port
(counterpart: ``alink_tpu/operator/batch/classification``). The tree
family, the linear classifiers (logistic regression, linear SVM,
Softmax, the perceptron), FM, naive Bayes (text and mixed columns) and the
multilayer perceptron are ported."""

from .fm_ops import (BaseFmTrainBatchOp, FmClassifierPredictBatchOp,
                     FmClassifierTrainBatchOp, FmModelData,
                     FmModelDataConverter, FmModelInfo, FmModelInfoBatchOp,
                     FmModelMapper, FmPredictBatchOp,
                     FmRegressorPredictBatchOp, FmRegressorTrainBatchOp)

from .mlpc_ops import (MlpModelConverter, MlpModelMapper,
                       MultilayerPerceptronPredictBatchOp,
                       MultilayerPerceptronTrainBatchOp)
from .naive_bayes import (NaiveBayesModelConverter, NaiveBayesModelMapper,
                          NaiveBayesPredictBatchOp,
                          NaiveBayesTextModelConverter,
                          NaiveBayesTextModelMapper,
                          NaiveBayesTextPredictBatchOp,
                          NaiveBayesTextTrainBatchOp, NaiveBayesTrainBatchOp)

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
           "FmModelInfoBatchOp", "FmModelMapper",
           "NaiveBayesTextTrainBatchOp", "NaiveBayesTextPredictBatchOp",
           "NaiveBayesTextModelConverter", "NaiveBayesTextModelMapper",
           "NaiveBayesTrainBatchOp", "NaiveBayesPredictBatchOp",
           "NaiveBayesModelConverter", "NaiveBayesModelMapper",
           "MultilayerPerceptronTrainBatchOp",
           "MultilayerPerceptronPredictBatchOp", "MlpModelConverter",
           "MlpModelMapper"]
