"""The Pipeline API of the port (counterpart: ``alink_tpu/pipeline``).
Ported: ``base.py``, ``feature.py`` (the feature, indexer, PCA, DCT and
scaler wrappers),
the linear classifiers of ``classification.py``, ``regression.py``,
KMeans and LDA of ``clustering.py``, the trees of ``tree.py``, ALS, GLM,
isotonic and AFT regression, GMM, bisecting KMeans, MLPC, the indexers,
the vector imputer and transformers, ``Select``, the format
transformers and the reference's base-class names of ``extras.py``, FM,
naive Bayes and OneVsRest of ``fm_nb.py``, the NLP stages of ``nlp.py``
and the grid searches of ``tuning.py`` (``ParamGrid``, ``GridSearchCV``,
``GridSearchTVSplit``, the four tuning evaluators, ``Report``): every
module of the JAX package's pipeline."""

from .base import (Estimator, LocalPredictor, MapModel, Model, Pipeline,
                   PipelineModel, PipelineStage, Trainer, Transformer)
from . import (classification, clustering, extras, feature, fm_nb, nlp,
               regression, tree, tuning)
from .extras import (ALS, AftSurvivalRegression, AftSurvivalRegressionModel,
                     ALSModel, BisectingKMeans, BisectingKMeansModel,
                     GaussianMixture, GaussianMixtureModel,
                     GeneralizedLinearRegression,
                     GeneralizedLinearRegressionModel, IsotonicRegression,
                     IsotonicRegressionModel,
                     IndexToString, MultilayerPerceptronClassificationModel,
                     MultilayerPerceptronClassifier, MultiStringIndexer,
                     MultiStringIndexerModel, PCA, PCAModel,
                     VectorElementwiseProduct, VectorImputer,
                     VectorImputerModel, VectorInteraction,
                     VectorPolynomialExpand, VectorSizeHint, VectorSlicer,
                     Select)
from .feature import (DCT, Binarizer, Bucketizer, FeatureHasher, Imputer,
                      ImputerModel, MaxAbsScaler, MaxAbsScalerModel,
                      MinMaxScaler, MinMaxScalerModel, OneHotEncoder,
                      OneHotEncoderModel, Pca, PcaModel, QuantileDiscretizer,
                      QuantileDiscretizerModel, StandardScaler,
                      StandardScalerModel, StringIndexer, StringIndexerModel,
                      VectorAssembler, VectorMaxAbsScaler,
                      VectorMaxAbsScalerModel, VectorMinMaxScaler,
                      VectorMinMaxScalerModel, VectorNormalizer,
                      VectorStandardScaler, VectorStandardScalerModel)
from .fm_nb import (NaiveBayes, NaiveBayesModel, NaiveBayesTextClassifier,
                    NaiveBayesTextModel)
from .nlp import Segment
from .tuning import (BinaryClassificationTuningEvaluator,
                     ClusterTuningEvaluator, GridSearchCV, GridSearchTVSplit,
                     MultiClassClassificationTuningEvaluator, ParamGrid,
                     RegressionTuningEvaluator, Report)

__all__ = ["ALS", "ALSModel", "Estimator", "LocalPredictor", "MapModel", "Model", "Pipeline",
           "PipelineModel", "PipelineStage", "Trainer", "Transformer",
           "classification", "clustering", "extras", "feature", "fm_nb",
           "nlp", "regression", "tree", "tuning", "ParamGrid",
           "GridSearchCV", "GridSearchTVSplit",
           "BinaryClassificationTuningEvaluator",
           "MultiClassClassificationTuningEvaluator",
           "RegressionTuningEvaluator", "ClusterTuningEvaluator", "Report",
           "GaussianMixture", "GaussianMixtureModel", "BisectingKMeans",
           "BisectingKMeansModel", "GeneralizedLinearRegression",
           "GeneralizedLinearRegressionModel", "IsotonicRegression",
           "IsotonicRegressionModel", "AftSurvivalRegression",
           "AftSurvivalRegressionModel", "MultilayerPerceptronClassifier",
           "MultilayerPerceptronClassificationModel",
           "NaiveBayesTextClassifier", "NaiveBayesTextModel", "NaiveBayes",
           "NaiveBayesModel", "Segment", "IndexToString",
           "MultiStringIndexer", "MultiStringIndexerModel", "PCA",
           "PCAModel", "VectorElementwiseProduct", "VectorImputer",
           "VectorImputerModel", "VectorInteraction",
           "VectorPolynomialExpand", "VectorSizeHint", "VectorSlicer", "Select",
           "DCT",
           "Binarizer", "Bucketizer", "FeatureHasher", "Imputer",
           "ImputerModel", "MaxAbsScaler", "MaxAbsScalerModel",
           "MinMaxScaler", "MinMaxScalerModel", "OneHotEncoder",
           "OneHotEncoderModel", "Pca", "PcaModel", "QuantileDiscretizer",
           "QuantileDiscretizerModel", "StandardScaler",
           "StandardScalerModel", "StringIndexer", "StringIndexerModel",
           "VectorAssembler", "VectorMaxAbsScaler", "VectorMaxAbsScalerModel",
           "VectorMinMaxScaler", "VectorMinMaxScalerModel",
           "VectorNormalizer", "VectorStandardScaler",
           "VectorStandardScalerModel"]
