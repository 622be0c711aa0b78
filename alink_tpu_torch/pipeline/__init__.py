"""The Pipeline API of the port (counterpart: ``alink_tpu/pipeline``).
Ported: ``base.py``, the feature and scaler wrappers of ``feature.py``,
the linear classifiers of ``classification.py``, ``regression.py``,
KMeans and LDA of ``clustering.py``, the trees of ``tree.py``, ALS, GLM,
isotonic and AFT regression, GMM, bisecting KMeans and MLPC of
``extras.py``, FM, naive Bayes and OneVsRest of ``fm_nb.py``, the NLP stages of
``nlp.py`` and the grid searches of ``tuning.py`` (``ParamGrid``,
``GridSearchCV``, ``GridSearchTVSplit``, the four tuning evaluators,
``Report``). The other wrapper modules wait for their ops."""

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
                     MultilayerPerceptronClassificationModel,
                     MultilayerPerceptronClassifier)
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
           "NaiveBayesModel", "Segment"]
