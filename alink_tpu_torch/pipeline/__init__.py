"""The Pipeline API of the port (counterpart: ``alink_tpu/pipeline``).
Ported: ``base.py``, the feature and scaler wrappers of ``feature.py``,
the linear classifiers of ``classification.py``, ``regression.py``,
KMeans and LDA of ``clustering.py``, the trees of ``tree.py``, ALS of
``extras.py``, FM and OneVsRest of ``fm_nb.py`` and the NLP stages of
``nlp.py``. The tuning and other wrapper modules wait for their ops."""

from .base import (Estimator, LocalPredictor, MapModel, Model, Pipeline,
                   PipelineModel, PipelineStage, Trainer, Transformer)
from . import (classification, clustering, extras, feature, fm_nb, nlp,
               regression, tree)
from .extras import ALS, ALSModel

__all__ = ["ALS", "ALSModel", "Estimator", "LocalPredictor", "MapModel", "Model", "Pipeline",
           "PipelineModel", "PipelineStage", "Trainer", "Transformer",
           "classification", "clustering", "extras", "feature", "fm_nb",
           "nlp", "regression", "tree"]
