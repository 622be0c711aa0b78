"""Pipeline wrappers completing the reference inventory: ALS, GLM,
isotonic and AFT regression, GMM and bisecting KMeans, MLPC, the
indexers, the vector imputer and transformers.

Counterpart: ``alink_tpu/pipeline/extras.py`` (:131-148 and :170-249, the
reference's pipeline/recommendation/ALS and ALSModel,
pipeline/regression/GeneralizedLinearRegression, IsotonicRegression and
AftSurvivalRegression, pipeline/clustering/GaussianMixture and
BisectingKMeans, pipeline/classification/MultilayerPerceptronClassifier).
``ALS`` trains ``AlsTrainBatchOp`` on its ``device`` (``cuda`` unless
given ``device="cpu"``); ``ALSModel.transform`` rates (user, item) rows
with ``AlsPredictBatchOp`` and ``recommend_top_k`` ranks items with
``AlsTopKPredictBatchOp``, both on the host. The six other estimators
(``_trainer_with_predict``) train on their ``device`` (and ``dtype``,
where the train op takes one), and their models map there where the
mapper computes on a device. ``MultiStringIndexer``, ``VectorImputer``,
``PCA`` / ``PCAModel`` (the reference's spelling of ``Pca``),
``IndexToString`` (a ``MapModel`` over a fitted StringIndexer's table)
and the stateless ``VectorSlicer``, ``VectorInteraction``,
``VectorElementwiseProduct``, ``VectorPolynomialExpand`` and
``VectorSizeHint`` run on the host. The rest of the JAX package's module
(the format transformers, ``Select`` and the reference's base-class
names) waits for its ops (ROADMAP A7(c)).
"""

from __future__ import annotations

from ..operator.base import BatchOperator, TableSourceBatchOp
from ..operator.batch.classification.mlpc_ops import (
    MlpModelMapper, MultilayerPerceptronPredictBatchOp,
    MultilayerPerceptronTrainBatchOp)
from ..operator.batch.clustering.gmm_bisecting import (
    BisectingKMeansPredictBatchOp, BisectingKMeansTrainBatchOp,
    GmmModelMapper, GmmPredictBatchOp, GmmTrainBatchOp)
from ..operator.batch.clustering.kmeans_ops import KMeansModelMapper
from ..operator.batch.dataproc.indexers import (
    IndexToStringModelMapper, MultiStringIndexerPredictBatchOp,
    MultiStringIndexerTrainBatchOp, StringIndexerModelMapper)
from ..operator.batch.dataproc.vector_ops import (
    VectorElementwiseProductBatchOp, VectorImputerModelMapper,
    VectorImputerPredictBatchOp, VectorImputerTrainBatchOp,
    VectorInteractionBatchOp, VectorPolynomialExpandBatchOp,
    VectorSizeHintBatchOp, VectorSliceBatchOp)
from ..operator.batch.recommendation.als_ops import (AlsPredictBatchOp,
                                                     AlsTopKPredictBatchOp,
                                                     AlsTrainBatchOp)
from ..operator.batch.regression.glm_ops import (
    AftModelMapper, AftSurvivalRegPredictBatchOp, AftSurvivalRegTrainBatchOp,
    GlmModelMapper, GlmPredictBatchOp, GlmTrainBatchOp, IsotonicModelMapper,
    IsotonicRegPredictBatchOp, IsotonicRegTrainBatchOp)
from .base import Estimator, MapModel, Model, _as_op
from .feature import BatchOpTransformer, Pca, PcaModel, _trainer


class ALSModel(Model):
    """Fitted ALS factors (reference pipeline/recommendation/ALSModel)."""

    _PARAM_INFOS = {**AlsTrainBatchOp._PARAM_INFOS,
                    **AlsPredictBatchOp._PARAM_INFOS}

    def transform(self, in_op) -> BatchOperator:
        op = AlsPredictBatchOp(self.params.clone())
        return op.link_from(TableSourceBatchOp(self.get_model_data()),
                            _as_op(in_op))

    def recommend_top_k(self, in_op, k: int = 10) -> BatchOperator:
        op = AlsTopKPredictBatchOp(self.params.clone(), top_k=k)
        return op.link_from(TableSourceBatchOp(self.get_model_data()),
                            _as_op(in_op))


class ALS(Estimator):
    """reference pipeline/recommendation/ALS.java"""

    _PARAM_INFOS = dict(ALSModel._PARAM_INFOS)

    def fit(self, in_op) -> ALSModel:
        train = AlsTrainBatchOp(self.params.clone(), device=self.device)
        train.link_from(_as_op(in_op))
        model = ALSModel(self.params.clone(), device=self.device)
        model.set_model_data(train.get_output_table())
        return model


# -- remaining trainer/model pairs -----------------------------------------

def _trainer_with_predict(name, train_op, mapper, predict_op):
    """_trainer + the predict op's params (prediction/output/reserved cols)
    so kwargs validation accepts them on the estimator and the model."""
    cls, model_cls = _trainer(name, train_op, mapper)
    for c in (cls, model_cls):
        c._PARAM_INFOS = {**c._PARAM_INFOS, **predict_op._PARAM_INFOS}
    return cls, model_cls


GaussianMixture, GaussianMixtureModel = _trainer_with_predict(
    "GaussianMixture", GmmTrainBatchOp, GmmModelMapper, GmmPredictBatchOp)
BisectingKMeans, BisectingKMeansModel = _trainer_with_predict(
    "BisectingKMeans", BisectingKMeansTrainBatchOp, KMeansModelMapper,
    BisectingKMeansPredictBatchOp)
GeneralizedLinearRegression, GeneralizedLinearRegressionModel = _trainer_with_predict(
    "GeneralizedLinearRegression", GlmTrainBatchOp, GlmModelMapper,
    GlmPredictBatchOp)
IsotonicRegression, IsotonicRegressionModel = _trainer_with_predict(
    "IsotonicRegression", IsotonicRegTrainBatchOp, IsotonicModelMapper,
    IsotonicRegPredictBatchOp)
AftSurvivalRegression, AftSurvivalRegressionModel = _trainer_with_predict(
    "AftSurvivalRegression", AftSurvivalRegTrainBatchOp, AftModelMapper,
    AftSurvivalRegPredictBatchOp)
MultilayerPerceptronClassifier, MultilayerPerceptronClassificationModel = \
    _trainer_with_predict(
        "MultilayerPerceptronClassifier", MultilayerPerceptronTrainBatchOp,
        MlpModelMapper, MultilayerPerceptronPredictBatchOp)
MultiStringIndexer, MultiStringIndexerModel = _trainer_with_predict(
    "MultiStringIndexer", MultiStringIndexerTrainBatchOp,
    StringIndexerModelMapper, MultiStringIndexerPredictBatchOp)
VectorImputer, VectorImputerModel = _trainer_with_predict(
    "VectorImputer", VectorImputerTrainBatchOp, VectorImputerModelMapper,
    VectorImputerPredictBatchOp)

# reference spells PCA in caps
PCA = Pca
PCAModel = PcaModel


class IndexToString(MapModel):
    """Map indices back to labels with a fitted StringIndexer model
    (reference pipeline/dataproc/IndexToString.java — takes the
    StringIndexerModel's data)."""

    MAPPER_CLS = IndexToStringModelMapper


# -- stateless transformers -------------------------------------------------

def _op_transformer(name: str, op_cls) -> type:
    return type(BatchOpTransformer)(
        name, (BatchOpTransformer,),
        {"OP_CLS": op_cls, "_PARAM_INFOS": dict(op_cls._PARAM_INFOS),
         "__doc__": f"pipeline transformer over {op_cls.__name__} "
                    f"(reference pipeline class of the same name)",
         "__module__": __name__})


VectorSlicer = _op_transformer("VectorSlicer", VectorSliceBatchOp)
VectorInteraction = _op_transformer("VectorInteraction", VectorInteractionBatchOp)
VectorElementwiseProduct = _op_transformer("VectorElementwiseProduct",
                                           VectorElementwiseProductBatchOp)
VectorPolynomialExpand = _op_transformer("VectorPolynomialExpand",
                                         VectorPolynomialExpandBatchOp)
VectorSizeHint = _op_transformer("VectorSizeHint", VectorSizeHintBatchOp)
