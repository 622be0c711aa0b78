"""Pipeline wrappers completing the reference inventory: ALS, GLM,
isotonic and AFT regression, GMM and bisecting KMeans, MLPC, the
indexers, the vector imputer and transformers, ``Select``, the
format-conversion transformers and the reference's base-class names.

Counterpart: ``alink_tpu/pipeline/extras.py`` (the reference's
pipeline/recommendation/ALS and ALSModel,
pipeline/regression/GeneralizedLinearRegression, IsotonicRegression and
AftSurvivalRegression, pipeline/clustering/GaussianMixture and
BisectingKMeans, pipeline/classification/MultilayerPerceptronClassifier,
pipeline/dataproc/format/*, pipeline/sql/Select,
pipeline/LocalPredictable.java, ModelExporterUtils.java and
pipeline/tuning/PipelineCandidates*). ``ALS`` trains
``AlsTrainBatchOp`` on its ``device`` (``cuda`` unless given
``device="cpu"``); ``ALSModel.transform`` rates (user, item) rows with
``AlsPredictBatchOp`` and ``recommend_top_k`` ranks items with
``AlsTopKPredictBatchOp``, both on the host. The six other estimators
(``_trainer_with_predict``) train on their ``device`` (and ``dtype``,
where the train op takes one), and their models map there where the
mapper computes on a device. ``MultiStringIndexer``, ``VectorImputer``,
``PCA`` / ``PCAModel`` (the reference's spelling of ``Pca``),
``IndexToString`` (a ``MapModel`` over a fitted StringIndexer's table),
the stateless vector transformers, ``Select`` and the
``FORMAT_TRANSFORMERS`` (one a pair op of ``FORMAT_OPS``, the triple
ops left out as there) run on the host.
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
from ..operator.batch.dataproc.format import FORMAT_OPS
from ..operator.batch.sql import SelectBatchOp
from .base import (Estimator, MapModel, Model, Pipeline, PipelineModel,
                   PipelineStage, Transformer, _as_op)
from .feature import BatchOpTransformer, Pca, PcaModel, _trainer
from .tuning import (BaseGridSearch, BaseTuningEvaluator, BaseTuningModel,
                     MultiClassClassificationTuningEvaluator, ParamGrid)

# -- reference base-class names --------------------------------------------

PipelineStageBase = PipelineStage
EstimatorBase = Estimator
TransformerBase = Transformer
ModelBase = Model
MapTransformer = BatchOpTransformer
BaseFormatTrans = BatchOpTransformer
BaseTuning = BaseGridSearch
TuningEvaluator = BaseTuningEvaluator
MulticlassClassificationTuningEvaluator = MultiClassClassificationTuningEvaluator


class LocalPredictable:
    """Marker mixin: stages that can serve embedded (reference
    pipeline/LocalPredictable.java). ``MapModel`` and ``PipelineModel``
    implement ``get_local_predictor``."""


class ModelExporterUtils:
    """Pipeline persistence helpers (reference pipeline/ModelExporterUtils.java
    :40-120; here the JSON stage list of PipelineModel.save / load)."""

    @staticmethod
    def save_pipeline_model(model: PipelineModel, path: str) -> None:
        model.save(path)

    @staticmethod
    def load_pipeline_model(path: str) -> PipelineModel:
        return PipelineModel.load(path)


GridSearchCVModel = BaseTuningModel
GridSearchTVSplitModel = BaseTuningModel


class PipelineCandidatesBase:
    """Enumerate (value-combo, grid-items, description) candidates
    (reference pipeline/tuning/PipelineCandidatesBase.java)."""

    def __init__(self, pipeline: Pipeline, grid: ParamGrid):
        self.pipeline = pipeline
        self.grid = grid

    def __iter__(self):
        import itertools
        items = self.grid.items if self.grid else []
        values = [vals for _, _, vals in items]
        for combo in (itertools.product(*values) if items else [()]):
            desc = ", ".join(f"{type(st).__name__}.{pi.name}={v}"
                             for (st, pi, _), v in zip(items, combo))
            yield combo, items, desc or "(defaults)"


class PipelineCandidatesGrid(PipelineCandidatesBase):
    """reference pipeline/tuning/PipelineCandidatesGrid.java"""


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
Select = _op_transformer("Select", SelectBatchOp)

# the format-conversion transformer matrix (reference pipeline/dataproc/format/
# ColumnsToCsv.java etc.); the Triple ops have no pipeline shells upstream
FORMAT_TRANSFORMERS = {}
for _bname, _bcls in FORMAT_OPS.items():
    if "Triple" in _bname or _bname.startswith(("Base", "Any")):
        continue
    _tname = _bname[: -len("BatchOp")]
    FORMAT_TRANSFORMERS[_tname] = _op_transformer(_tname, _bcls)
globals().update(FORMAT_TRANSFORMERS)

# reference names the tree models *ClassificationModel/*RegressionModel
from .fm_nb import FmClassifierModel as FmModel  # noqa: E402
from .tree import (  # noqa: E402
    DecisionTreeClassifierModel as DecisionTreeClassificationModel,
    DecisionTreeRegressorModel as DecisionTreeRegressionModel,
    GbdtClassifierModel as GbdtClassificationModel,
    GbdtRegressorModel as GbdtRegressionModel,
    RandomForestClassifierModel as RandomForestClassificationModel,
    RandomForestRegressorModel as RandomForestRegressionModel)
