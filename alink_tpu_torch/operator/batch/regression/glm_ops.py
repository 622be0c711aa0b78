"""GLM, isotonic and AFT survival regression.

Counterpart: ``alink_tpu/operator/batch/regression/glm_ops.py`` (the
re-design of the reference's common/regression/glm/ (FamilyLink, the
families and links, IRLS), isotonicReg/ and AftSurvivalReg with
common/linear/AftRegObjFunc). The model tables are the JAX package's, so
a table saved by either package loads in the other.

* GLM: the five families and five links as torch functions, and IRLS on
  the one-worker BSP engine (``glm_irls``): the normal equations'
  ``X^T W X`` and ``X^T W z``, one ``AllReduce``, ``torch.linalg.solve``,
  and a stop when the relative change of beta drops below ``tol``. The
  train op takes ``device=`` and ``dtype=`` as the linear train ops do
  (the JAX package reads ``jax_enable_x64``); the mapper and the predict
  op take ``device=`` and apply the inverse link there in float64 (the
  linear predictor ``X @ beta`` stays host numpy, as there).
  ``GlmEvaluationBatchOp`` is host numpy.
* Isotonic regression: the JAX package's host pool-adjacent-violators
  (``pav``), a Python loop over the distinct x values, and ``np.interp``
  between its boundaries.
* AFT: the Weibull log-likelihood (``_AftObjFunc``) with its gradient from
  ``torch.autograd``, on the shared L-BFGS (``device=``, ``dtype=``); the
  mapper is host numpy, as there.
"""

from __future__ import annotations

import json
from typing import List, Optional

import numpy as np
import torch

from ....common.device import resolve_device
from ....common.mlenv import MLEnvironment
from ....common.mtable import MTable
from ....common.params import ParamInfo, Params
from ....common.types import AlinkTypes, TableSchema
from ....engine import AllReduce, IterativeComQueue
from ....engine.comqueue import freeze_config
from ....mapper.base import ModelMapper, OutputColsHelper
from ....model.converters import (SimpleModelDataConverter, decode_array,
                                  encode_array)
from ....params.shared import (HasEpsilonDefaultAs000001, HasFeatureCols,
                               HasLabelCol, HasMaxIterDefaultAs100,
                               HasPredictionCol, HasReservedCols, HasWeightCol)
from ...base import BatchOperator
from ...common.dataproc.feature_extract import resolve_feature_cols
from ...common.optim.objfunc import OptimObjFunc, check_full_float32
from ...common.optim.optimizers import OptimParams, optimize
from ..utils.model_map import (DeviceModelMapBatchOp, DeviceTrainBatchOp,
                               ModelMapBatchOp)

def _const(x, v: float):
    """``v`` in ``x``'s dtype and device (a JAX weak-typed constant)."""
    return torch.tensor(v, dtype=x.dtype, device=x.device)


# ---------------------------------------------------------------------------
# GLM family/link algebra (reference glm/famliy/*, glm/link/*)
# ---------------------------------------------------------------------------

class _Family:
    name = ""

    def variance(self, mu):
        raise NotImplementedError

    def default_link(self) -> str:
        return "Identity"

    def clip_mu(self, mu):
        return mu


class Gaussian(_Family):
    name = "Gaussian"

    def variance(self, mu):
        return torch.ones_like(mu)


class Binomial(_Family):
    name = "Binomial"

    def variance(self, mu):
        return mu * (1 - mu)

    def default_link(self):
        return "Logit"

    def clip_mu(self, mu):
        return torch.clamp(mu, 1e-10, 1 - 1e-10)


class Poisson(_Family):
    name = "Poisson"

    def variance(self, mu):
        return mu

    def default_link(self):
        return "Log"

    def clip_mu(self, mu):
        return torch.clamp(mu, min=1e-10)


class Gamma(_Family):
    name = "Gamma"

    def variance(self, mu):
        return mu ** 2

    def default_link(self):
        return "Inverse"

    def clip_mu(self, mu):
        return torch.clamp(mu, min=1e-10)


class Tweedie(_Family):
    name = "Tweedie"

    def __init__(self, variance_power=1.5):
        self.p = variance_power

    def variance(self, mu):
        return mu ** self.p

    def default_link(self):
        return "Log"

    def clip_mu(self, mu):
        return torch.clamp(mu, min=1e-10)


class _Link:
    name = ""

    def link(self, mu):
        raise NotImplementedError

    def unlink(self, eta):  # mu = g^-1(eta)
        raise NotImplementedError

    def derivative(self, mu):  # g'(mu)
        raise NotImplementedError


class Identity(_Link):
    name = "Identity"

    def link(self, mu):
        return mu

    def unlink(self, eta):
        return eta

    def derivative(self, mu):
        return torch.ones_like(mu)


class Log(_Link):
    name = "Log"

    def link(self, mu):
        return torch.log(mu)

    def unlink(self, eta):
        return torch.exp(torch.clamp(eta, -500, 500))

    def derivative(self, mu):
        return 1.0 / mu


class Logit(_Link):
    name = "Logit"

    def link(self, mu):
        return torch.log(mu / (1 - mu))

    def unlink(self, eta):
        return torch.sigmoid(eta)

    def derivative(self, mu):
        return 1.0 / (mu * (1 - mu))


class Inverse(_Link):
    name = "Inverse"

    def link(self, mu):
        return 1.0 / mu

    def unlink(self, eta):
        return 1.0 / torch.where(torch.abs(eta) < 1e-10, _const(eta, 1e-10),
                                 eta)

    def derivative(self, mu):
        return -1.0 / mu ** 2


class Sqrt(_Link):
    name = "Sqrt"

    def link(self, mu):
        return torch.sqrt(mu)

    def unlink(self, eta):
        return eta ** 2

    def derivative(self, mu):
        return 0.5 / torch.sqrt(mu)


FAMILIES = {"gaussian": Gaussian, "binomial": Binomial, "poisson": Poisson,
            "gamma": Gamma, "tweedie": Tweedie}
LINKS = {"identity": Identity, "log": Log, "logit": Logit, "inverse": Inverse,
         "sqrt": Sqrt}


def irls_normal(block, d: int, beta, family: _Family, link: _Link):
    """One IRLS pass over a ``(n, d + 2)`` block (features, label, row
    weight): ``{"A": X^T W X, "b": X^T W z}`` at ``beta``."""
    Xb, yb, wb = block[:, :d], block[:, d], block[:, d + 1]
    eta = Xb @ beta
    mu = family.clip_mu(link.unlink(eta))
    gp = link.derivative(mu)
    wt = wb / torch.clamp(family.variance(mu) * gp ** 2, min=1e-12)
    z = eta + (yb - mu) * gp
    XtW = (Xb * wt[:, None]).T
    return {"A": XtW @ Xb, "b": XtW @ z}


def irls_solve(normal, beta, reg: float):
    """The new beta and its relative change."""
    A = normal["A"]
    d = A.shape[0]
    A = A + (reg + 1e-10) * torch.eye(d, dtype=A.dtype, device=A.device)
    beta_new = torch.linalg.solve(A, normal["b"])
    delta = torch.linalg.vector_norm(beta_new - beta) / torch.clamp(
        torch.linalg.vector_norm(beta_new), min=1.0)
    return beta_new, delta


def glm_irls(X: np.ndarray, y: np.ndarray, w: np.ndarray, family: _Family,
             link: _Link, max_iter: int = 25, tol: float = 1e-6,
             reg: float = 0.0, env: Optional[MLEnvironment] = None):
    """IRLS on ``env``'s device in ``X``'s dtype; ``X`` already has the
    intercept column. Returns (beta, supersteps)."""
    n, d = X.shape
    data = np.concatenate([X, y[:, None], w[:, None]], 1).astype(X.dtype)

    def partials(ctx):
        block = ctx.get_obj("data")
        if ctx.is_entry_step:
            check_full_float32({"X": block})
        if ctx.is_init_step:
            ctx.put_obj("beta", block.new_zeros(d))
            ctx.put_obj("delta", _const(block, np.inf))
        ctx.put_obj("normal", irls_normal(block, d, ctx.get_obj("beta"),
                                          family, link))

    def solve(ctx):
        beta_new, delta = irls_solve(ctx.get_obj("normal"),
                                     ctx.get_obj("beta"), reg)
        ctx.put_obj("delta", delta)
        ctx.put_obj("beta", beta_new)

    res = (IterativeComQueue(env=env, max_iter=max_iter)
           .init_with_partitioned_data("data", data)
           .add(partials)
           .add(AllReduce("normal"))
           .add(solve)
           .set_compare_criterion(lambda ctx: ctx.get_obj("delta") < tol)
           .set_program_key(("glm_irls", d, str(X.dtype), float(tol),
                             float(reg), freeze_config(family),
                             freeze_config(link)))
           .exec())
    return res.get("beta"), res.step_count


class GlmModelConverter(SimpleModelDataConverter):
    def serialize_model(self, model):
        meta = Params({k: v for k, v in model.items() if k != "beta"})
        return meta, [encode_array(model["beta"])]

    def deserialize_model(self, meta, data):
        out = dict(meta._m)
        out["beta"] = decode_array(data[0])
        return out


class GlmTrainBatchOp(DeviceTrainBatchOp, HasLabelCol, HasFeatureCols,
                      HasWeightCol, HasMaxIterDefaultAs100,
                      HasEpsilonDefaultAs000001):
    """reference: batch/regression/GlmTrainBatchOp.java. IRLS on
    ``device`` (``cuda`` by default) in ``dtype``."""
    FAMILY = ParamInfo("family", str, default="Gaussian")
    LINK = ParamInfo("link", str, "link function; family default when unset")
    VARIANCE_POWER = ParamInfo("variance_power", float, default=1.5)
    REG_PARAM = ParamInfo("reg_param", float, default=0.0)
    FIT_INTERCEPT = ParamInfo("fit_intercept", bool, default=True)

    def link_from(self, in_op: BatchOperator) -> "GlmTrainBatchOp":
        t = in_op.get_output_table()
        dtype = self.np_dtype
        label_col = self.get_label_col()
        cols = resolve_feature_cols(t, self.params._m.get("feature_cols"),
                                    label_col)
        X = t.numeric_block(cols, dtype)
        if self.get_fit_intercept():
            X = np.concatenate([np.ones((X.shape[0], 1), dtype), X], 1)
        y = np.asarray(t.col(label_col), dtype)
        w = (np.asarray(t.col(self.params._m["weight_col"]), dtype)
             if self.params._m.get("weight_col") else np.ones(len(y), dtype))
        fam_name = self.get_family().lower()
        fam = (Tweedie(self.get_variance_power()) if fam_name == "tweedie"
               else FAMILIES[fam_name]())
        link_name = (self.params._m.get("link") or fam.default_link()).lower()
        link = LINKS[link_name]()
        beta, steps = glm_irls(X, y, w, fam, link, self.get_max_iter(),
                               self.get_epsilon(), self.get_reg_param(),
                               env=MLEnvironment(device=self.device))
        self._output = GlmModelConverter().save_model({
            "beta": np.asarray(beta, np.float64), "family": fam.name,
            "link": link.name, "feature_cols": cols,
            "fit_intercept": self.get_fit_intercept(),
            "variance_power": self.get_variance_power()})
        self._steps = steps
        return self


def _value_output(mapper, schema) -> OutputColsHelper:
    """The one DOUBLE prediction column after the reserved columns (the
    JAX package's mappers declare no output schema, so its stream twins
    of these families cannot open; the port's do)."""
    return OutputColsHelper(schema,
                            [mapper.params._m.get("prediction_col", "pred")],
                            [AlinkTypes.DOUBLE],
                            mapper.params._m.get("reserved_cols"))


def _design(m, data: MTable) -> np.ndarray:
    X = data.numeric_block(m["feature_cols"], np.float64)
    if m.get("fit_intercept", True):
        X = np.concatenate([np.ones((X.shape[0], 1)), X], 1)
    return X


class GlmModelMapper(ModelMapper):
    """Applies the inverse link on ``device`` (``cuda`` by default) in
    float64."""

    def __init__(self, model_schema, data_schema, params=None, device=None,
                 **kwargs):
        super().__init__(model_schema, data_schema, params, **kwargs)
        self.device = resolve_device(device)
        self.model = None

    def load_model(self, model_table: MTable):
        self.model = GlmModelConverter().load_model(model_table)

    def map_table(self, data: MTable) -> MTable:
        m = self.model
        eta = _design(m, data) @ m["beta"]
        link = LINKS[m["link"].lower()]()
        mu = link.unlink(torch.from_numpy(eta).to(self.device)).cpu().numpy()
        vals = [mu, eta] if self.params._m.get("link_pred_result_col") \
            else [mu]
        return self._output(data.schema).build_output(data, vals)

    def _output(self, schema) -> OutputColsHelper:
        cols = [self.params._m.get("prediction_col", "pred")]
        if self.params._m.get("link_pred_result_col"):
            cols.append(self.params._m["link_pred_result_col"])
        return OutputColsHelper(schema, cols, [AlinkTypes.DOUBLE] * len(cols),
                                self.params._m.get("reserved_cols"))

    def get_output_schema(self):
        return self._output(self.data_schema).get_output_schema()


class GlmPredictBatchOp(DeviceModelMapBatchOp, HasPredictionCol,
                        HasReservedCols):
    """Predicts on ``device`` (``cuda`` by default; raises without it)."""
    MAPPER_CLS = GlmModelMapper
    LINK_PRED_RESULT_COL = ParamInfo("link_pred_result_col", str)


def glm_deviance(y: np.ndarray, mu: np.ndarray, family: str) -> float:
    """The deviance of predictions ``mu`` of labels ``y`` (reference
    GlmEvaluationBatchOp); squared error for the gaussian and any other
    family."""
    eps = 1e-10
    if family == "poisson":
        dev = 2 * np.sum(np.where(y > 0, y * np.log(np.maximum(y, eps) /
                                                    np.maximum(mu, eps)), 0)
                         - (y - mu))
    elif family == "binomial":
        dev = -2 * np.sum(y * np.log(np.maximum(mu, eps))
                          + (1 - y) * np.log(np.maximum(1 - mu, eps)))
    elif family == "gamma":
        dev = 2 * np.sum(-np.log(np.maximum(y, eps) / np.maximum(mu, eps))
                         + (y - mu) / np.maximum(mu, eps))
    else:
        dev = float(((y - mu) ** 2).sum())
    return float(dev)


class GlmEvaluationBatchOp(BatchOperator, HasLabelCol):
    """reference: batch/regression/GlmEvaluationBatchOp — deviance stats."""
    PREDICTION_COL = ParamInfo("prediction_col", str, optional=False)
    FAMILY = ParamInfo("family", str, default="Gaussian")

    def link_from(self, in_op: BatchOperator) -> "GlmEvaluationBatchOp":
        t = in_op.get_output_table()
        y = np.asarray(t.col(self.get_label_col()), np.float64)
        mu = np.asarray(t.col(self.get_prediction_col()), np.float64)
        fam = self.get_family().lower()
        null_mu = y.mean()
        self._output = MTable([(json.dumps({
            "deviance": glm_deviance(y, mu, fam),
            "degreeOfFreedom": int(len(y) - 1),
            "aic": float("nan"),
            "nullDeviance": float(((y - null_mu) ** 2).sum())
            if fam == "gaussian" else float("nan")}),)],
            TableSchema(["summary"], [AlinkTypes.STRING]))
        return self


# ---------------------------------------------------------------------------
# Isotonic regression (host PAV)
# ---------------------------------------------------------------------------

class IsotonicModelConverter(SimpleModelDataConverter):
    def serialize_model(self, model):
        meta = Params({"feature_col": model["feature_col"],
                       "vector_col": model.get("vector_col"),
                       "feature_index": model.get("feature_index", 0)})
        return meta, [encode_array(model["boundaries"]),
                      encode_array(model["values"])]

    def deserialize_model(self, meta, data):
        return {"feature_col": meta._m.get("feature_col"),
                "vector_col": meta._m.get("vector_col"),
                "feature_index": meta._m.get("feature_index", 0),
                "boundaries": decode_array(data[0]), "values": decode_array(data[1])}


def pav(x: np.ndarray, y: np.ndarray, w: np.ndarray):
    """Pool-adjacent-violators (reference isotonicReg/ PAV).

    Each pooled block keeps BOTH its x-extent endpoints so the fitted
    function is flat across a block and linear only between blocks — the
    reference/Spark-ML boundary semantics (a single representative per
    block would turn constant segments into ramps under interpolation).
    """
    order = np.argsort(x, kind="mergesort")
    xs, ys, ws = x[order], y[order].astype(np.float64), w[order].astype(np.float64)
    # pool tied x first (weighted mean), as the reference/Spark do —
    # otherwise duplicate boundaries make the fitted function ill-defined
    # at tied points
    xs, first = np.unique(xs, return_index=True)
    seg = np.repeat(np.arange(len(first)),
                    np.diff(np.append(first, len(ys))))
    wsum = np.bincount(seg, ws)
    ys = np.bincount(seg, ws * ys) / wsum
    ws = wsum
    # blocks of [x_min, x_max, value, weight]
    blocks: List[List[float]] = []
    for xi, yi, wi in zip(xs, ys, ws):
        blocks.append([xi, xi, yi, wi])
        while len(blocks) > 1 and blocks[-2][2] > blocks[-1][2]:
            b2 = blocks.pop()
            b1 = blocks[-1]
            tot = b1[3] + b2[3]
            b1[2] = (b1[2] * b1[3] + b2[2] * b2[3]) / tot
            b1[1] = b2[1]
            b1[3] = tot
    bx: List[float] = []
    bv: List[float] = []
    for xmin, xmax, v, _ in blocks:
        if not bx or bx[-1] != xmin or bv[-1] != v:
            bx.append(xmin)
            bv.append(v)
        if xmax != xmin:
            bx.append(xmax)
            bv.append(v)
    return np.asarray(bx), np.asarray(bv)


class IsotonicRegTrainBatchOp(BatchOperator, HasLabelCol, HasWeightCol):
    """reference: batch/regression/IsotonicRegTrainBatchOp.java"""
    FEATURE_COL = ParamInfo("feature_col", str, optional=False)

    def link_from(self, in_op: BatchOperator) -> "IsotonicRegTrainBatchOp":
        t = in_op.get_output_table()
        x = np.asarray(t.col(self.get_feature_col()), np.float64)
        y = np.asarray(t.col(self.get_label_col()), np.float64)
        w = (np.asarray(t.col(self.params._m["weight_col"]), np.float64)
             if self.params._m.get("weight_col") else np.ones(len(y)))
        bx, bv = pav(x, y, w)
        self._output = IsotonicModelConverter().save_model({
            "feature_col": self.get_feature_col(), "boundaries": bx, "values": bv})
        return self


class IsotonicModelMapper(ModelMapper):
    def __init__(self, model_schema, data_schema, params=None, **kwargs):
        super().__init__(model_schema, data_schema, params, **kwargs)
        self.model = None

    def load_model(self, model_table: MTable):
        self.model = IsotonicModelConverter().load_model(model_table)

    def map_table(self, data: MTable) -> MTable:
        m = self.model
        x = np.asarray(data.col(m["feature_col"]), np.float64)
        # linear interpolation between boundaries (reference behavior)
        preds = np.interp(x, m["boundaries"], m["values"])
        return _value_output(self, data.schema).build_output(data, [preds])

    def get_output_schema(self):
        return _value_output(self, self.data_schema).get_output_schema()


class IsotonicRegPredictBatchOp(ModelMapBatchOp, HasPredictionCol, HasReservedCols):
    MAPPER_CLS = IsotonicModelMapper


# ---------------------------------------------------------------------------
# AFT survival regression (Weibull, autograd on the L-BFGS stack)
# ---------------------------------------------------------------------------

class _AftObjFunc(OptimObjFunc):
    """Weibull AFT log-likelihood (reference common/linear/AftRegObjFunc.java).

    coef = [beta (d,), log_sigma]; data carries y = log(time), and the
    censor indicator rides the extra column "c" (1 = event, 0 = censored).
    The gradient comes from ``torch.autograd``; the line search's losses
    are computed under ``torch.no_grad()``, one pass a step.
    """

    def __init__(self, d: int, l1=0.0, l2=0.0):
        super().__init__(d + 1, l1, l2)
        self.d = d

    def _nll_sum(self, coef, X, logt, c, w):
        beta, log_sigma = coef[:self.d], coef[self.d]
        sigma = torch.exp(log_sigma)
        eps = (logt - X @ beta) / sigma
        # event: log f = eps - e^eps - log sigma ; censored: log S = -e^eps
        log_f = eps - torch.exp(eps) - log_sigma
        log_s = -torch.exp(eps)
        return -(w * torch.where(c > 0, log_f, log_s)).sum()

    def calc_grad_shard(self, data, coef):
        X, y, w, c = data["X"], data["y"], data["w"], data["c"]
        with torch.enable_grad():
            leaf = coef.detach().requires_grad_(True)
            loss = self._nll_sum(leaf, X, y, c, w)
            grad, = torch.autograd.grad(loss, leaf)
        return grad, loss.detach(), w.sum()

    def line_losses_shard(self, data, coef, direction, steps, eta0=None):
        X, y, w, c = data["X"], data["y"], data["w"], data["c"]
        with torch.no_grad():
            return torch.stack([self._nll_sum(coef - s * direction, X, y, c, w)
                                for s in steps])


class AftSurvivalRegTrainBatchOp(DeviceTrainBatchOp, HasFeatureCols, HasLabelCol,
                                 HasMaxIterDefaultAs100,
                                 HasEpsilonDefaultAs000001):
    """reference: batch/regression/AftSurvivalRegTrainBatchOp.java. L-BFGS
    on ``device`` (``cuda`` by default) in ``dtype``; the side output is
    the loss curve (``iter``, ``loss``)."""
    CENSOR_COL = ParamInfo("censor_col", str, optional=False)
    WITH_INTERCEPT = ParamInfo("with_intercept", bool, default=True)

    def link_from(self, in_op: BatchOperator) -> "AftSurvivalRegTrainBatchOp":
        t = in_op.get_output_table()
        dtype = self.np_dtype
        label_col = self.get_label_col()
        cols = resolve_feature_cols(t, self.params._m.get("feature_cols"),
                                    label_col, exclude=[self.get_censor_col()])
        X = t.numeric_block(cols, dtype)
        if self.get_with_intercept():
            X = np.concatenate([np.ones((X.shape[0], 1), dtype), X], 1)
        time = np.asarray(t.col(label_col), dtype)
        c = np.asarray(t.col(self.get_censor_col()), dtype)
        obj = _AftObjFunc(X.shape[1])
        data = {"X": X, "y": np.log(np.maximum(time, 1e-12)),
                "w": np.ones(len(time), dtype), "c": c}
        coef, curve, steps = optimize(
            obj, data, OptimParams(method="LBFGS",
                                   max_iter=self.get_max_iter(),
                                   epsilon=self.get_epsilon()),
            MLEnvironment(device=self.device))
        self._output = GlmModelConverter().save_model({
            "beta": np.asarray(coef, np.float64), "family": "AFT",
            "link": "Log", "feature_cols": cols,
            "fit_intercept": self.get_with_intercept()})
        self._side_outputs = [MTable({"iter": np.arange(1, len(curve) + 1),
                                      "loss": np.asarray(curve, np.float64)})]
        self._steps = steps
        return self


class AftModelMapper(ModelMapper):
    def __init__(self, model_schema, data_schema, params=None, **kwargs):
        super().__init__(model_schema, data_schema, params, **kwargs)
        self.model = None

    def load_model(self, model_table: MTable):
        self.model = GlmModelConverter().load_model(model_table)

    def map_table(self, data: MTable) -> MTable:
        m = self.model
        beta = m["beta"][:-1]
        preds = np.exp(_design(m, data) @ beta)   # median-ish survival time scale
        return _value_output(self, data.schema).build_output(data, [preds])

    def get_output_schema(self):
        return _value_output(self, self.data_schema).get_output_schema()


class AftSurvivalRegPredictBatchOp(ModelMapBatchOp, HasPredictionCol,
                                   HasReservedCols):
    MAPPER_CLS = AftModelMapper
