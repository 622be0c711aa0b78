"""Hyper-parameter tuning — GridSearchCV / GridSearchTVSplit.

Counterpart: ``alink_tpu/pipeline/tuning.py`` (re-design of the
reference's pipeline/tuning/: BaseTuning.java ``findBestCV`` :175,
``kFoldCv`` :239-300, ``split`` :340; ParamGrid.java,
{Binary,Multiclass,Regression,Cluster}TuningEvaluator.java,
Report.java).

Candidates train one after another, each fit on the estimator's device
(``cuda`` unless the stage was given ``device="cpu"``), and are scored
on the host by the evaluation batch ops. With ``ALINK_TPU_SWEEP`` on, a
linear-family estimator whose grid axes are all carry-resident trains
its candidates as a sweep (``tuning/sweep.py``), bitwise the serial
fits, so the report, the winner and the refit model are the serial
loop's. With the flag off this module never imports the sweep.

One deliberate difference from the JAX package: an error raised inside
the sweep propagates out of ``fit``; it is not caught and replaced by a
serial run (the JAX package's ``sweep-error`` fallback), which would
hide a kernel that fails to build or launch. A candidate whose scoring
fails is still recorded in the ``Report``, as in the serial loop.
"""

from __future__ import annotations

import itertools
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..common.mtable import MTable
from ..common.params import ParamInfo, _snake
from ..common.types import AlinkTypes, TableSchema
from ..operator.base import BatchOperator, TableSourceBatchOp
from ..operator.batch.evaluation import (EvalBinaryClassBatchOp,
                                         EvalClusterBatchOp,
                                         EvalMultiClassBatchOp,
                                         EvalRegressionBatchOp)
from .base import Estimator, Model, PipelineStage, Transformer


class ParamGrid:
    """reference: pipeline/tuning/ParamGrid.java — (stage, param, values)."""

    def __init__(self):
        self.items: List[Tuple[PipelineStage, ParamInfo, Sequence]] = []

    def add_grid(self, stage: PipelineStage, info, values: Sequence) -> "ParamGrid":
        if isinstance(info, str):
            key = _snake(info)
            infos = stage.param_infos()
            cand = infos.get(key)
            if cand is None:
                for pi in infos.values():
                    if key == pi.name or info in pi.aliases or key in pi.aliases:
                        cand = pi
                        break
            if cand is None:
                raise KeyError(f"{type(stage).__name__} has no param '{info}'")
            info = cand
        self.items.append((stage, info, list(values)))
        return self


# ---------------------------------------------------------------------------
# Tuning evaluators (pipeline/tuning/*TuningEvaluator.java)
# ---------------------------------------------------------------------------

class BaseTuningEvaluator:
    def __init__(self, metric: str, larger_better: bool, **eval_kwargs):
        self.metric = metric
        self.larger_better = larger_better
        self.eval_kwargs = eval_kwargs

    def is_larger_better(self) -> bool:
        return self.larger_better

    def evaluate(self, op: BatchOperator) -> float:  # pragma: no cover
        raise NotImplementedError


class BinaryClassificationTuningEvaluator(BaseTuningEvaluator):
    def __init__(self, label_col: str, prediction_detail_col: str = "details",
                 tuning_binary_class_metric: str = "AUC",
                 positive_label_value_string: Optional[str] = None):
        super().__init__(tuning_binary_class_metric, True)
        self.label_col = label_col
        self.prediction_detail_col = prediction_detail_col
        self.pos = positive_label_value_string
        if tuning_binary_class_metric.upper() == "LOGLOSS":
            self.larger_better = False

    def evaluate(self, op: BatchOperator) -> float:
        kw = {}
        if self.pos is not None:
            kw["positive_label_value_string"] = self.pos
        ev = EvalBinaryClassBatchOp(
            label_col=self.label_col,
            prediction_detail_col=self.prediction_detail_col, **kw).link_from(op)
        return float(ev.collect_metrics().get(_canon(self.metric, {
            "AUC": "AUC", "KS": "KS", "PRC": "PRC", "ACCURACY": "Accuracy",
            "PRECISION": "Precision", "RECALL": "Recall", "F1": "F1",
            "LOGLOSS": "LogLoss"})))


class MultiClassClassificationTuningEvaluator(BaseTuningEvaluator):
    def __init__(self, label_col: str, prediction_col: str = "pred",
                 tuning_multi_class_metric: str = "Accuracy"):
        super().__init__(tuning_multi_class_metric, True)
        self.label_col = label_col
        self.prediction_col = prediction_col

    def evaluate(self, op: BatchOperator) -> float:
        ev = EvalMultiClassBatchOp(label_col=self.label_col,
                                   prediction_col=self.prediction_col).link_from(op)
        return float(ev.collect_metrics().get(_canon(self.metric, {
            "ACC": "Accuracy", "ACCURACY": "Accuracy",
            "MACRO_F1": "MacroF1", "MACROF1": "MacroF1",
            "KAPPA": "Kappa"})))


class RegressionTuningEvaluator(BaseTuningEvaluator):
    def __init__(self, label_col: str, prediction_col: str = "pred",
                 tuning_regression_metric: str = "RMSE"):
        larger = tuning_regression_metric.upper() in ("R2", "EXPLAINED_VARIANCE")
        super().__init__(tuning_regression_metric, larger)
        self.label_col = label_col
        self.prediction_col = prediction_col

    def evaluate(self, op: BatchOperator) -> float:
        ev = EvalRegressionBatchOp(label_col=self.label_col,
                                   prediction_col=self.prediction_col).link_from(op)
        return float(ev.collect_metrics().get(_canon(self.metric, {
            "RMSE": "RMSE", "MAE": "MAE", "MSE": "MSE", "R2": "R2",
            "MAPE": "MAPE", "SSE": "SSE",
            "EXPLAINED_VARIANCE": "ExplainedVariance"})))


class ClusterTuningEvaluator(BaseTuningEvaluator):
    def __init__(self, vector_col: str, prediction_col: str = "pred",
                 tuning_cluster_metric: str = "SilhouetteCoefficient"):
        larger = tuning_cluster_metric.upper() not in ("DAVIESBOULDIN", "DB",
                                                       "SSW")
        super().__init__(tuning_cluster_metric, larger)
        self.vector_col = vector_col
        self.prediction_col = prediction_col

    def evaluate(self, op: BatchOperator) -> float:
        ev = EvalClusterBatchOp(vector_col=self.vector_col,
                                prediction_col=self.prediction_col).link_from(op)
        return float(ev.collect_metrics().get(_canon(self.metric, {
            "SILHOUETTE_COEFFICIENT": "SilhouetteCoefficient",
            "SILHOUETTECOEFFICIENT": "SilhouetteCoefficient",
            "CALINSKIHARABASZ": "CalinskiHarabasz", "CH": "CalinskiHarabasz",
            "DAVIESBOULDIN": "DaviesBouldin", "DB": "DaviesBouldin",
            "SSW": "SSW", "SSB": "SSB"})))


def _canon(name: str, table: dict) -> str:
    return table.get(name.upper().replace(" ", ""), name)


# ---------------------------------------------------------------------------
# Grid search
# ---------------------------------------------------------------------------

class Report:
    """reference: pipeline/tuning/Report.java — per-candidate results."""

    def __init__(self, rows: List[Tuple[str, float, bool, str]]):
        self.rows = rows

    def to_mtable(self) -> MTable:
        return MTable([(d, v, ok, msg) for d, v, ok, msg in self.rows],
                      TableSchema(["params", "metric", "success", "message"],
                                  [AlinkTypes.STRING, AlinkTypes.DOUBLE,
                                   AlinkTypes.BOOLEAN, AlinkTypes.STRING]))

    def __repr__(self):
        return "\n".join(
            f"{v:12.6f}  {'ok ' if ok else 'ERR'}  {d}" + (f"  [{m}]" if m else "")
            for d, v, ok, m in self.rows)


class BaseTuningModel(Model):
    """Wraps the winning fitted model; transform delegates."""

    def __init__(self, best: Transformer, report: Report,
                 best_params_desc: str):
        super().__init__()
        self.best_model = best
        self.report = report
        self.best_params_desc = best_params_desc

    def transform(self, in_op) -> BatchOperator:
        return self.best_model.transform(in_op)


class BaseGridSearch(Estimator):
    def __init__(self, estimator: Estimator = None, param_grid: ParamGrid = None,
                 tuning_evaluator: BaseTuningEvaluator = None, seed: int = 0):
        super().__init__()
        self.estimator = estimator
        self.param_grid = param_grid
        self.tuning_evaluator = tuning_evaluator
        self.seed = seed

    # fluent setters (reference setEstimator/setParamGrid/setTuningEvaluator)
    def set_estimator(self, e):
        self.estimator = e
        return self

    def set_param_grid(self, g):
        self.param_grid = g
        return self

    def set_tuning_evaluator(self, ev):
        self.tuning_evaluator = ev
        return self

    def _candidates(self):
        items = self.param_grid.items if self.param_grid else []
        values = [vals for _, _, vals in items]
        for combo in itertools.product(*values) if items else [()]:
            desc = ", ".join(
                f"{type(st).__name__}.{pi.name}={v}"
                for (st, pi, _), v in zip(items, combo))
            yield combo, items, desc or "(defaults)"

    @staticmethod
    def _apply(combo, items):
        saved = []
        for (stage, info, _), v in zip(items, combo):
            saved.append((stage, info,
                          stage.params.get(info) if stage.params.contains(info)
                          else None,
                          stage.params.contains(info)))
            stage.params.set(info, v)
        return saved

    @staticmethod
    def _restore(saved):
        for stage, info, old, had in saved:
            if had:
                stage.params.set(info, old)
            else:
                stage.params.remove(info)

    def _splits(self, table: MTable):  # pragma: no cover - abstract
        raise NotImplementedError

    # -- the sweep path (ALINK_TPU_SWEEP; tuning/) ------------------------
    # Carry-resident grid axes of the linear-family estimators: their
    # values sweep as (points,) lanes inside one queue per compile
    # group. Any other axis is trace-shaping here and falls back
    # (recorded) to the serial candidate loop.
    _SWEEP_AXES = frozenset({"l1", "l2", "learning_rate", "epsilon"})

    def _sweep_supported_model_type(self):
        """The linear-family model type of the estimator, or None.
        Softmax is excluded (its (k-1, d) objective is a different
        program family; serve it serially until a sweep kernel lands)."""
        train_cls = getattr(type(self.estimator), "TRAIN_OP_CLS", None)
        mt = getattr(train_cls, "MODEL_TYPE", None)
        from ..operator.common.linear.base import LinearModelType
        if train_cls is None or mt not in LinearModelType.LOSSES:
            return None
        return mt

    def _sweep_fit(self, table: MTable) -> Optional[BaseTuningModel]:
        """Train every grid candidate as a sweep, one queue per compile
        group (``tuning/sweep.py``), instead of one fit each. Each point
        is bitwise the serial fit of that candidate, so the Report, the
        winner and the refit model equal the serial loop's. Returns None
        — with the fallback RECORDED (alink_sweep_fallback_total) —
        whenever the grid cannot sweep; the caller then runs the serial
        loop. An error inside the sweep itself propagates."""
        from ..tuning.sweep import record_sweep_fallback
        est = self.estimator
        name = type(est).__name__
        mt = self._sweep_supported_model_type()
        if mt is None:
            record_sweep_fallback(name, "unsupported-estimator")
            return None
        if type(self.tuning_evaluator) not in (
                BinaryClassificationTuningEvaluator,
                MultiClassClassificationTuningEvaluator,
                RegressionTuningEvaluator, ClusterTuningEvaluator):
            record_sweep_fallback(name, "unsupported-evaluator",
                                  type(self.tuning_evaluator).__name__)
            return None
        items = self.param_grid.items if self.param_grid else []
        for stage, pi, _ in items:
            if stage is not est or pi.name not in self._SWEEP_AXES:
                record_sweep_fallback(
                    name, "trace-shaping-axis",
                    f"{type(stage).__name__}.{pi.name}")
                return None
        from ..operator.common.linear.base import (_default_method,
                                                   default_learning_rate,
                                                   prepare_linear_train)
        from ..operator.common.optim.optimizers import OptimParams
        from ..tuning.sweep import sweep_optimize
        cands = list(self._candidates())
        descs = [desc for _, _, desc in cands]
        P = len(cands)
        m = est.params._m
        base_l1 = float(m.get("l1", 0.0) or 0.0)
        base_l2 = float(m.get("l2", 0.0) or 0.0)
        base_eps = float(m.get("epsilon", 1e-6))
        base_lr = m.get("learning_rate")
        sweep_points = []
        for combo, items_, _desc in cands:
            pt = {pi.name: v for (st, pi, _), v in zip(items_, combo)}
            l1 = float(pt.get("l1", base_l1))
            # per-point resolution through the serial path's OWN rules
            # (_default_method / default_learning_rate): an l1 axis that
            # crosses zero splits the sweep into OWLQN/LBFGS compile
            # groups exactly like flag-off
            method = _default_method(est, l1).upper()
            lr = pt.get("learning_rate", base_lr)
            if lr is None:
                lr = default_learning_rate(method)
            sweep_points.append({
                "method": method, "l1": l1,
                "l2": float(pt.get("l2", base_l2)),
                "learning_rate": float(lr),
                "epsilon": float(pt.get("epsilon", base_eps))})
        base_optim = OptimParams(
            method="LBFGS", max_iter=int(m.get("max_iter", 100)),
            epsilon=base_eps,
            mini_batch_fraction=float(m.get("mini_batch_fraction", 0.1)),
            seed=int(m.get("seed", 0) or 0))
        ev = self.tuning_evaluator
        larger = ev.is_larger_better()
        split_scores: List[List[float]] = [[] for _ in range(P)]
        errors: List[Optional[str]] = [None] * P
        for train_t, test_t in self._splits(table):
            prep = prepare_linear_train(train_t,
                                        est.train_op(est.params.clone()), mt)
            res = sweep_optimize(prep.objective(base_l1, base_l2),
                                 prep.train, base_optim, sweep_points,
                                 env=prep.env)
            for i in range(P):
                if errors[i] is not None:
                    continue
                try:
                    model_table, _info = prep.finish(
                        res.values["coef"][i], res.loss_curves[i])
                    saved = self._apply(cands[i][0], cands[i][1])
                    try:
                        model = type(est).MODEL_CLS(est.params.clone(),
                                                    device=est.device)
                    finally:
                        self._restore(saved)
                    model.set_model_data(model_table)
                    split_scores[i].append(float(ev.evaluate(
                        model.transform(TableSourceBatchOp(test_t)))))
                except Exception as e:  # candidate failure is not
                    # fatal — the Report records it (serial contract)
                    errors[i] = f"{type(e).__name__}: {e}"
        best = (None, -np.inf if larger else np.inf, None, "")
        rows = []
        for i in range(P):
            if errors[i] is not None or not split_scores[i]:
                rows.append((descs[i], float("nan"), False,
                             errors[i] or "no score"))
                continue
            score = float(np.mean(split_scores[i]))
            rows.append((descs[i], score, True, ""))
            if (larger and score > best[1]) or (not larger and score < best[1]):
                best = (cands[i][0], score, cands[i][1], descs[i])
        if best[0] is None:
            msgs = "; ".join(f"{d}: {msg}" for d, _, ok, msg in rows if not ok)
            raise RuntimeError(f"all tuning candidates failed — {msgs}")
        saved = self._apply(best[0], best[2])
        try:
            final_model = self.estimator.fit(TableSourceBatchOp(table))
        finally:
            self._restore(saved)
        return BaseTuningModel(final_model, Report(rows), best[3])

    def fit(self, in_op) -> BaseTuningModel:
        if self.estimator is None or self.tuning_evaluator is None:
            raise ValueError("grid search needs estimator and tuning_evaluator")
        in_op = in_op if isinstance(in_op, BatchOperator) else TableSourceBatchOp(in_op)
        table = in_op.get_output_table()
        from ..common.flags import flag_value
        if flag_value("ALINK_TPU_SWEEP", False):
            # flag-off never reaches the tuning package at all
            got = self._sweep_fit(table)
            if got is not None:
                return got
        ev = self.tuning_evaluator
        larger = ev.is_larger_better()
        best = (None, -np.inf if larger else np.inf, None, "")
        rows = []
        for combo, items, desc in self._candidates():
            saved = self._apply(combo, items)
            try:
                scores = []
                for train_t, test_t in self._splits(table):
                    m = self.estimator.fit(TableSourceBatchOp(train_t))
                    scores.append(ev.evaluate(
                        m.transform(TableSourceBatchOp(test_t))))
                score = float(np.mean(scores))
                rows.append((desc, score, True, ""))
                if (larger and score > best[1]) or (not larger and score < best[1]):
                    # refit winner on the full data at the end; remember combo
                    best = (combo, score, items, desc)
            except Exception as e:  # candidate failure is not fatal —
                # the Report records it (reference Report.java)
                rows.append((desc, float("nan"), False,
                             f"{type(e).__name__}: {e}"))
            finally:
                self._restore(saved)
        if best[0] is None:
            msgs = "; ".join(f"{d}: {m}" for d, _, ok, m in rows if not ok)
            raise RuntimeError(f"all tuning candidates failed — {msgs}")
        saved = self._apply(best[0], best[2])
        try:
            final_model = self.estimator.fit(TableSourceBatchOp(table))
        finally:
            self._restore(saved)
        return BaseTuningModel(final_model, Report(rows), best[3])


class GridSearchCV(BaseGridSearch):
    """k-fold cross-validated grid search (BaseTuning.kFoldCv:239-300)."""

    def __init__(self, estimator=None, param_grid=None, tuning_evaluator=None,
                 num_folds: int = 10, seed: int = 0):
        super().__init__(estimator, param_grid, tuning_evaluator, seed)
        self.num_folds = num_folds

    def set_num_folds(self, n: int):
        self.num_folds = n
        return self

    def _splits(self, table: MTable):
        n = table.num_rows
        k = max(2, min(self.num_folds, n))
        perm = np.random.RandomState(self.seed).permutation(n)
        folds = np.array_split(perm, k)
        for i in range(k):
            test_idx = np.sort(folds[i])
            train_idx = np.sort(np.concatenate(
                [folds[j] for j in range(k) if j != i]))
            yield table.take_rows(train_idx), table.take_rows(test_idx)


class GridSearchTVSplit(BaseGridSearch):
    """single train/validation split (reference GridSearchTVSplit)."""

    def __init__(self, estimator=None, param_grid=None, tuning_evaluator=None,
                 train_ratio: float = 0.8, seed: int = 0):
        super().__init__(estimator, param_grid, tuning_evaluator, seed)
        self.train_ratio = train_ratio

    def set_train_ratio(self, r: float):
        self.train_ratio = r
        return self

    def _splits(self, table: MTable):
        n = table.num_rows
        perm = np.random.RandomState(self.seed).permutation(n)
        cut = max(1, min(n - 1, int(round(n * self.train_ratio))))
        yield (table.take_rows(np.sort(perm[:cut])),
               table.take_rows(np.sort(perm[cut:])))
