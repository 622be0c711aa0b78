"""Tree-family batch operators: GBDT, RandomForest, DecisionTree
(classification + regression).

Counterpart: ``alink_tpu/operator/batch/classification/tree_ops.py``.
The model table, its converter, the feature encoding and the host
traversal (``TreeModelMapper.map_table``) are the JAX package's numpy
code, so a model table saved by either package loads in the other. The
train ops take ``device`` (``cuda`` unless the caller passes
``device="cpu"``; without CUDA they raise) and train on a one-worker
session on it (``common/mlenv.py``). ``TreeModelMapper.serving_kernel``
scores on the device with torch ops for ``serving.CompiledPredictor``:
one gather per level of every tree, then the trees' terms summed left
to right in the host loop's order, so float64 device scores equal
``map_table`` bit for bit. The stream predict twins are in
``operator/stream/predict_ops.py``, the pipeline stages in
``pipeline/tree.py``.
"""

from __future__ import annotations

import json
from typing import List, Optional

import numpy as np
import torch

from ....common.device import resolve_device
from ....common.mlenv import MLEnvironment
from ....common.mtable import MTable
from ....common.params import ParamInfo, Params, RangeValidator
from ....common.types import AlinkTypes, TableSchema
from ....mapper.base import ModelMapper, OutputColsHelper
from ....model.converters import (SimpleModelDataConverter, decode_array,
                                  encode_array)
from ....model.interop import tree_model_from_numpy
from ....params.shared import (HasFeatureCols, HasLabelCol, HasPredictionCol,
                               HasPredictionDetailCol, HasReservedCols, HasSeed,
                               HasVectorCol, HasWeightCol)
from ...base import BatchOperator
from ...common.dataproc.feature_extract import extract_design, resolve_feature_cols
from ...common.tree.hist import tree_apply_values
from ...common.tree.trainers import TreeTrainParams, forest_train, gbdt_train
from ..utils.model_map import ModelMapBatchOp

_SHIP_DTYPES = {torch.float32: np.float32, torch.float64: np.float64}


class TreeModelData:
    def __init__(self, algo: str, is_regression: bool, max_depth: int,
                 features: np.ndarray, thresholds: np.ndarray,
                 leaf_values: np.ndarray, base_score: float, learning_rate: float,
                 labels: List, feature_cols: Optional[List[str]],
                 vector_col: Optional[str], label_type: str = AlinkTypes.STRING,
                 split_masks: Optional[np.ndarray] = None,
                 cat_cols: Optional[List[str]] = None,
                 cat_vocabs: Optional[dict] = None,
                 importances: Optional[np.ndarray] = None):
        self.algo = algo
        self.is_regression = is_regression
        self.max_depth = max_depth
        self.features = features          # (T, 2^d - 1) int
        self.thresholds = thresholds      # (T, 2^d - 1) float
        self.leaf_values = leaf_values    # (T, 2^d) or (T, 2^d, k)
        self.base_score = base_score
        self.learning_rate = learning_rate
        self.labels = labels
        self.feature_cols = feature_cols
        self.vector_col = vector_col
        self.label_type = label_type
        # categorical support (reference seriestree/CategoricalSplitter):
        self.split_masks = split_masks    # (T, 2^d - 1, n_bins) bool or None
        self.cat_cols = cat_cols or []    # feature col names that are categorical
        self.cat_vocabs = cat_vocabs or {}  # col -> [category strings] (code = index)
        self.importances = importances    # (F,) summed split gain or None


class TreeModelDataConverter(SimpleModelDataConverter):
    """reference: common/tree/TreeModelDataConverter.java"""

    def serialize_model(self, m: TreeModelData):
        meta = Params({
            "algo": m.algo, "is_regression": m.is_regression,
            "max_depth": m.max_depth, "base_score": m.base_score,
            "learning_rate": m.learning_rate,
            "labels": [str(l) for l in m.labels], "label_type": m.label_type,
            "feature_cols": m.feature_cols, "vector_col": m.vector_col,
            "cat_cols": m.cat_cols, "cat_vocabs": m.cat_vocabs})
        blobs = [encode_array(m.features), encode_array(m.thresholds),
                 encode_array(m.leaf_values)]
        if m.split_masks is not None:
            blobs.append(encode_array(m.split_masks.astype(np.int8)))
        if m.importances is not None:
            if m.split_masks is None:
                blobs.append(encode_array(
                    np.zeros((0,), np.int8)))  # keep blob positions fixed
            blobs.append(encode_array(np.asarray(m.importances, np.float64)))
        return meta, blobs

    def deserialize_model(self, meta, data):
        labels = meta._m.get("labels", [])
        lt = meta._m.get("label_type", AlinkTypes.STRING)
        if lt in (AlinkTypes.LONG, AlinkTypes.INT):
            labels = [int(float(v)) for v in labels]
        elif lt in (AlinkTypes.DOUBLE, AlinkTypes.FLOAT):
            labels = [float(v) for v in labels]
        split_masks = (decode_array(data[3], np.int8).astype(bool)
                       if len(data) > 3 and decode_array(data[3]).size
                       else None)
        importances = decode_array(data[4]) if len(data) > 4 else None
        return TreeModelData(
            meta._m["algo"], bool(meta._m["is_regression"]),
            int(meta._m["max_depth"]),
            decode_array(data[0], np.int64), decode_array(data[1]),
            decode_array(data[2]), float(meta._m.get("base_score", 0.0)),
            float(meta._m.get("learning_rate", 1.0)), labels,
            meta._m.get("feature_cols"), meta._m.get("vector_col"), lt,
            split_masks=split_masks, cat_cols=meta._m.get("cat_cols"),
            cat_vocabs=meta._m.get("cat_vocabs"), importances=importances)


class _TreeTrainParamsMixin(HasLabelCol, HasFeatureCols, HasVectorCol,
                            HasWeightCol, HasSeed):
    NUM_TREES = ParamInfo("num_trees", int, default=100,
                          validator=RangeValidator(1, None))
    MAX_DEPTH = ParamInfo("max_depth", int, default=5,
                          validator=RangeValidator(1, 14))
    MAX_BINS = ParamInfo("max_bins", int, default=64,
                         validator=RangeValidator(2, 256))
    MIN_SAMPLES_PER_LEAF = ParamInfo("min_samples_per_leaf", int, default=2)
    LEARNING_RATE = ParamInfo("learning_rate", float, default=0.3)
    SUBSAMPLING_RATIO = ParamInfo("subsampling_ratio", float, default=1.0)
    FEATURE_SUBSAMPLING_RATIO = ParamInfo("feature_subsampling_ratio", float,
                                          default=1.0)
    REG_LAMBDA = ParamInfo("reg_lambda", float, default=1.0)
    CATEGORICAL_COLS = ParamInfo("categorical_cols", list, default=None)


def _encode_feature_matrix(t: MTable, feature_cols, cat_cols):
    """(X, cat_mask, cat_vocabs): categorical columns ordinal-encode via a
    sorted per-column vocabulary (code = vocab index, stored in the model
    for serving); numeric columns pass through."""
    n = t.num_rows
    cat_set = set(cat_cols)
    X = np.empty((n, len(feature_cols)), np.float64)
    vocabs = {}
    for j, c in enumerate(feature_cols):
        col = t.col(c)
        if c in cat_set:
            vocab = sorted({str(v) for v in col})
            vocabs[c] = vocab
            lut = {v: i for i, v in enumerate(vocab)}
            X[:, j] = [lut[str(v)] for v in col]
        else:
            X[:, j] = np.asarray(col, np.float64)
    cat_mask = np.asarray([c in cat_set for c in feature_cols], bool)
    return X, cat_mask, vocabs


def _extract_xy(op, t: MTable, regression: bool):
    vector_col = op.params._m.get("vector_col")
    feature_cols = op.params._m.get("feature_cols")
    cat_cols = list(op.params._m.get("categorical_cols") or [])
    label_col = op.get_label_col()
    weight_col = op.params._m.get("weight_col")
    cat_mask, vocabs = None, {}
    if not vector_col:
        feature_cols = resolve_feature_cols(
            t, feature_cols, label_col, exclude=[weight_col] if weight_col else [])
        for c in cat_cols:                 # string cols aren't numeric-resolvable
            if c not in feature_cols:
                feature_cols = feature_cols + [c]
        X, cat_mask, vocabs = _encode_feature_matrix(t, feature_cols, cat_cols)
        if not cat_mask.any():
            cat_mask = None
    else:
        if cat_cols:
            raise ValueError("categorical_cols requires feature_cols input "
                             "(vector input has no column identity)")
        design = extract_design(t, feature_cols, vector_col, np.float64)
        X = design["X"] if design["kind"] == "dense" else None
        if X is None:
            from ....common.vector import SparseBatch
            X = SparseBatch(design["idx"], design["val"],
                            design["dim"]).to_dense(np.float64)
    raw = t.col(label_col)
    label_type = t.schema.type_of(label_col)
    if regression:
        labels, y = [], np.asarray(raw, np.float64)
    else:
        labels = sorted({str(v) for v in raw})
        y = np.asarray([labels.index(str(v)) for v in raw], np.float64)
        if label_type in (AlinkTypes.LONG, AlinkTypes.INT):
            labels = [int(float(v)) for v in labels]
        elif label_type in (AlinkTypes.DOUBLE, AlinkTypes.FLOAT):
            labels = [float(v) for v in labels]
    w = (np.asarray(t.col(weight_col), np.float64) if weight_col
         else np.ones(len(y)))
    return (X, y, w, labels, feature_cols, vector_col, label_type,
            cat_mask if not vector_col else None, cat_cols, vocabs)


def _model_info_table(m: "TreeModelData") -> MTable:
    """Model summary incl. gain-based feature importances (reference
    GbdtModelInfo / RandomForestModelInfo feature importance output)."""
    if m.importances is not None:
        t = _importance_table(m.feature_cols, m.importances)
        rows = {"item": np.asarray(
                    ["algo", "num_trees", "max_depth"]
                    + [f"importance[{f}]" for f in t.col("feature")], object),
                "value": np.asarray(
                    [m.algo, str(m.features.shape[0]), str(m.max_depth)]
                    + [f"{v:.6f}" for v in t.col("importance")], object)}
        return MTable(rows)
    return MTable({"item": np.asarray(["algo", "num_trees", "max_depth"], object),
                   "value": np.asarray([m.algo, str(m.features.shape[0]),
                                        str(m.max_depth)], object)})


def _importance_table(feature_cols, imp) -> MTable:
    """Gain-based feature importances, normalized to sum 1 (reference
    TreeModelInfo feature importance)."""
    imp = np.asarray(imp, np.float64)
    tot = imp.sum()
    names = (list(feature_cols) if feature_cols
             else [f"f{i}" for i in range(len(imp))])
    return MTable({"feature": np.asarray(names, object),
                   "importance": imp / (tot if tot > 0 else 1.0)})


def _tree_params(op) -> TreeTrainParams:
    return TreeTrainParams(
        num_trees=op.get_num_trees(), max_depth=op.get_max_depth(),
        n_bins=op.get_max_bins(), learning_rate=op.get_learning_rate(),
        min_samples_leaf=op.get_min_samples_per_leaf(),
        reg_lambda=op.get_reg_lambda(),
        subsample_ratio=op.get_subsampling_ratio(),
        feature_subsample_ratio=op.get_feature_subsampling_ratio(),
        seed=op.get_seed())


class _TreeTrainOp(BatchOperator):
    """A tree train op on ``device`` (``cuda`` by default; raises without
    it). Training runs on a one-worker session on that device."""

    def __init__(self, params: Optional[Params] = None, device=None,
                 **kwargs):
        super().__init__(params, **kwargs)
        self.device = resolve_device(device)

    def get_model_info(self) -> MTable:
        m = TreeModelDataConverter().load_model(self.get_output_table())
        return _model_info_table(m)


class GbdtTrainBatchOp(_TreeTrainOp, _TreeTrainParamsMixin):
    """reference: batch/classification/GbdtTrainBatchOp.java (binary)."""
    IS_REGRESSION = False

    def link_from(self, in_op: BatchOperator):
        t = in_op.get_output_table()
        (X, y, w, labels, fc, vc, lt, cat_mask, cat_cols,
         vocabs) = _extract_xy(t=t, op=self, regression=self.IS_REGRESSION)
        if not self.IS_REGRESSION and len(labels) != 2:
            raise ValueError(f"GBDT classifier is binary; got labels {labels}")
        p = _tree_params(self)
        tf, tb, tm, tv, edges, base, curve, imp = gbdt_train(
            X, y, p, self.IS_REGRESSION, env=MLEnvironment(device=self.device),
            sample_weight=w, cat_mask=cat_mask)
        model = tree_model_from_numpy(
            "gbdt", tf, tb, tv, edges, is_regression=self.IS_REGRESSION,
            max_depth=p.max_depth, labels=labels, base_score=base,
            learning_rate=p.learning_rate, split_masks=tm, importances=imp,
            feature_cols=fc, vector_col=vc, label_type=lt, cat_cols=cat_cols,
            cat_vocabs=vocabs)
        self._output = TreeModelDataConverter().save_model(model)
        self._side_outputs = [MTable({"tree": np.arange(1, len(curve) + 1),
                                      "loss": curve.astype(np.float64)}),
                              _importance_table(fc, imp)]
        return self


class GbdtRegTrainBatchOp(GbdtTrainBatchOp):
    """reference: batch/regression/GbdtRegTrainBatchOp.java"""
    IS_REGRESSION = True


class RandomForestTrainBatchOp(_TreeTrainOp, _TreeTrainParamsMixin):
    """reference: batch/classification/RandomForestTrainBatchOp.java"""
    IS_REGRESSION = False
    NUM_TREES = ParamInfo("num_trees", int, default=10,
                          validator=RangeValidator(1, None))
    SUBSAMPLING_RATIO = ParamInfo("subsampling_ratio", float, default=0.8)
    FEATURE_SUBSAMPLING_RATIO = ParamInfo("feature_subsampling_ratio", float,
                                          default=0.7)
    # Ensemble parallelism (whole trees per worker, reference
    # SeriesTrainFunction). Declared so the JAX op's params carry over;
    # read nowhere, since one worker grows the same forest either way.
    ENSEMBLE_PARALLEL = ParamInfo("ensemble_parallel", bool, default=None)

    def link_from(self, in_op: BatchOperator):
        t = in_op.get_output_table()
        (X, y, w, labels, fc, vc, lt, cat_mask, cat_cols,
         vocabs) = _extract_xy(t=t, op=self, regression=self.IS_REGRESSION)
        p = _tree_params(self)
        if self.IS_REGRESSION:
            stats = np.stack([y * w, y * y * w, w], axis=1)
            kind = "variance"
        else:
            k = len(labels)
            onehot = np.eye(k)[y.astype(int)] * w[:, None]
            stats = np.concatenate([onehot, w[:, None]], axis=1)
            kind = "gini"
        tf, tb, tm, tv, edges, imp = forest_train(
            X, stats, p, kind, env=MLEnvironment(device=self.device),
            cat_mask=cat_mask)
        model = tree_model_from_numpy(
            "rf", tf, tb, tv, edges, is_regression=self.IS_REGRESSION,
            max_depth=p.max_depth, labels=labels, split_masks=tm,
            importances=imp, feature_cols=fc, vector_col=vc, label_type=lt,
            cat_cols=cat_cols, cat_vocabs=vocabs)
        self._output = TreeModelDataConverter().save_model(model)
        self._side_outputs = [_importance_table(fc, imp)]
        return self


class RandomForestRegTrainBatchOp(RandomForestTrainBatchOp):
    IS_REGRESSION = True


class DecisionTreeTrainBatchOp(RandomForestTrainBatchOp):
    """reference: batch/classification/DecisionTreeTrainBatchOp.java"""
    NUM_TREES = ParamInfo("num_trees", int, default=1,
                          validator=RangeValidator(1, 1))
    SUBSAMPLING_RATIO = ParamInfo("subsampling_ratio", float, default=1.0)
    FEATURE_SUBSAMPLING_RATIO = ParamInfo("feature_subsampling_ratio", float,
                                          default=1.0)


class DecisionTreeRegTrainBatchOp(DecisionTreeTrainBatchOp):
    IS_REGRESSION = True


class TreeModelMapper(ModelMapper):
    """Host-side batched forest traversal (reference common/tree/predictors/)."""

    def __init__(self, model_schema, data_schema, params=None, **kwargs):
        super().__init__(model_schema, data_schema, params, **kwargs)
        self.model: Optional[TreeModelData] = None

    def load_model(self, model_table: MTable):
        self.model = TreeModelDataConverter().load_model(model_table)

    def get_output_schema(self) -> TableSchema:
        m = self.model
        return self._pred_output_schema(
            m.label_type if m else AlinkTypes.STRING,
            bool(m is not None and m.is_regression))

    def _model_width(self) -> int:
        """The feature width the model's splits can address: column
        count for feature_cols models, max split feature index + 1 for
        vector models (the model stores no vector size)."""
        m = self.model
        if m.feature_cols:
            return len(m.feature_cols)
        return int(max(int(m.features.max()), 0)) + 1

    def _encode_matrix(self, data: MTable, dtype=np.float64) -> np.ndarray:
        """Request table -> raw feature-value matrix (categorical columns
        ordinal-coded via the model vocabularies, OOV -> -1 which every
        traversal routes right), always :meth:`_model_width` columns
        wide. Shared by the host ``map_table`` path and the serving
        kernel's encode so the two cannot diverge."""
        m = self.model
        if m.cat_cols:
            n = data.num_rows
            X = np.empty((n, len(m.feature_cols)), dtype)
            for j, c in enumerate(m.feature_cols):
                col = data.col(c)
                if c in m.cat_vocabs:
                    lut = {v: i for i, v in enumerate(m.cat_vocabs[c])}
                    X[:, j] = [lut.get(str(v), -1) for v in col]  # OOV -> right
                else:
                    X[:, j] = np.asarray(col, np.float64)
            return X
        width = self._model_width()
        design = extract_design(data, m.feature_cols, m.vector_col,
                                np.float64,
                                vector_size=width if m.vector_col else None)
        X = design["X"] if design["kind"] == "dense" else None
        if X is None:
            from ....common.vector import SparseBatch
            X = SparseBatch(design["idx"], design["val"],
                            design["dim"]).to_dense(np.float64)
        if X.shape[1] < width:          # batch narrower than the splits
            X = np.concatenate(
                [X, np.zeros((X.shape[0], width - X.shape[1]), X.dtype)],
                axis=1)
        return np.asarray(X, dtype)

    def _cat_mask(self) -> Optional[np.ndarray]:
        m = self.model
        return (np.asarray([c in set(m.cat_cols) for c in
                            (m.feature_cols or [])], bool)
                if m.cat_cols else None)

    def map_table(self, data: MTable) -> MTable:
        m = self.model
        X = self._encode_matrix(data)
        T = m.features.shape[0]
        n = X.shape[0]
        cat_mask = self._cat_mask()

        def apply(t):
            return tree_apply_values(
                X, m.features[t], m.thresholds[t], m.max_depth,
                cat_mask=cat_mask,
                split_masks=(m.split_masks[t]
                             if m.split_masks is not None else None))

        if m.algo == "gbdt":
            score = np.full(n, m.base_score)
            for t in range(T):
                score += m.learning_rate * m.leaf_values[t][apply(t)]
            if m.is_regression:
                return self._emit(data, score, None, None)
            p_pos = 1.0 / (1.0 + np.exp(-np.clip(score, -500, 500)))
            probs = np.stack([1 - p_pos, p_pos], axis=1)  # labels sorted asc
            return self._emit(data, None, probs, m.labels)
        # random forest / decision tree
        if m.is_regression:
            acc = np.zeros(n)
            for t in range(T):
                acc += m.leaf_values[t][apply(t)]
            return self._emit(data, acc / T, None, None)
        k = m.leaf_values.shape[2]
        probs = np.zeros((n, k))
        for t in range(T):
            probs += m.leaf_values[t][apply(t)]
        probs /= np.maximum(probs.sum(1, keepdims=True), 1e-12)
        return self._emit(data, None, probs, m.labels)

    def serving_kernel(self, ship_dtype: torch.dtype = torch.float32):
        """The serving contract (``serving/predictor.py``) for the tree
        family: every level of every tree is ONE batched gather of
        (feature, threshold[, split mask]) at the current node frontier,
        ``node -> 2*node + go_right``; after ``max_depth`` levels the leaf
        values gather per tree and add up over the trees left to right
        (``serving/sharded.py::scan_sum``; for GBDT from the base score,
        each term ``lr * leaf`` rounded first), the host mapper's exact
        order. Shipped in float64, the device scores are therefore
        bitwise equal to ``map_table``'s, so labels and detail strings
        match it exactly; the per-row integer traversal makes bucket
        padding a bitwise no-op. The signature carries the tree geometry
        and the ship dtype only."""
        m = self.model
        if m is None:
            raise RuntimeError(
                "load_model must be called before serving_kernel")
        if ship_dtype not in _SHIP_DTYPES:
            raise ValueError(f"ship dtype {ship_dtype}: want float32 or "
                             f"float64")
        from ....serving.predictor import ServingKernel
        from ....serving.sharded import scan_sum
        ship_dt = _SHIP_DTYPES[ship_dtype]
        T, nodes = m.features.shape
        depth = int(m.max_depth)
        n_class = (int(m.leaf_values.shape[2])
                   if m.leaf_values.ndim == 3 else 0)
        cat_mask = self._cat_mask()
        has_masks = m.split_masks is not None and cat_mask is not None
        n_bins = int(m.split_masks.shape[2]) if has_masks else 0
        n_feat = int(len(m.feature_cols)) if m.feature_cols else None
        gbdt = m.algo == "gbdt"

        model_arrays = [torch.from_numpy(np.asarray(m.features, np.int64)),
                        torch.from_numpy(np.asarray(m.thresholds, ship_dt)),
                        torch.from_numpy(np.asarray(m.leaf_values, ship_dt)),
                        torch.tensor(m.base_score, dtype=ship_dtype),
                        torch.tensor(m.learning_rate, dtype=ship_dtype)]
        if has_masks:
            model_arrays.append(torch.from_numpy(
                np.asarray(m.split_masks, bool)))
            model_arrays.append(torch.from_numpy(np.asarray(cat_mask, bool)))
        signature = ("tree", m.algo, bool(m.is_regression), T, depth,
                     nodes, n_class, n_feat, has_masks, n_bins,
                     ship_dt.__name__)

        def encode(data: MTable, bucket: int):
            Xf = self._encode_matrix(data, ship_dt)
            X = np.zeros((bucket, Xf.shape[1]), ship_dt)
            X[:data.num_rows] = Xf
            return ("dense", (torch.from_numpy(X),))

        def _apply_all(mdl, X):
            """(n, T) leaf indices — the vectorized device twin of the
            host ``tree_apply_values`` descent."""
            features, thresholds = mdl[0], mdl[1]
            n = X.shape[0]
            tr = torch.arange(T, device=X.device)[None, :]
            rows = torch.arange(n, device=X.device)[:, None]
            node = torch.zeros((n, T), dtype=torch.int64, device=X.device)
            offset = 0
            for level in range(depth):
                gi = offset + node
                f = features[tr, gi]
                thr = thresholds[tr, gi]
                x = X[rows, torch.clamp(f, min=0)]
                go_right = (f >= 0) & (x > thr)
                if has_masks:
                    masks, catm = mdl[5], mdl[6]
                    code = torch.round(x).long()
                    in_left = (code >= 0) & masks[
                        tr, gi, torch.clamp(code, 0, n_bins - 1)]
                    is_cat = catm[torch.clamp(f, min=0)] & (f >= 0)
                    go_right = torch.where(is_cat, (f >= 0) & ~in_left,
                                           go_right)
                node = node * 2 + go_right.long()
                offset += 1 << level
            return node, tr

        def _score(mdl, X):
            leafs, base, lr = mdl[2], mdl[3], mdl[4]
            node, tr = _apply_all(mdl, X)
            if gbdt:
                # host order: score = full(base); score += lr*leaf[t] per
                # tree, left to right — base, then the rounded lr*leaf
                # terms
                terms = lr * leafs[tr, node]
                return scan_sum(torch.cat(
                    [base.expand(terms.shape[0], 1), terms], dim=1), axis=1)
            # rf/dt: per-tree leaf stats summed over the tree axis — (n,)
            # regression / (n, k) classification; decode normalizes
            return scan_sum(leafs[tr, node], axis=1)

        def decode(outputs, data: MTable) -> MTable:
            out = np.asarray(outputs[0], np.float64)
            if gbdt:
                if m.is_regression:
                    return self._emit(data, out, None, None)
                p_pos = 1.0 / (1.0 + np.exp(-np.clip(out, -500, 500)))
                probs = np.stack([1 - p_pos, p_pos], axis=1)
                return self._emit(data, None, probs, m.labels)
            if m.is_regression:
                return self._emit(data, out / T, None, None)
            probs = out / np.maximum(out.sum(1, keepdims=True), 1e-12)
            return self._emit(data, None, probs, m.labels)

        return ServingKernel(signature=signature,
                             model_arrays=tuple(model_arrays),
                             encode=encode, device_fns={"dense": _score},
                             decode=decode)

    def _emit(self, data, scores, probs, labels):
        m = self.model
        pred_col = self.params._m.get("prediction_col", "pred")
        detail_col = self.params._m.get("prediction_detail_col")
        reserved = self.params._m.get("reserved_cols")
        if probs is None:
            helper = OutputColsHelper(data.schema, [pred_col],
                                      [AlinkTypes.DOUBLE], reserved)
            return helper.build_output(data, [scores])
        pick = probs.argmax(1)
        preds = np.empty(len(pick), object)
        preds[:] = [labels[i] for i in pick]
        cols, types, vals = [pred_col], [m.label_type], [preds]
        if detail_col:
            details = np.asarray(
                [json.dumps({str(l): float(p) for l, p in zip(labels, row)})
                 for row in probs], object)
            cols.append(detail_col)
            types.append(AlinkTypes.STRING)
            vals.append(details)
        helper = OutputColsHelper(data.schema, cols, types, reserved)
        return helper.build_output(data, vals)


class _TreePredictBase(ModelMapBatchOp, HasPredictionCol, HasPredictionDetailCol,
                       HasReservedCols):
    MAPPER_CLS = TreeModelMapper


class GbdtPredictBatchOp(_TreePredictBase):
    pass


class GbdtRegPredictBatchOp(_TreePredictBase):
    pass


class RandomForestPredictBatchOp(_TreePredictBase):
    pass


class RandomForestRegPredictBatchOp(_TreePredictBase):
    pass


class DecisionTreePredictBatchOp(_TreePredictBase):
    pass


class DecisionTreeRegPredictBatchOp(_TreePredictBase):
    pass
