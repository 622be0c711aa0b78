"""Evaluation metric internals.

Counterpart: ``alink_tpu/operator/common/evaluation/metrics.py``.
Ported: ``BaseMetrics``, ``BinaryClassMetrics`` and ``binary_metrics``
(the reference's BinaryMetricsSummary: AUC by the rank statistic, KS,
PRC, the lift chart and the threshold metrics), copied: the module is
numpy only. The multiclass, regression and cluster metrics wait with
their eval ops.
"""

from __future__ import annotations

import json
from typing import Dict

import numpy as np


class BaseMetrics:
    def __init__(self, d: Dict):
        self._d = dict(d)

    def get(self, name: str):
        return self._d[name]

    def to_dict(self) -> Dict:
        return dict(self._d)

    def to_json(self) -> str:
        return json.dumps({k: (v.tolist() if isinstance(v, np.ndarray) else v)
                           for k, v in self._d.items()}, default=float)

    def __getattr__(self, item):
        if item.startswith("get_"):
            key = item[4:]
            if key in self._d:
                return lambda: self._d[key]
            # case/underscore-insensitive fallback: get_log_loss -> LogLoss
            want = key.replace("_", "").lower()
            for k in self._d:
                if k.lower() == want:
                    v = self._d[k]
                    return lambda v=v: v
        raise AttributeError(item)

    def __repr__(self):
        return f"{type(self).__name__}({json.dumps({k: v for k, v in self._d.items() if not isinstance(v, (list, np.ndarray))}, default=str)})"


class BinaryClassMetrics(BaseMetrics):
    pass


def binary_metrics(labels: np.ndarray, p_pos: np.ndarray, pos_value,
                   threshold: float = 0.5) -> BinaryClassMetrics:
    """AUC/KS/PRC + threshold metrics (reference BinaryMetricsSummary)."""
    y = np.asarray([1 if _eq(l, pos_value) else 0 for l in labels])
    p = np.asarray(p_pos, np.float64)
    n_pos = int(y.sum())
    n_neg = len(y) - n_pos

    # AUC via rank statistic (ties handled by average rank)
    order = np.argsort(p, kind="mergesort")
    ranks = np.empty(len(p), np.float64)
    sp = p[order]
    # average ranks for ties
    uniq, inv, counts = np.unique(sp, return_inverse=True, return_counts=True)
    csum = np.cumsum(counts)
    avg_rank = (csum - (counts - 1) / 2.0)
    ranks[order] = avg_rank[inv]
    auc = ((ranks[y == 1].sum() - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg)
           if n_pos > 0 and n_neg > 0 else 0.5)

    # ROC / KS / PR curves over sorted thresholds (descending)
    desc = np.argsort(-p, kind="mergesort")
    tp = np.cumsum(y[desc])
    fp = np.cumsum(1 - y[desc])
    tpr = tp / max(n_pos, 1)
    fpr = fp / max(n_neg, 1)
    ks = float(np.max(np.abs(tpr - fpr))) if len(p) else 0.0
    precision_curve = tp / np.maximum(tp + fp, 1)
    # PR AUC by step integration (average precision)
    dy = np.diff(np.concatenate([[0.0], tpr]))
    prc = float((precision_curve * dy).sum())

    # LiftChart per reference BinaryMetricsSummary.java:179,224: points
    # ((TP+FP)/total, TP) over descending-score thresholds, prepended (0,0).
    total = max(len(y), 1)
    depth = (tp + fp) / total
    lift_stride = max(1, len(depth) // 500)
    lift_x = np.concatenate([[0.0], depth[::lift_stride]])
    lift_y = np.concatenate([[0.0], tp[::lift_stride].astype(np.float64)])
    if len(depth) and (len(depth) - 1) % lift_stride:
        # striding dropped the terminal (depth=1, TP=n_pos) point
        lift_x = np.append(lift_x, depth[-1])
        lift_y = np.append(lift_y, float(tp[-1]))

    pred_pos = p >= threshold
    tp_ = int(((y == 1) & pred_pos).sum())
    fp_ = int(((y == 0) & pred_pos).sum())
    fn_ = int(((y == 1) & ~pred_pos).sum())
    tn_ = int(((y == 0) & ~pred_pos).sum())
    precision = tp_ / max(tp_ + fp_, 1)
    recall = tp_ / max(tp_ + fn_, 1)
    f1 = 2 * precision * recall / max(precision + recall, 1e-12)
    acc = (tp_ + tn_) / max(len(y), 1)
    eps = 1e-15
    pc = np.clip(p, eps, 1 - eps)
    logloss = float(-(y * np.log(pc) + (1 - y) * np.log(1 - pc)).mean()) if len(y) else 0.0

    return BinaryClassMetrics({
        "AUC": float(auc), "KS": ks, "PRC": prc, "Accuracy": float(acc),
        "Precision": float(precision), "Recall": float(recall), "F1": float(f1),
        "LogLoss": logloss, "TruePositive": tp_, "FalsePositive": fp_,
        "TrueNegative": tn_, "FalseNegative": fn_,
        "ConfusionMatrix": [[tp_, fp_], [fn_, tn_]],
        "PositiveValue": str(pos_value), "TotalSamples": len(y),
        "RocCurveTpr": tpr[:: max(1, len(tpr) // 500)].tolist(),
        "RocCurveFpr": fpr[:: max(1, len(fpr) // 500)].tolist(),
        "LiftChart": [lift_x.tolist(), lift_y.tolist()],
    })


def _eq(a, b) -> bool:
    return str(a) == str(b)
