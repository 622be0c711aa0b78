"""Evaluation metric internals.

Counterpart: ``alink_tpu/operator/common/evaluation/metrics.py``.
Copied (the module is numpy only): ``BaseMetrics``; ``binary_metrics``
(the reference's BinaryMetricsSummary: AUC by the rank statistic, KS,
PRC, the lift chart and the threshold metrics); ``multiclass_metrics``
(MultiMetricsSummary: the confusion matrix, macro, weighted and micro
statistics, kappa, log loss from details); ``regression_metrics``
(RegressionMetricsSummary: SSE, MSE, RMSE, MAE, R2, MAPE);
``cluster_metrics`` (ClusterMetricsSummary: Calinski-Harabasz,
Davies-Bouldin, the silhouette on a bounded sample, and purity, NMI and
ARI against true labels), with their metrics classes.
"""

from __future__ import annotations

import json
from typing import Dict, Optional, Sequence

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


class MultiClassMetrics(BaseMetrics):
    pass


class RegressionMetrics(BaseMetrics):
    pass


class ClusterMetrics(BaseMetrics):
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


def multiclass_metrics(labels: Sequence, preds: Sequence,
                       details: Optional[Sequence[str]] = None) -> MultiClassMetrics:
    """reference MultiMetricsSummary: confusion matrix + macro/micro stats."""
    classes = sorted({str(v) for v in labels} | {str(v) for v in preds})
    idx = {c: i for i, c in enumerate(classes)}
    k = len(classes)
    cm = np.zeros((k, k), np.int64)
    for l, pr in zip(labels, preds):
        cm[idx[str(l)], idx[str(pr)]] += 1
    n = cm.sum()
    tp = np.diag(cm).astype(np.float64)
    row = cm.sum(1).astype(np.float64)  # actual
    col = cm.sum(0).astype(np.float64)  # predicted
    prec = tp / np.maximum(col, 1)
    rec = tp / np.maximum(row, 1)
    f1 = 2 * prec * rec / np.maximum(prec + rec, 1e-12)
    acc = float(tp.sum() / max(n, 1))
    pe = float((row * col).sum() / max(n * n, 1))
    kappa = (acc - pe) / max(1 - pe, 1e-12)
    wts = row / max(n, 1)
    out = {
        "Accuracy": acc, "Kappa": float(kappa),
        "MacroPrecision": float(prec.mean()), "MacroRecall": float(rec.mean()),
        "MacroF1": float(f1.mean()),
        "WeightedPrecision": float((prec * wts).sum()),
        "WeightedRecall": float((rec * wts).sum()),
        "WeightedF1": float((f1 * wts).sum()),
        "MicroPrecision": acc, "MicroRecall": acc, "MicroF1": acc,
        "ConfusionMatrix": cm.tolist(), "LabelList": classes,
        "TotalSamples": int(n),
    }
    if details is not None:
        eps = 1e-15
        ll = []
        for l, det in zip(labels, details):
            try:
                probs = json.loads(det)
                ll.append(-np.log(max(float(probs.get(str(l), eps)), eps)))
            except (TypeError, ValueError):
                continue
        if ll:
            out["LogLoss"] = float(np.mean(ll))
    return MultiClassMetrics(out)


def regression_metrics(y_true: np.ndarray, y_pred: np.ndarray) -> RegressionMetrics:
    """reference RegressionMetricsSummary."""
    y = np.asarray(y_true, np.float64)
    p = np.asarray(y_pred, np.float64)
    n = len(y)
    err = p - y
    sse = float((err ** 2).sum())
    mse = sse / max(n, 1)
    mae = float(np.abs(err).mean()) if n else 0.0
    ybar = float(y.mean()) if n else 0.0
    sst = float(((y - ybar) ** 2).sum())
    ssr = float(((p - ybar) ** 2).sum())
    r2 = 1.0 - sse / max(sst, 1e-12)
    mape = float((np.abs(err) / np.maximum(np.abs(y), 1e-12)).mean() * 100) if n else 0.0
    return RegressionMetrics({
        "Count": n, "SSE": sse, "SST": sst, "SSR": ssr, "MSE": mse,
        "RMSE": float(np.sqrt(mse)), "MAE": mae, "R2": float(r2), "MAPE": mape,
        "ExplainedVariance": float(ssr / max(n, 1)),
    })


def cluster_metrics(X: np.ndarray, assignment: np.ndarray,
                    labels: Optional[Sequence] = None) -> ClusterMetrics:
    """reference ClusterMetricsSummary: CH / DB / silhouette (+purity/NMI/ARI
    when true labels supplied)."""
    a = np.asarray(assignment)
    clusters = sorted(set(a.tolist()))
    k = len(clusters)
    n = len(a)
    out: Dict = {"K": k, "Count": n,
                 "ClusterArray": [int((a == c).sum()) for c in clusters]}
    if X is not None:
        X = np.asarray(X, np.float64)
    if X is not None and k >= 1 and n > k:
        cents = np.stack([X[a == c].mean(0) for c in clusters])
        gmean = X.mean(0)
        sizes = np.asarray([(a == c).sum() for c in clusters], np.float64)
        ssb = float((sizes * ((cents - gmean) ** 2).sum(1)).sum())
        ssw = float(sum(((X[a == c] - cents[i]) ** 2).sum()
                        for i, c in enumerate(clusters)))
        out["SSB"] = ssb
        out["SSW"] = ssw
        out["CalinskiHarabasz"] = (ssb / max(k - 1, 1)) / max(ssw / max(n - k, 1), 1e-12)
        # Davies-Bouldin
        scatter = np.asarray([np.sqrt(((X[a == c] - cents[i]) ** 2).sum(1)).mean()
                              for i, c in enumerate(clusters)])
        db = 0.0
        if k > 1:
            for i in range(k):
                dists = np.sqrt(((cents[i] - cents) ** 2).sum(1))
                ratios = [(scatter[i] + scatter[j]) / max(dists[j], 1e-12)
                          for j in range(k) if j != i]
                db += max(ratios)
            out["DaviesBouldin"] = db / k
        # silhouette on a bounded sample
        m = min(n, 2000)
        sel = np.linspace(0, n - 1, m).astype(int)
        D = np.sqrt(((X[sel, None, :] - X[None, sel, :]) ** 2).sum(-1))
        sil = []
        asel = a[sel]
        for i in range(m):
            same = asel == asel[i]
            same[i] = False
            ai = D[i][same].mean() if same.any() else 0.0
            bs = [D[i][asel == c].mean() for c in clusters
                  if c != asel[i] and (asel == c).any()]
            bi = min(bs) if bs else 0.0
            sil.append((bi - ai) / max(ai, bi, 1e-12))
        out["SilhouetteCoefficient"] = float(np.mean(sil)) if sil else 0.0
    if labels is not None:
        out.update(_external_cluster_metrics(labels, a))
    return ClusterMetrics(out)


def _external_cluster_metrics(labels, a) -> Dict:
    ls = [str(v) for v in labels]
    classes = sorted(set(ls))
    clusters = sorted(set(a.tolist()))
    n = len(ls)
    cont = np.zeros((len(clusters), len(classes)), np.float64)
    for ai, li in zip(a, ls):
        cont[clusters.index(ai), classes.index(li)] += 1
    purity = cont.max(1).sum() / max(n, 1)
    # NMI
    pij = cont / n
    pi = pij.sum(1, keepdims=True)
    pj = pij.sum(0, keepdims=True)
    nz = pij > 0
    mi = (pij[nz] * np.log(pij[nz] / (pi @ pj)[nz])).sum()
    hi = -(pi[pi > 0] * np.log(pi[pi > 0])).sum()
    hj = -(pj[pj > 0] * np.log(pj[pj > 0])).sum()
    nmi = mi / max(np.sqrt(hi * hj), 1e-12)
    # ARI
    comb = lambda x: x * (x - 1) / 2.0  # noqa: E731
    sum_ij = comb(cont).sum()
    sum_i = comb(cont.sum(1)).sum()
    sum_j = comb(cont.sum(0)).sum()
    expected = sum_i * sum_j / max(comb(n), 1e-12)
    max_index = (sum_i + sum_j) / 2.0
    ari = (sum_ij - expected) / max(max_index - expected, 1e-12)
    return {"Purity": float(purity), "NMI": float(nmi), "ARI": float(ari)}


def _eq(a, b) -> bool:
    return str(a) == str(b)
