"""Hypothesis tests and correlation.

Counterpart: ``alink_tpu/operator/common/statistics/hypothesis.py`` (a
copy: the file is host numpy, and the port keeps its own so that it
never imports the JAX package). Re-design of common/statistics/
ChiSquareTest, Correlation (Pearson + SpearmanCorrelation.java); chi2
p-values via the regularized upper incomplete gamma.
"""


from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np


def _gammainc_upper_reg(s: float, x: float) -> float:
    """Q(s, x) = Gamma(s,x)/Gamma(s); series/continued-fraction split."""
    if x < 0 or s <= 0:
        return float("nan")
    if x == 0:
        return 1.0
    if x < s + 1:
        # lower series
        term = 1.0 / s
        total = term
        n = s
        for _ in range(500):
            n += 1
            term *= x / n
            total += term
            if abs(term) < abs(total) * 1e-15:
                break
        p = total * math.exp(-x + s * math.log(x) - math.lgamma(s))
        return max(0.0, 1.0 - p)
    # continued fraction (Lentz)
    tiny = 1e-300
    b = x + 1 - s
    c = 1 / tiny
    d = 1 / b
    h = d
    for i in range(1, 500):
        an = -i * (i - s)
        b += 2
        d = an * d + b
        d = tiny if abs(d) < tiny else d
        c = b + an / c
        c = tiny if abs(c) < tiny else c
        d = 1 / d
        delta = d * c
        h *= delta
        if abs(delta - 1.0) < 1e-15:
            break
    return h * math.exp(-x + s * math.log(x) - math.lgamma(s))


def chi2_sf(x: float, df: int) -> float:
    """P(X > x) for chi-square with df degrees of freedom."""
    return _gammainc_upper_reg(df / 2.0, x / 2.0)


def chi_square_test(col: Sequence, label: Sequence) -> Tuple[float, float, int]:
    """Independence test of a (categorical) column vs the label.

    Returns (chi2, p_value, df). reference: common/statistics/ChiSquareTest.
    """
    xs = [str(v) for v in col]
    ys = [str(v) for v in label]
    xv = sorted(set(xs))
    yv = sorted(set(ys))
    xi = {v: i for i, v in enumerate(xv)}
    yi = {v: i for i, v in enumerate(yv)}
    obs = np.zeros((len(xv), len(yv)))
    for a, b in zip(xs, ys):
        obs[xi[a], yi[b]] += 1
    n = obs.sum()
    exp = np.outer(obs.sum(1), obs.sum(0)) / max(n, 1e-300)
    mask = exp > 0
    chi2 = float(((obs - exp) ** 2 / np.where(mask, exp, 1))[mask].sum())
    df = max((len(xv) - 1) * (len(yv) - 1), 1)
    return chi2, chi2_sf(chi2, df), df


def pearson_corr(X: np.ndarray) -> np.ndarray:
    """Pearson correlation matrix of columns."""
    X = np.asarray(X, np.float64)
    Xc = X - X.mean(0)
    std = Xc.std(0)
    std = np.where(std < 1e-300, 1.0, std)
    C = (Xc / std).T @ (Xc / std) / max(X.shape[0], 1)
    np.fill_diagonal(C, 1.0)
    return np.clip(C, -1.0, 1.0)


def _ranks(v: np.ndarray) -> np.ndarray:
    order = np.argsort(v, kind="mergesort")
    ranks = np.empty(len(v), np.float64)
    sv = v[order]
    uniq, inv, counts = np.unique(sv, return_inverse=True, return_counts=True)
    csum = np.cumsum(counts)
    avg = csum - (counts - 1) / 2.0
    ranks[order] = avg[inv]
    return ranks


def spearman_corr(X: np.ndarray) -> np.ndarray:
    """Spearman rank correlation (reference SpearmanCorrelation.java)."""
    R = np.stack([_ranks(X[:, j]) for j in range(X.shape[1])], axis=1)
    return pearson_corr(R)
