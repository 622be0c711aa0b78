"""String similarity metrics.

Counterpart: ``alink_tpu/operator/common/similarity/metrics.py`` (a copy),
the re-design of common/similarity/ (Levenshtein family, LCS, SSK,
Jaccard, Cosine over char n-grams, SimHash hamming: the metric set
behind the reference's StringSimilarityPairwise /
TextSimilarityPairwise ops). Host functions; ``simhash`` hashes with
the port's own ``murmur32`` (``batch/feature/feature_ops.py``), each
distinct n-gram once (a cache), and counts each bit's votes in one numpy
sum (the same bits as the JAX package's per-bit loop).
"""


from __future__ import annotations

import functools
from typing import Callable, List, Sequence

import numpy as np

from ...batch.feature.feature_ops import murmur32


def levenshtein(a: str, b: str) -> int:
    m, n = len(a), len(b)
    if m == 0 or n == 0:
        return max(m, n)
    prev = list(range(n + 1))
    for i in range(1, m + 1):
        cur = [i] + [0] * n
        ai = a[i - 1]
        for j in range(1, n + 1):
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1,
                         prev[j - 1] + (ai != b[j - 1]))
        prev = cur
    return prev[n]


def levenshtein_sim(a: str, b: str) -> float:
    denom = max(len(a), len(b))
    return 1.0 - levenshtein(a, b) / denom if denom else 1.0


def lcs(a: str, b: str) -> int:
    """Longest common subsequence length."""
    m, n = len(a), len(b)
    if m == 0 or n == 0:
        return 0
    prev = [0] * (n + 1)
    for i in range(1, m + 1):
        cur = [0] * (n + 1)
        ai = a[i - 1]
        for j in range(1, n + 1):
            cur[j] = prev[j - 1] + 1 if ai == b[j - 1] else max(prev[j], cur[j - 1])
        prev = cur
    return prev[n]


def lcs_sim(a: str, b: str) -> float:
    denom = max(len(a), len(b))
    return lcs(a, b) / denom if denom else 1.0


def _ngrams(s: str, n: int) -> List[str]:
    if len(s) < n:
        return [s] if s else []
    return [s[i:i + n] for i in range(len(s) - n + 1)]


def jaccard_sim(a: str, b: str, n: int = 2) -> float:
    A, B = set(_ngrams(a, n)), set(_ngrams(b, n))
    if not A and not B:
        return 1.0
    u = len(A | B)
    return len(A & B) / u if u else 0.0


def cosine_sim(a: str, b: str, n: int = 2) -> float:
    from collections import Counter
    A, B = Counter(_ngrams(a, n)), Counter(_ngrams(b, n))
    if not A or not B:
        return 1.0 if (not A and not B) else 0.0
    common = set(A) & set(B)
    dot = sum(A[g] * B[g] for g in common)
    na = np.sqrt(sum(v * v for v in A.values()))
    nb = np.sqrt(sum(v * v for v in B.values()))
    return float(dot / (na * nb)) if na and nb else 0.0


@functools.lru_cache(maxsize=1 << 16)
def _gram_hash(g: str) -> int:
    """An n-gram's 64-bit hash: two murmur32s (seeds 0 and 7)."""
    b = g.encode("utf-8")
    return murmur32(b) | (murmur32(b, 7) << 32)


def simhash(s: str, n: int = 2, bits: int = 64) -> int:
    """Bit ``i`` is set where more of the n-grams' 64-bit hashes have it
    set than not (the JAX package's vote, one numpy sum over the grams;
    bits past 64 are never set)."""
    grams = _ngrams(s, n)
    if not grams:
        return 0
    h = np.fromiter(map(_gram_hash, grams), np.uint64, len(grams))
    shifts = np.arange(min(bits, 64), dtype=np.uint64)
    ones = ((h[:, None] >> shifts) & np.uint64(1)).astype(np.int64).sum(0)
    return sum(1 << int(i) for i in np.flatnonzero(2 * ones > len(grams)))


def simhash_hamming_sim(a: str, b: str, n: int = 2) -> float:
    d = bin(simhash(a, n) ^ simhash(b, n)).count("1")
    return 1.0 - d / 64.0


SIMILARITY_FUNCS: dict = {
    "LEVENSHTEIN": lambda a, b: float(levenshtein(a, b)),
    "LEVENSHTEIN_SIM": levenshtein_sim,
    "LCS": lambda a, b: float(lcs(a, b)),
    "LCS_SIM": lcs_sim,
    "JACCARD_SIM": jaccard_sim,
    "COSINE": cosine_sim,
    "SIMHASH_HAMMING": lambda a, b: float(
        bin(simhash(a) ^ simhash(b)).count("1")),
    "SIMHASH_HAMMING_SIM": simhash_hamming_sim,
}
