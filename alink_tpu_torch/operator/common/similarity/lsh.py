"""Locality-sensitive hashing for approximate vector similarity joins.

Counterpart: ``alink_tpu/operator/common/similarity/lsh.py``, the
re-design of common/feature/BaseLSH + MinHashLSH +
BucketRandomProjectionLSH and batch/similarity/
ApproxVectorSimilarityJoinLSHBatchOp / TopNLSHBatchOp.

``BucketRandomProjectionLSH.hash`` is one float64 product on ``device``
(``cuda`` unless the caller asks for the CPU; raises without it):
``floor((X @ W + b) / bucket_width)``; ``W`` and ``b`` are drawn on the
host from ``RandomState(seed)`` as in the JAX package. The card sums the
product in another order than the CPU, so a projection within a rounding
of a multiple of ``bucket_width`` may floor into the neighbouring bucket
(``projections`` gives the values before the floor, to find such
edges). MinHash, the buckets, the exact re-score and the filter stay on
the host (:func:`bucket_candidates` groups the Euclidean buckets by a
numpy sort: the candidates of the JAX package's dict of key tuples, in
ascending order). ``approx_join(..., stages=d)`` adds the seconds of its
stages (the dense rows, the hash, the bucket build, the re-score) to
``d``.
"""


from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

import time

import torch

from ....common.device import resolve_device
from ....common.mtable import MTable
from ....common.vector import DenseVector, SparseVector, VectorUtil


def _to_dense(vecs, dim: Optional[int] = None) -> np.ndarray:
    parsed = [VectorUtil.parse(v) for v in vecs]
    if dim is None:
        dim = 0
        for v in parsed:
            dim = max(dim, v.size() if isinstance(v, DenseVector)
                      else (v.n if v.n >= 0 else int(v.indices[-1]) + 1))
    X = np.zeros((len(parsed), dim))
    for i, v in enumerate(parsed):
        if isinstance(v, DenseVector):
            X[i, :v.size()] = v.data
        else:
            X[i, v.indices.astype(int)] = v.values
    return X


class BucketRandomProjectionLSH:
    """Euclidean-distance LSH: h(x) = floor((x·w + b) / bucket_width)
    (reference common/feature/BucketRandomProjectionLSH)."""

    def __init__(self, dim: int, num_projections: int = 10,
                 num_hash_tables: int = 2, bucket_width: float = 1.0,
                 seed: int = 0, device=None):
        self.device = resolve_device(device)
        rng = np.random.RandomState(seed)
        self.W = rng.randn(dim, num_hash_tables * num_projections)
        self.b = rng.rand(num_hash_tables * num_projections) * bucket_width
        self.bucket_width = bucket_width
        self.num_tables = num_hash_tables
        self.num_proj = num_projections

    def projections(self, X: np.ndarray) -> torch.Tensor:
        """``(X @ W + b) / bucket_width`` (n, tables * proj), float64 on
        the device: the bucket ids before their floor."""
        def dev(a):
            return torch.from_numpy(np.asarray(a, np.float64)).to(self.device)
        return (dev(X) @ dev(self.W) + dev(self.b)) / self.bucket_width

    def hash(self, X: np.ndarray) -> np.ndarray:
        """(n, tables, proj) integer bucket ids — one device matmul."""
        H = torch.floor(self.projections(X)).to(torch.int64).cpu().numpy()
        return H.reshape(X.shape[0], self.num_tables, self.num_proj)

    def keys(self, X: np.ndarray) -> List[List[Tuple]]:
        """Each row's bucket key a table (tuples of Python ints: they
        hash and compare as the JAX package's numpy ids do)."""
        return [[tuple(t) for t in row] for row in self.hash(X).tolist()]

    @staticmethod
    def distance(a: np.ndarray, B: np.ndarray) -> np.ndarray:
        return np.linalg.norm(B - a, axis=-1)


class MinHashLSH:
    """Jaccard-distance LSH over the non-zero index set
    (reference common/feature/MinHashLSH)."""

    PRIME = (1 << 31) - 1

    def __init__(self, num_hash: int = 16, num_bands: int = 4, seed: int = 0):
        rng = np.random.RandomState(seed)
        self.a = rng.randint(1, self.PRIME, size=num_hash).astype(np.int64)
        self.b = rng.randint(0, self.PRIME, size=num_hash).astype(np.int64)
        self.num_hash = num_hash
        self.num_bands = num_bands

    def signature(self, active: Sequence[int]) -> np.ndarray:
        if len(active) == 0:
            return np.full(self.num_hash, self.PRIME, np.int64)
        idx = np.asarray(list(active), np.int64)[:, None]
        h = (self.a * (idx + 1) + self.b) % self.PRIME
        return h.min(axis=0)

    def keys_for(self, active: Sequence[int]) -> List[Tuple]:
        sig = self.signature(active)
        per = max(1, self.num_hash // self.num_bands)
        return [tuple(sig[t * per:(t + 1) * per]) for t in range(self.num_bands)]

    @staticmethod
    def jaccard_dist(a: set, b: set) -> float:
        if not a and not b:
            return 0.0
        u = len(a | b)
        return 1.0 - (len(a & b) / u if u else 0.0)


def approx_join(left: MTable, right: MTable, left_col: str, right_col: str,
                left_id: str, right_id: str, threshold: float,
                metric: str = "EUCLIDEAN", top_n: Optional[int] = None,
                seed: int = 0, device=None,
                stages: Optional[Dict[str, float]] = None,
                **lsh_kw) -> List[Tuple]:
    """Candidate pairs via shared LSH buckets, exact re-score, filter.

    Returns rows (left_id, right_id, distance). ``top_n`` keeps the N
    nearest rights per left (TopN variant); otherwise threshold filter
    (Join variant). The Euclidean hash runs on ``device``; ``stages``
    (a dict) gains the seconds of ``extract`` (the dense rows),
    ``hash``, ``buckets`` and ``rescore``.
    """
    clock = _StageClock(stages)
    lv, rv = left.col(left_col), right.col(right_col)
    if metric.upper() == "JACCARD":
        lsh = MinHashLSH(seed=seed, **lsh_kw)

        def active_set(x):
            v = VectorUtil.parse(x)
            if isinstance(v, SparseVector):
                return set(v.indices.astype(int))
            return set(np.nonzero(np.asarray(v.data))[0])

        lsets = [active_set(x) for x in lv]
        rsets = [active_set(x) for x in rv]
        clock.lap("extract")
        buckets: Dict[Tuple, List[int]] = {}
        for j, s in enumerate(rsets):
            for t, key in enumerate(lsh.keys_for(s)):
                buckets.setdefault((t, key), []).append(j)
        clock.lap("buckets")
        out = []
        for i, s in enumerate(lsets):
            cands = set()
            for t, key in enumerate(lsh.keys_for(s)):
                cands.update(buckets.get((t, key), ()))
            scored = [(left.col(left_id)[i], right.col(right_id)[j],
                       lsh.jaccard_dist(s, rsets[j])) for j in cands]
            out.extend(_pick(scored, threshold, top_n))
        clock.lap("rescore")
        return out

    X, Y = _to_dense(lv), _to_dense(rv)
    d = max(X.shape[1], Y.shape[1])
    if X.shape[1] < d:
        X = np.pad(X, ((0, 0), (0, d - X.shape[1])))
    if Y.shape[1] < d:
        Y = np.pad(Y, ((0, 0), (0, d - Y.shape[1])))
    lsh = BucketRandomProjectionLSH(d, seed=seed, device=device, **lsh_kw)
    clock.lap("extract")
    HY, HX = lsh.hash(Y), lsh.hash(X)
    clock.lap("hash")
    cands = bucket_candidates(HY, HX)
    clock.lap("buckets")
    out = []
    for i, js in enumerate(cands):
        if not js.size:
            continue
        dist = lsh.distance(X[i], Y[js])
        scored = [(left.col(left_id)[i], right.col(right_id)[j], float(dv))
                  for j, dv in zip(js, dist)]
        out.extend(_pick(scored, threshold, top_n))
    clock.lap("rescore")
    return out


def bucket_candidates(HY: np.ndarray, HX: np.ndarray) -> List[np.ndarray]:
    """For each left row (``HX``: (m, tables, proj) bucket ids), the right
    rows (``HY``: (n, tables, proj)) that share its bucket in any table,
    ascending: one grouping of the bucket keys a table (a lexicographic
    sort of the key rows), then a slice of the rights sorted by group."""
    n = HY.shape[0]
    slices = []
    for t in range(HY.shape[1]):
        keys = np.concatenate([HY[:, t], HX[:, t]])
        by_key = np.lexsort(keys.T[::-1])
        ranked = keys[by_key]
        new = np.ones(len(keys), bool)
        new[1:] = (ranked[1:] != ranked[:-1]).any(1)
        g = np.empty(len(keys), np.int64)
        g[by_key] = np.cumsum(new) - 1
        order = np.argsort(g[:n], kind="stable")
        by_group = g[:n][order]
        lo = np.searchsorted(by_group, g[n:], "left")
        hi = np.searchsorted(by_group, g[n:], "right")
        slices.append((order, lo, hi))
    return [np.unique(np.concatenate([order[lo[i]:hi[i]]
                                      for order, lo, hi in slices]))
            for i in range(HX.shape[0])]


class _StageClock:
    """Adds the seconds since the last lap to ``stages[name]``."""

    def __init__(self, stages: Optional[Dict[str, float]]):
        self.stages = stages
        self.t = time.perf_counter()

    def lap(self, name: str) -> None:
        now = time.perf_counter()
        if self.stages is not None:
            self.stages[name] = self.stages.get(name, 0.0) + now - self.t
        self.t = now


def _pick(scored: List[Tuple], threshold: float, top_n: Optional[int]):
    if top_n is not None:
        return sorted(scored, key=lambda r: r[2])[:top_n]
    return [r for r in scored if r[2] <= threshold]
