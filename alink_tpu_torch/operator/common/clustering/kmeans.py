"""KMeans internals on the one-worker BSP engine.

Counterpart: ``alink_tpu/operator/common/clustering/kmeans.py`` (the
reference's common/clustering/kmeans/):

  KMeansPreallocateCentroid    -> the initial centroids: host random or
                                  k-means++ draws (numpy, copied), or the
                                  k-means|| BSP program
  KMeansAssignCluster          -> distances as one product
                                  (||x||^2 - 2 x.c + ||c||^2), argmin
                                  (first index on ties), and the k x (d+1)
                                  sum / weight buffer as the one-hot
                                  product ``onehot.T @ X``
  AllReduce(buf)               -> the identity at one worker
  KMeansUpdateCentroids        -> sums / weights
  KMeansIterTermination        -> centroid movement < tol, the one host
                                  read of a superstep

With health probes on (``ALINK_TPU_HEALTH``) the buffer carries one
extra row, the weighted inertia probe, as the JAX package's does; the
other rows are computed apart from it, so a run with probes gives the
centroids of a run without, bit for bit. The products are
``torch.matmul`` in the data's dtype (full float32 on the card:
``objfunc.check_full_float32``, once a training). k-means|| draws its
Gumbel keys from the superstep's generator (``ComContext.rng``), whose
draws differ from JAX's PRNG by design, so it agrees with the JAX
package in its properties, not its bits. EUCLIDEAN and COSINE distances.
The Lloyd loop takes superstep checkpoints and resumes from them
(``checkpoint_dir`` / ``resume_from``, ``engine/recovery.py``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ....common.mlenv import MLEnvironment
from ....engine import AllReduce, IterativeComQueue
from ..optim.objfunc import check_full_float32


def kmeans_plus_plus_init(X: np.ndarray, k: int, seed: int,
                          sample_cap: int = 4096) -> np.ndarray:
    """k-means++ seeding on a bounded host sample (reference KMeansInitCentroids
    K-MEANS|| has the same role: good seeds without a full device pass)."""
    rng = np.random.RandomState(seed)
    n = X.shape[0]
    if n > sample_cap:
        X = X[rng.choice(n, sample_cap, replace=False)]
        n = sample_cap
    cents = [X[rng.randint(n)]]
    d2 = ((X - cents[0]) ** 2).sum(1)
    for _ in range(1, k):
        tot = d2.sum()
        if tot <= 0:  # fewer distinct points than k: fall back to uniform
            cents.append(X[rng.randint(n)])
            continue
        cents.append(X[rng.choice(n, p=d2 / tot)])
        d2 = np.minimum(d2, ((X - cents[-1]) ** 2).sum(1))
    return np.stack(cents)


def random_init(X: np.ndarray, k: int, seed: int) -> np.ndarray:
    """``k`` rows of ``X`` drawn by numpy's ``RandomState(seed)``."""
    rng = np.random.RandomState(seed)
    return X[rng.choice(X.shape[0], k, replace=X.shape[0] < k)]


def _weighted_kmeans_pp(C: np.ndarray, w: np.ndarray, k: int,
                        rng: np.random.RandomState,
                        lloyd_iters: int = 8) -> np.ndarray:
    """Weighted k-means++ seeding + a few weighted Lloyd sweeps on the
    (small) candidate set — the K-MEANS|| recluster step (Bahmani et al.
    algorithm 2 line 7-8; reference KMeansInitCentroids final recluster).
    Runs on the host: the candidate set is O(rounds * oversample), never
    the data."""
    m = C.shape[0]
    w = np.maximum(np.asarray(w, np.float64), 0.0)
    if w.sum() <= 0:
        w = np.ones(m)
    p = w / w.sum()
    cents = [C[rng.choice(m, p=p)]]
    d2 = ((C - cents[0]) ** 2).sum(1)
    for _ in range(1, k):
        q = w * d2
        tot = q.sum()
        if tot <= 0:
            cents.append(C[rng.choice(m, p=p)])
            continue
        cents.append(C[rng.choice(m, p=q / tot)])
        d2 = np.minimum(d2, ((C - cents[-1]) ** 2).sum(1))
    cc = np.stack(cents)
    for _ in range(lloyd_iters):
        dist = ((C[:, None, :] - cc[None, :, :]) ** 2).sum(-1)
        ids = dist.argmin(1)
        for j in range(k):
            sel = ids == j
            if w[sel].sum() > 0:
                cc[j] = (C[sel] * w[sel, None]).sum(0) / w[sel].sum()
    return cc


def parallel_candidates(X: np.ndarray, k: int, seed: int = 0,
                        rounds: int = 5, oversample: Optional[int] = None,
                        env: Optional[MLEnvironment] = None):
    """The k-means|| candidate set as a BSP program: ``(cands (1 + rounds
    * l, d), weights, rng)``, ``rng`` the host generator after its first
    draw (the first candidate's row).

    Each superstep samples ``l = oversample`` new candidates with
    probability proportional to the squared distance to the candidate
    set (Gumbel-top-l over ``log d2``); each row's distance and nearest
    candidate update against only the l new ones. A candidate's weight is
    the number of rows nearest to it after the last fold (those of the
    final round count no rows yet)."""
    X = np.asarray(X)
    n, d = X.shape
    dt = torch.float64 if X.dtype == np.float64 else torch.float32
    l = int(oversample) if oversample else max(2 * k, 1)
    cap = 1 + rounds * l
    rng = np.random.RandomState(seed)
    first = X[rng.randint(n)]
    # one worker: its shard is all n rows, and the all-gather of its
    # proposals (keys and points) is the identity
    l_loc = min(l, n)
    tiny = torch.finfo(dt).tiny

    def sample(ctx):
        Xb = ctx.get_obj("X")
        msk = ctx.get_obj("mask")
        step = ctx.step_no
        if ctx.is_init_step:
            cands = torch.zeros((cap, d), dtype=dt, device=Xb.device)
            cands[0] = ctx.get_obj("first")
            d2 = ((Xb - cands[0]) ** 2).sum(1) * msk
            nearest = torch.zeros(n, dtype=torch.int64, device=Xb.device)
        else:
            cands = ctx.get_obj("cands")
            d2 = ctx.get_obj("d2")
            nearest = ctx.get_obj("nearest")
            # fold in the l candidates written by the previous superstep
            off = 1 + (step - 2) * l
            new = cands[off:off + l]
            Dn = ((Xb[:, None, :] - new[None, :, :]) ** 2).sum(-1)
            j = torch.argmin(Dn, 1)
            dn = Dn.gather(1, j[:, None])[:, 0] * msk
            closer = dn < d2
            nearest = torch.where(closer, off + j, nearest)
            d2 = torch.where(closer, dn, d2)
        # this round's l candidates: Gumbel-top-l over p_i ∝ d2_i
        u = torch.rand(d2.shape, generator=ctx.rng(), dtype=dt,
                       device=d2.device).clamp_(min=tiny)
        g = -torch.log(-torch.log(u))
        keys = torch.where(d2 > 0, torch.log(torch.clamp(d2, min=1e-30)) + g,
                           -torch.inf)
        kv, ki = torch.topk(keys, l_loc)
        sel = torch.where(torch.isfinite(kv)[:, None], Xb[ki], cands[0])
        if l_loc < l:                                       # pad to l rows
            sel = torch.cat([sel, cands[0].expand(l - l_loc, d)], 0)
        off_w = 1 + (step - 1) * l
        cands[off_w:off_w + l] = sel
        # candidate weights: rows nearest to each (the current assignment)
        counts = torch.zeros(cap, dtype=dt, device=d2.device).index_add_(
            0, nearest, msk)
        ctx.put_obj("weights", ctx.all_reduce_sum(counts))
        ctx.put_obj("cands", cands)
        ctx.put_obj("d2", d2)
        ctx.put_obj("nearest", nearest)

    res = (IterativeComQueue(env=env, max_iter=rounds, seed=seed)
           .init_with_partitioned_data("X", X)
           .init_with_partitioned_data("mask", np.ones(n, X.dtype))
           .init_with_broadcast_data("first", first)
           .add(sample)
           .exec())
    return np.asarray(res.get("cands")), np.array(res.get("weights")), rng


def kmeans_parallel_init(X: np.ndarray, k: int, seed: int = 0,
                         rounds: int = 5, oversample: Optional[int] = None,
                         env: Optional[MLEnvironment] = None) -> np.ndarray:
    """K-MEANS|| seeding (reference clustering/kmeans/
    KMeansInitCentroids.java; Bahmani et al. 2012): the candidates of
    :func:`parallel_candidates`, reclustered to k on the host by weighted
    k-means++ and a few weighted Lloyd sweeps."""
    cands, weights, rng = parallel_candidates(X, k, seed, rounds,
                                              oversample, env)
    # candidates sampled in the final round carry no counted weight yet;
    # give them each weight 1 so the recluster can still use them
    weights[weights == 0] = 1.0
    return _weighted_kmeans_pp(cands, weights, k, rng).astype(
        np.asarray(X).dtype)


def _distances(X, C, distance_type: str):
    """(n, k) distance matrix as one product."""
    if distance_type == "COSINE":
        Xn = X / torch.clamp(torch.linalg.vector_norm(X, dim=1, keepdim=True),
                             min=1e-12)
        Cn = C / torch.clamp(torch.linalg.vector_norm(C, dim=1, keepdim=True),
                             min=1e-12)
        return 1.0 - Xn @ Cn.T
    x2 = (X ** 2).sum(1, keepdim=True)
    c2 = (C ** 2).sum(1)
    return x2 - 2.0 * (X @ C.T) + c2


def assign_clusters(X, C, distance_type: str = "EUCLIDEAN"):
    """Nearest centroid ids (the first on ties) and distances for a
    block."""
    D = _distances(X, C, distance_type)
    ids = torch.argmin(D, 1)
    return ids, D.gather(1, ids[:, None])[:, 0]


def lloyd_buffer(block, C, k: int, distance_type: str, inertia: bool):
    """The assign half of a Lloyd superstep on a ``(n, d + 1)`` block
    (features, then the row weight): the ``(k, d + 1)`` buffer of the
    weighted sums and counts of each cluster's rows, and with
    ``inertia`` one more row holding the weighted inertia (padding rows
    have weight 0)."""
    d = block.shape[1] - 1
    Xb, wb = block[:, :d], block[:, d]
    ids, dist = assign_clusters(Xb, C, distance_type)
    onehot = torch.nn.functional.one_hot(ids, k).to(Xb.dtype) \
        * wb[:, None]                                           # (n, k)
    sums = onehot.T @ Xb                                        # (k, d)
    cnts = onehot.sum(0)                                        # (k,)
    buf = torch.cat([sums, cnts[:, None]], 1)
    if inertia:
        row = torch.cat([(dist * wb).sum().reshape(1, 1),
                         Xb.new_zeros((1, d))], 1)
        buf = torch.cat([buf, row], 0)
    return buf


def lloyd_update(buf, C, k: int):
    """The update half: the new centroids (an empty cluster keeps its
    old one), the largest centroid movement and the cluster weights."""
    d = C.shape[1]
    sums, cnts = buf[:k, :d], buf[:k, d]
    newC = torch.where(cnts[:, None] > 0,
                       sums / torch.clamp(cnts[:, None], min=1e-12), C)
    movement = torch.sqrt(((newC - C) ** 2).sum(1)).max()
    return newC, movement, cnts


def kmeans_train(X, k: int, max_iter: int = 50, tol: float = 1e-4,
                 distance_type: str = "EUCLIDEAN",
                 init: str = "K_MEANS_PARALLEL", seed: int = 0,
                 env: Optional[MLEnvironment] = None, sample_weight=None,
                 checkpoint_dir: Optional[str] = None,
                 checkpoint_every: int = 1, checkpoint_keep: int = 3,
                 resume_from: Optional[str] = None, health=None
                 ) -> Tuple[np.ndarray, np.ndarray, int]:
    """Returns (centroids (k,d), cluster_weights (k,), num_steps).

    ``X`` (n, d) float32 or float64 on the host; the Lloyd loop runs on
    ``env``'s device (float32 data on the card refuses TF32). RANDOM and
    K_MEANS_PLUS_PLUS draw their rows as the JAX package does (bit for
    bit); K_MEANS_PARALLEL (the default) runs
    :func:`kmeans_parallel_init`.

    ``checkpoint_dir=`` makes the Lloyd loop durable: the superstep carry
    (centroids, movement, the buffer, the probes) is snapshotted every
    ``checkpoint_every`` supersteps, and ``resume_from=`` re-enters a
    killed run with bitwise-identical final centroids and weights
    (``engine/recovery.py``). The k-means|| init queue is NOT
    checkpointed: it is short, and exact resume still holds because the
    init is deterministic in ``seed`` (a resumed run draws it again).

    ``health=`` attaches a ``common.health.HealthMonitor`` fed the Lloyd
    loop's probe series (``inertia``, ``movement``, ``empty_clusters``)
    after the run and at every checkpoint boundary; probes record only
    while ``ALINK_TPU_HEALTH`` is on."""
    X = np.asarray(X)
    d = X.shape[1]
    w = np.ones(X.shape[0], X.dtype) if sample_weight is None \
        else np.asarray(sample_weight, X.dtype)
    init_u = init.upper()
    if init_u == "RANDOM":
        init_c = random_init(X, k, seed)
    elif init_u in ("K_MEANS_PARALLEL", "KMEANS_PARALLEL"):
        init_c = kmeans_parallel_init(X, k, seed=seed, env=env)
    else:  # K_MEANS_PLUS_PLUS / legacy host seeding
        init_c = kmeans_plus_plus_init(X, k, seed)
    init_c = init_c.astype(X.dtype)
    data = np.concatenate([X, w[:, None]], axis=1)

    def assign(ctx):
        if ctx.is_entry_step:
            check_full_float32({"X": ctx.get_obj("data")})
        if ctx.is_init_step:
            C0 = ctx.get_obj("init_centroids")
            ctx.put_obj("centroids", C0)
            ctx.put_obj("movement", torch.full((), torch.inf, dtype=C0.dtype,
                                               device=C0.device))
        # the weighted inertia rides the buffer's AllReduce as one extra
        # row when the probes are on: a probe adds no collective of its own
        ctx.put_obj("buf", lloyd_buffer(ctx.get_obj("data"),
                                        ctx.get_obj("centroids"), k,
                                        distance_type, ctx.probes_enabled))

    def update(ctx):
        buf = ctx.get_obj("buf")
        C = ctx.get_obj("centroids")
        if ctx.probes_enabled:
            # pre-update inertia: the objective of the assignment the
            # centroids being replaced produced
            ctx.probe("inertia", buf[k, 0])
        newC, movement, cnts = lloyd_update(buf, C, k)
        ctx.put_obj("movement", movement)
        ctx.probe("movement", movement)
        ctx.probe("empty_clusters", (cnts <= 0).sum())
        ctx.put_obj("centroids", newC)
        ctx.put_obj("cluster_weights", cnts)

    queue = (IterativeComQueue(env=env, max_iter=max_iter, seed=seed)
             .init_with_partitioned_data("data", data)
             .init_with_broadcast_data("init_centroids", init_c)
             .add(assign)
             .add(AllReduce("buf"))
             .add(update)
             .set_compare_criterion(
                 lambda ctx: ctx.get_obj("movement") < tol)
             .set_program_key(("kmeans", k, d, distance_type, float(tol),
                               str(X.dtype))))
    if checkpoint_dir:
        # knob validation (every/keep_last >= 1) lives in CheckpointConfig
        queue.set_checkpoint(checkpoint_dir, every=int(checkpoint_every),
                             keep_last=int(checkpoint_keep),
                             resume_from=resume_from)
    elif resume_from:
        raise ValueError("resume_from requires checkpoint_dir (an explicit "
                         "resume request must not silently retrain)")
    if health is not None:
        from ....common.health import warn_if_disabled
        warn_if_disabled("kmeans_train(health=...)", stacklevel=3)
        queue.set_health(health)
    result = queue.exec()
    return (result.get("centroids"), result.get("cluster_weights"),
            result.step_count)
