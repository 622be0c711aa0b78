#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``alink_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases, none wrapped in ``try``; any failure or mismatch exits non-zero:

1. the card: ``nvidia-smi`` name and power limit (fails without CUDA);
2. the build of every CUDA source under ``alink_tpu_torch/kernels/csrc``
   (``nvcc``, at first use, into ``build/``);
3. each kernel against its plain PyTorch version on the card, at the
   main path's shapes, in every mode (f32, f64, bf16, int8): bitwise.
   Kernel, plain-version and library-call times (CUDA events, median
   after warm-up) and each kernel's bound;
4. the main path at full width: a Criteo-shape hashed LR model (39
   non-zeros per row over 2^20 features plus an intercept, random
   coefficients from ``--seed``) saved through the port's model table,
   loaded by ``LinearModelMapper`` and served by ``CompiledPredictor``
   on ``cuda`` — 4096 request rows through ``predict_table`` and 64
   single-row requests through ``PredictServer`` from 4 threads — then
   a dense 1024-wide model through ``predict_table``. Scores and labels
   must equal the same predictor on the CPU bit for bit, and each
   kernel's launch count must have moved during its path;
5. per-bucket latency (p50 of ``predict_table``) and rows/s, and the
   split of one 512-row dispatch into encode, copy in, kernel, fetch
   and decode;
6. the FTRL state kernels (gather, scatter-add, chained correction)
   against their plain versions on the card, f32 and f64, at the shapes
   the three update modes launch, with duplicate-heavy slots, a
   ``-0.0`` slot and padded zeros at slot 0: bitwise. Kernel,
   plain-version and library-call times and each kernel's bound;
7. the FTRL main path at full width: Criteo-shape one-hot rows (39
   distinct slots of 2^20 plus the intercept, ``bench.py``'s
   ``make_batch_criteo`` generator, labels from a seeded sparse true
   model) in 4096-row micro-batches. ``FtrlTrainStreamOp`` in
   ``update_mode="sample"`` warm-starts from a model table and trains
   6 micro-batches with a snapshot every 2; ``FtrlPredictStreamOp``
   scores a held-out stream with the hot-swapped snapshots; the last
   snapshot swapped into ``CompiledPredictor`` gives the same labels.
   Then 2 micro-batches each of ``staleness`` (K = 32) and ``chained``
   (K = 16). Every mode on the card in float64 agrees with the same
   trainer on the CPU at rtol 1e-10. Launch counts, samples/s per mode,
   the split of one micro-batch (encode, copy in, step, snapshot), the
   card's busy share from a profiler trace, and the progressive log
   loss;
8. an out-of-range slot handed to the gather and to the scatter-add
   kernel fails its device-side assert, and the stream raises at its
   next synchronize (each in a process of its own).

The line before the last is the kernels' JSON record, the one before it
the main paths' numbers; the last line is ``{"ok": true, "device":
{...}}``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np

# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): HBM3 bytes/s,
# float32 and float64 outside the tensor cores, ops/s
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = {"f32": 67e12, "f64": 34e12, "bf16": 67e12, "int8": 67e12}
DENSE_SHAPE = (512, 1024)             # the top bucket x the dense model's dim8
SPARSE_ROWS, NNZ, FEATURES = 512, 39, 1 << 20
N_REQUESTS, N_SINGLE, CLIENTS = 4096, 64, 4
MODES = (("f32", "f32"), ("f64", "f32"), ("bf16", "bf16"), ("int8", "int8"))
SRC = "alink_tpu_torch/kernels/csrc/serve_score.cu"
FTRL_SRC = "alink_tpu_torch/kernels/csrc/ftrl_state.cu"
# FTRL main path: bench.py's Criteo shape and hyperparameters
FTRL_HP = dict(alpha=0.05, beta=1.0, l1=1e-5, l2=1e-5)
FTRL_BATCH, FTRL_TRAIN_BATCHES, FTRL_HELD_BATCHES = 4096, 6, 8
FTRL_WIDTH = -(-(NNZ + 1) // 8) * 8          # 39 slots + intercept -> 40
STALE_K, CHAIN_K = 32, 16
FTRL_M = {"sample": 4 * FTRL_WIDTH, "staleness": STALE_K * FTRL_WIDTH,
          "chained": CHAIN_K * FTRL_WIDTH}


def require(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def bits(t):
    import torch
    return t.view(torch.int64 if t.dtype == torch.float64 else torch.int32)


def cuda_ms(fn, trials: int = 15, reps: int = 20) -> float:
    """Median over ``trials`` of the mean time of ``reps`` back-to-back
    calls, by CUDA events, after a warm-up."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(trials):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(reps):
            fn()
        t1.record()
        t1.synchronize()
        times.append(t0.elapsed_time(t1) / reps)
    return float(np.median(times))


def host_p50_ms(fn, reps: int) -> float:
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def criteo_rows(rng, n):
    """Criteo-shape hashed rows: 13 integer fields (log-scaled counts)
    and 26 one-hot categorical fields, each hashed to a distinct slot
    of 2^20."""
    idx = np.empty((n, NNZ), np.int64)
    for i in range(n):
        idx[i] = rng.choice(FEATURES, NNZ, replace=False)
    val = np.ones((n, NNZ))
    val[:, :13] = np.log1p(rng.poisson(3.0, (n, 13)))
    return idx, val


def model_arrays(ks, w, b, mode, dev):
    if mode == "f32":
        return (w.to(dev), b.to(dev))
    if mode == "f64":
        return (w.double().to(dev), b.double().to(dev))
    return tuple(a.to(dev) for a in ks.lowp_model_arrays(w.numpy(),
                                                          b.numpy(), mode))


def phase_kernels(ks, rng, dev):
    """Each kernel against its plain version at the main path's shapes."""
    import torch
    import torch.nn.functional as F
    n, dim = DENSE_SHAPE
    Xh = torch.from_numpy(rng.standard_normal((n, dim)).astype(np.float32))
    wd = torch.from_numpy((rng.standard_normal(dim) * 0.05).astype(np.float32))
    ws = torch.from_numpy((rng.standard_normal(FEATURES) * 0.05)
                          .astype(np.float32))
    b = torch.tensor(0.125, dtype=torch.float32)
    idx0, val0 = criteo_rows(rng, SPARSE_ROWS)
    width = -(-NNZ // 8) * 8             # the encoder's width: 39 -> 40
    idx = torch.zeros((SPARSE_ROWS, width), dtype=torch.int32)
    val = torch.zeros((SPARSE_ROWS, width), dtype=torch.float32)
    idx[:, :NNZ] = torch.from_numpy(idx0)
    val[:, :NNZ] = torch.from_numpy(val0)
    out = {"serve_dense": {}, "serve_sparse": {}}
    for mode, sdtype in MODES:
        ship = torch.float64 if mode == "f64" else torch.float32
        X, v, i = Xh.to(dev, ship), val.to(dev, ship), idx.to(dev)
        md = model_arrays(ks, wd, b, mode, dev)
        msp = model_arrays(ks, ws, b, mode, dev)
        for name, kern, plain, args in (
                ("serve_dense", ks.dense_scores, ks.dense_scores_plain,
                 (md, X, sdtype)),
                ("serve_sparse", ks.sparse_scores, ks.sparse_scores_plain,
                 (msp, i, v, sdtype))):
            got = kern(*args)
            want = plain(*args)
            torch.cuda.synchronize()
            same = bool(torch.equal(bits(got), bits(want)))
            err = float((got.double() - want.double()).abs().max())
            require(bool(torch.isfinite(got).all()), f"{name} {mode} finite")
            require(same, f"{name} {mode} bitwise vs its plain version "
                          f"(max abs err {err})")
            rec = {"bitwise": same, "max_abs_err": err,
                   "kernel_ms": cuda_ms(lambda: kern(*args))}
            if mode == "f32":
                rec["plain_ms"] = cuda_ms(lambda: plain(*args), trials=5,
                                          reps=2)
                if name == "serve_dense":
                    lib = lambda: torch.mv(X, md[0])             # noqa: E731
                    nbytes = X.numel() * 4 + md[0].numel() * 4 + 4 + n * 4
                    ops = 2 * X.numel()
                else:
                    wcol = msp[0][:, None]
                    lib = lambda: F.embedding_bag(                # noqa: E731
                        i, wcol, per_sample_weights=v, mode="sum")
                    touched = int(torch.unique(i).numel())
                    nbytes = i.numel() * 4 + v.numel() * 4 + touched * 4 \
                        + 4 + SPARSE_ROWS * 4
                    ops = 2 * v.numel()
                rec["library_ms"] = cuda_ms(lib)
                t_bytes = nbytes / PEAK_BYTES_S * 1e3
                t_ops = ops / PEAK_OPS_S[mode] * 1e3
                rec["bound_ms"] = max(t_bytes, t_ops)
                rec["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
                rec["bytes"] = nbytes
            out[name][mode] = rec
    return out


def build_mapper(coef, dim):
    from alink_tpu_torch.common.params import Params
    from alink_tpu_torch.model.interop import linear_model_from_numpy
    from alink_tpu_torch.operator.common.linear.base import \
        LinearModelDataConverter
    from alink_tpu_torch.operator.common.linear.mapper import LinearModelMapper
    from alink_tpu_torch.common.types import TableSchema
    model = linear_model_from_numpy(coef, has_intercept=True,
                                    label_values=[1, 0], vector_col="vec",
                                    vector_size=dim, label_type="LONG")
    table = LinearModelDataConverter("LONG").save_model(model)
    mapper = LinearModelMapper(
        table.schema, TableSchema(["vec"], ["VECTOR"]),
        Params({"prediction_col": "pred", "vector_col": "vec"}))
    mapper.load_model(table)
    return mapper


def check_path(ks, kernel, mapper, req, host_terms):
    """predict_table on the card with the launch count reset around it,
    then its parity checks. Returns (launches, card predictor, its
    output table, seconds of the predict_table call)."""
    from alink_tpu_torch.serving import CompiledPredictor
    gpu, cpu = CompiledPredictor(mapper), CompiledPredictor(mapper,
                                                            device="cpu")
    ks.reset_launch_counts()
    t0 = time.perf_counter()
    out = gpu.predict_table(req)
    secs = time.perf_counter() - t0
    launches = ks.launch_counts()[kernel]
    require(launches > 0, f"{kernel} never launched on the main path")
    require(out.num_rows == req.num_rows, "row count")
    s_gpu, s_cpu = gpu.predict_scores(req), cpu.predict_scores(req)
    require(s_gpu.dtype == np.float32 and s_gpu.shape == (req.num_rows,),
            "score dtype/shape")
    require(bool(np.isfinite(s_gpu).all()), "finite scores")
    require(np.array_equal(s_gpu.view(np.int32), s_cpu.view(np.int32)),
            "card scores bitwise equal to the CPU path")
    labels_gpu = [str(v) for v in out.col("pred")]
    labels_cpu = [str(v) for v in cpu.predict_table(req).col("pred")]
    require(labels_gpu == labels_cpu, "card labels equal to the CPU path")
    # the float64 host mapper: scores within float32 rounding of the
    # terms, labels equal wherever a score is clear of that band
    s_host = mapper.predict_scores(req)
    tol = 64 * 2.0 ** -24 * host_terms
    require(bool((np.abs(s_gpu - s_host) <= tol).all()),
            "scores within float32 rounding of the float64 host mapper")
    host_labels = [str(v) for v in mapper.map_table(req).col("pred")]
    clear = np.abs(s_host) > tol
    require(all(a == b for a, b, c in zip(labels_gpu, host_labels, clear)
                if c), "labels equal to the host mapper")
    return launches, gpu, out, secs


def bucket_latency(pred, req):
    """p50 of ``predict_table`` at each bucket's row count, and rows/s."""
    rows = {}
    for b in pred.buckets:
        sub = req.first_n(b)
        p50 = host_p50_ms(lambda: pred.predict_table(sub), reps=30)
        rows[b] = {"p50_ms": p50, "rows_per_s": b / p50 * 1e3}
    return rows


def dispatch_breakdown(pred, req, reps=30):
    """Where one top-bucket ``predict_table`` dispatch spends its time:
    the median host-clock time of each stage, each ending in a
    synchronize, and the kernel's share of the sum (the card is idle
    for the rest)."""
    import torch
    ver = pred._active                   # the predictor's active model
    sub = req.first_n(pred.buckets[-1])
    n = sub.num_rows
    stages = {k: [] for k in ("encode", "to_device", "kernel", "fetch",
                              "decode")}
    for _ in range(reps + 1):
        t0 = time.perf_counter()
        kind, tensors = ver.kernel.encode(sub, pred.bucket_for(n))
        t1 = time.perf_counter()
        placed = tuple(t.to(pred.device) for t in tensors)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        out = ver.kernel.device_fns[kind](ver.arrays, *placed)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        host = out.cpu().numpy()[:n]
        t4 = time.perf_counter()
        ver.kernel.decode((host,), sub)
        t5 = time.perf_counter()
        for k, a, z in (("encode", t0, t1), ("to_device", t1, t2),
                        ("kernel", t2, t3), ("fetch", t3, t4),
                        ("decode", t4, t5)):
            stages[k].append((z - a) * 1e3)
    med = {k: float(np.median(v[1:])) for k, v in stages.items()}
    med["kernel_share"] = med["kernel"] / sum(med.values())
    return med


# ---------------------------------------------------------------------------
# FTRL: the state kernels and the online training path
# ---------------------------------------------------------------------------

def ftrl_kernel_inputs(rng, dtype, C, M, dev):
    """A (2^20 + 1, C) state with a -0.0 at slot 7 that no index names,
    and M duplicate-heavy slot indices (a pool of 48 slots, a quarter of
    the positions padded to slot 0 with zero updates)."""
    import torch
    S = FEATURES + 1
    st = torch.from_numpy(rng.standard_normal((S, C))).to(dev, dtype)
    st[7] = -0.0
    pool = rng.choice(np.arange(8, S), 48, replace=False)
    ix = pool[rng.integers(0, 48, M)]
    pad = rng.random(M) < 0.25
    ix[pad] = 0
    upd = rng.standard_normal((M, C))
    upd[pad] = 0.0
    if C == 1:
        st = st[:, 0].contiguous()
        upd = upd[:, 0]
    return (st, torch.from_numpy(ix.astype(np.int32)).to(dev),
            torch.from_numpy(upd).to(dev, dtype))


def chained_inputs(rng, dtype, dev):
    """The chained step's operands at K = 16, w = 40: the collision
    tensor of Criteo rows (every row shares the intercept slot 0, plus
    slots drawn from a small pool so rows collide) and random deltas."""
    import torch
    K, w = CHAIN_K, FTRL_WIDTH
    xi = rng.choice(np.arange(1, 200), (K, w))
    xi[:, 0] = 0
    xi[:, -1] = 0                                   # a padded position
    M = (xi[:, None, :, None] == xi[None, :, None, :])
    D = rng.standard_normal((K, w, 2))
    D[:, -1] = 0.0
    dense = rng.random((K, w, w)) < 0.1             # order-sensitive sums
    return (torch.from_numpy(M).to(dev, dtype),
            torch.from_numpy(dense).to(dev, dtype),
            torch.from_numpy(D).to(dev, dtype))


def _bound(nbytes, ops, kind):
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = ops / PEAK_OPS_S[kind] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def phase_ftrl_kernels(kf, rng, dev):
    """Each FTRL kernel against its plain version on the card, bitwise,
    at every shape the three modes launch; times at each shape."""
    import torch
    rec = {"ftrl_gather": {}, "ftrl_scatter_add": {},
           "ftrl_chained_corr": {}}
    for dtype, kind in ((torch.float32, "f32"), (torch.float64, "f64")):
        size = 4 if kind == "f32" else 8
        for mode, M in FTRL_M.items():
            for C in (1, 2):
                st, ix, upd = ftrl_kernel_inputs(rng, dtype, C, M, dev)
                key = f"{kind} {mode} M={M} C={C}"
                touched = int(torch.unique(ix).numel())
                # gather
                got = kf.gather_rows(st, ix)
                want = kf.gather_rows_plain(st, ix)
                torch.cuda.synchronize()
                require(torch.equal(bits(got), bits(want)),
                        f"ftrl_gather {key} bitwise vs its plain version")
                b_ms, b_by = _bound(M * 4 + touched * C * size
                                    + M * C * size, 0, kind)
                rec["ftrl_gather"][key] = {
                    "bitwise": True, "max_abs_err": 0.0,
                    "kernel_ms": cuda_ms(lambda: kf.gather_rows(st, ix)),
                    "plain_ms": cuda_ms(lambda: kf.gather_rows_plain(st, ix)),
                    "library_ms": cuda_ms(
                        lambda: torch.index_select(st, 0, ix)),
                    "bound_ms": b_ms, "bound_by": b_by}
                # scatter-add, in place: each side on its own copy
                a, b = st.clone(), st.clone()
                kf.scatter_add_rows(a, ix, upd)
                kf.scatter_add_rows_plain(b, ix, upd)
                torch.cuda.synchronize()
                err = float((a.double() - b.double()).abs().max())
                require(torch.equal(bits(a), bits(b)),
                        f"ftrl_scatter_add {key} bitwise vs its plain "
                        f"version (max abs err {err})")
                neg = a[7] if C == 1 else a[7, 0]
                require(bool(torch.signbit(neg)) and float(neg) == 0.0,
                        f"ftrl_scatter_add {key}: the untouched -0.0 slot "
                        f"kept its bits")
                scratch = st.clone()
                b_ms, b_by = _bound(M * 4 + M * C * size
                                    + 2 * touched * C * size, M * C, kind)
                rec["ftrl_scatter_add"][key] = {
                    "bitwise": True, "max_abs_err": err,
                    "kernel_ms": cuda_ms(
                        lambda: kf.scatter_add_rows(scratch, ix, upd)),
                    "plain_ms": cuda_ms(
                        lambda: kf.scatter_add_rows_plain(scratch, ix, upd),
                        trials=5, reps=2),
                    # not deterministic: timed as the yardstick only
                    "library_ms": cuda_ms(
                        lambda: scratch.index_add_(0, ix, upd)),
                    "bound_ms": b_ms, "bound_by": b_by}
        # beyond the main path: a scatter whose staged updates need the
        # shared-memory opt-in above 48 KB (4096 positions x 20 bytes)
        st, ix, upd = ftrl_kernel_inputs(rng, dtype, 2, 4096, dev)
        a, b = st.clone(), st.clone()
        kf.scatter_add_rows(a, ix, upd)
        kf.scatter_add_rows_plain(b, ix, upd)
        torch.cuda.synchronize()
        require(torch.equal(bits(a), bits(b)),
                f"ftrl_scatter_add {kind} M=4096 C=2 bitwise vs its plain "
                f"version")
        Mc, Md, D = chained_inputs(rng, dtype, dev)
        for k in (0, 1, CHAIN_K - 1):
            for label, M4 in (("collisions", Mc), ("dense", Md)):
                Mk = M4[k] if label == "collisions" else M4
                Mk = Mk.contiguous()
                got = kf.chained_corr(Mk, D, k)
                want = kf.chained_corr_plain(Mk, D, k)
                torch.cuda.synchronize()
                require(torch.equal(bits(got), bits(want)),
                        f"ftrl_chained_corr {kind} k={k} {label} bitwise "
                        f"vs its plain version")
                if label != "collisions" or k == 0:
                    continue
                w = FTRL_WIDTH
                b_ms, b_by = _bound((k * w * w + k * w * 2 + w * 2) * size,
                                    2 * k * w * w * 2, kind)
                rec["ftrl_chained_corr"][f"{kind} K={CHAIN_K} w={w} "
                                         f"k={k}"] = {
                    "bitwise": True, "max_abs_err": 0.0,
                    "kernel_ms": cuda_ms(lambda: kf.chained_corr(Mk, D, k)),
                    "plain_ms": cuda_ms(
                        lambda: kf.chained_corr_plain(Mk, D, k),
                        trials=5, reps=2),
                    "library_ms": cuda_ms(lambda: torch.einsum(
                        "jab,jbc->ac", Mk[:k], D[:k])),
                    "bound_ms": b_ms, "bound_by": b_by}
    return rec


def criteo_ftrl_rows(seed, n):
    """bench.py's ``make_batch_criteo`` rows at 2^20 features, as the
    trainer's input: 39 distinct one-hot slots per row (the trainer adds
    the intercept), labels drawn from the logistic of a seeded sparse
    true model (2 % of the features non-zero)."""
    from alink_tpu_torch.common.mtable import MTable
    from alink_tpu_torch.common.vector import SparseVector
    r = np.random.RandomState(seed)
    rngw = np.random.RandomState(0)
    w_true = rngw.randn(FEATURES) * (rngw.rand(FEATURES) < 0.02)
    raw = r.randint(0, FEATURES, size=(n, NNZ))
    for _ in range(64):                       # resample intra-row collisions
        srt = np.sort(raw, axis=1)
        dup = (srt[:, 1:] == srt[:, :-1]).any(1)
        if not dup.any():
            break
        raw[dup] = r.randint(0, FEATURES, size=(int(dup.sum()), NNZ))
    raw = np.sort(raw, axis=1)
    y = (r.rand(n) < 1.0 / (1.0 + np.exp(-w_true[raw].sum(1)))).astype(
        np.int64)
    vecs = np.empty(n, object)
    ones = np.ones(NNZ)
    vecs[:] = [SparseVector(FEATURES, raw[i], ones) for i in range(n)]
    return MTable({"vec": vecs, "label": y}, "vec VECTOR, label LONG")


def ftrl_warm_model(rng):
    """The warm-start model table: small random coefficients from the
    seed, positive label 1."""
    from alink_tpu_torch.model.interop import linear_model_from_numpy
    from alink_tpu_torch.operator.batch.source import MemSourceBatchOp
    from alink_tpu_torch.operator.common.linear.base import \
        LinearModelDataConverter
    coef = rng.standard_normal(FEATURES + 1) * 0.01
    model = linear_model_from_numpy(coef, has_intercept=True,
                                    label_values=[1, 0], vector_col="vec",
                                    vector_size=FEATURES, label_type="LONG")
    return MemSourceBatchOp(LinearModelDataConverter("LONG").save_model(
        model))


def ftrl_op(warm, mode, **kw):
    from alink_tpu_torch.operator.stream.onlinelearning import \
        FtrlTrainStreamOp
    return FtrlTrainStreamOp(warm, vector_col="vec", label_col="label",
                             update_mode=mode, staleness=STALE_K,
                             chunk_size=CHAIN_K, **FTRL_HP, **kw)


def drain_timed(op):
    """All (time, snapshot) of one drain, host clock; the snapshots'
    fetches synchronize the card."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    snaps = list(op.timed_batches())
    torch.cuda.synchronize()
    return snaps, time.perf_counter() - t0


def ftrl_card_vs_cpu(warm, train):
    """Each mode over 2 micro-batches, float64, on the card and on the
    CPU from the same encoded stream: z, n and every margin agree at
    rtol 1e-10 (CUDA's exp and sum orders are not the CPU's)."""
    import torch
    from alink_tpu_torch.operator.stream.source import MemSourceStreamOp
    out = {}
    for mode in ("sample", "staleness", "chained"):
        runs = {}
        for dev in ("cuda", "cpu"):
            op = ftrl_op(warm, mode, device=dev, ship_dtype=torch.float64)
            op.link_from(MemSourceStreamOp(train, batch_size=FTRL_BATCH))
            tr = op.trainer
            z, n = tr.initial_state()
            margins = []
            width = 8
            for b in range(2):
                mt = train.take_rows(np.arange(b * FTRL_BATCH,
                                               (b + 1) * FTRL_BATCH))
                idx, val, y, width = tr.encode(mt, FTRL_BATCH, width)
                z, n, mg = tr.step(*tr.to_device(idx, val, y), z, n)
                margins.append(mg.cpu().numpy())
            runs[dev] = (z.cpu().numpy(), n.cpu().numpy(),
                         np.concatenate(margins))
        errs = {}
        for name, a, b in zip(("z", "n", "margins"), runs["cuda"],
                              runs["cpu"]):
            require(bool(np.isfinite(a).all()), f"{mode} {name} finite")
            gap = np.abs(a - b)
            require(bool((gap <= 1e-10 * np.abs(b) + 1e-12).all()),
                    f"ftrl {mode}: card {name} within rtol 1e-10 of the "
                    f"CPU (max abs err {gap.max()})")
            errs[name] = {"max_abs_err": float(gap.max()),
                          "max_rel_err": float(
                              (gap / np.maximum(np.abs(b), 1e-300)).max()),
                          "bitwise_share": float((a == b).mean())}
        out[mode] = errs
    return out


def ftrl_split(warm, train, mode, reps=3, trace=False):
    """One 4096-row micro-batch of ``mode`` split into encode, copy in,
    step and snapshot (host clock, each ending in a synchronize), median
    of ``reps``. With ``trace``, one more step under ``torch.profiler``:
    the card's busy time in it (the sum of its CUDA kernels and copies)
    and that time's share of the median unprofiled step (None where the
    trace shows no device time)."""
    import torch
    from alink_tpu_torch.operator.stream.source import MemSourceStreamOp
    op = ftrl_op(warm, mode).link_from(
        MemSourceStreamOp(train, batch_size=FTRL_BATCH))
    tr = op.trainer
    mt = train.first_n(FTRL_BATCH)
    stages = {k: [] for k in ("encode", "to_device", "step", "snapshot")}
    z, n = tr.initial_state()
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        idx, val, y, _ = tr.encode(mt, FTRL_BATCH)
        t1 = time.perf_counter()
        dev = tr.to_device(idx, val, y)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        z, n, _ = tr.step(*dev, z, n)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        tr.snapshot(z, n)
        t4 = time.perf_counter()
        for k, a, b in (("encode", t0, t1), ("to_device", t1, t2),
                        ("step", t2, t3), ("snapshot", t3, t4)):
            stages[k].append((b - a) * 1e3)
    med = {k: float(np.median(v)) for k, v in stages.items()}
    med["step_samples_per_s"] = FTRL_BATCH / med["step"] * 1e3
    if not trace:
        return med
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        z, n, _ = tr.step(*dev, z, n)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev_us = 0.0
    for e in prof.key_averages():
        if getattr(e, "device_type", None) is not None \
                and str(e.device_type).endswith("CUDA"):
            dev_us += float(getattr(e, "self_device_time_total",
                                    getattr(e, "self_cuda_time_total", 0)))
    med["profiled_step_ms"] = wall * 1e3
    med["device_busy_ms"] = dev_us / 1e3
    med["device_busy_share"] = (dev_us / 1e3 / med["step"]) if dev_us > 0 \
        else None
    return med


def phase_ftrl_main(kf, ks, rng):
    """The FTRL main path and the other two modes on the card (f32)."""
    import torch
    from alink_tpu_torch.common.params import Params
    from alink_tpu_torch.common.types import TableSchema
    from alink_tpu_torch.operator.common.linear.base import \
        LinearModelDataConverter
    from alink_tpu_torch.operator.common.linear.mapper import \
        LinearModelMapper
    from alink_tpu_torch.operator.stream.onlinelearning import \
        FtrlPredictStreamOp
    from alink_tpu_torch.operator.stream.sink import CollectSinkStreamOp
    from alink_tpu_torch.operator.stream.source import MemSourceStreamOp
    from alink_tpu_torch.operator.base import StreamOperator
    from alink_tpu_torch.serving import CompiledPredictor
    t0 = time.perf_counter()
    warm = ftrl_warm_model(rng)
    train = criteo_ftrl_rows(1, FTRL_BATCH * FTRL_TRAIN_BATCHES)
    held = criteo_ftrl_rows(2, 1024 * FTRL_HELD_BATCHES)
    print(f"ftrl data: {train.num_rows} training and {held.num_rows} "
          f"held-out rows, warm model table, {time.perf_counter() - t0:.3f} s")
    out = {}

    # -- the main path: sample mode, train + hot-swapped predict ----------
    # first the trainer's stream alone (throughput, snapshots), then the
    # main path: execute() replays the training under the predictor, and
    # its launches are counted from 0 on their own
    ftrl = ftrl_op(warm, "sample", time_interval=2.0).link_from(
        MemSourceStreamOp(train, batch_size=FTRL_BATCH))
    kf.reset_launch_counts()
    snaps, secs = drain_timed(ftrl)
    drain_launches = kf.launch_counts()
    pred = FtrlPredictStreamOp(warm, prediction_col="pred",
                               vector_col="vec").link_from(
        ftrl, MemSourceStreamOp(held, batch_size=1024))
    sink = CollectSinkStreamOp().link_from(pred)
    kf.reset_launch_counts()
    StreamOperator.execute()
    launches = kf.launch_counts()
    require(launches["ftrl_gather"] > 0 and launches["ftrl_scatter_add"] > 0,
            f"the train + hot-swap predict run launched every state "
            f"kernel: {launches}")
    require(launches == drain_launches,
            f"the replayed training launched what the drain did: "
            f"{launches} vs {drain_launches}")
    scored = sink.get_and_remove_values()
    require(scored.num_rows == held.num_rows, "every held-out row scored")
    require([t for t, _ in snaps] == [2.0, 4.0, 6.0],
            f"snapshots every 2 micro-batches: {[t for t, _ in snaps]}")
    pl = ftrl.progressive_logloss()
    require(len(pl) == FTRL_TRAIN_BATCHES and all(np.isfinite(v)
                                                 for _, v in pl),
            "finite progressive log loss per micro-batch")
    coefs = [LinearModelDataConverter.load_table(s).coef for _, s in snaps]
    require(all(np.isfinite(c).all() and c.shape == (FEATURES + 1,)
                for c in coefs), "finite snapshot coefficients")
    out["sample"] = {"micro_batches": FTRL_TRAIN_BATCHES,
                     "samples_per_s": train.num_rows / secs,
                     "drain_s": secs, "drain_launches": drain_launches,
                     "launches_per_micro_batch": {
                         k: v / FTRL_TRAIN_BATCHES
                         for k, v in drain_launches.items()},
                     "main_path_launches": launches,
                     "progressive_logloss": pl}
    print(f"ftrl sample: {train.num_rows} rows in {secs:.3f} s "
          f"({train.num_rows / secs:.1f} samples/s), launches of the train "
          f"+ hot-swap predict run {launches}, "
          f"progressive log loss first {pl[0][1]} last {pl[-1][1]}")

    # the last snapshot hot-swapped into slice 1's CompiledPredictor
    wt = warm.get_output_table()
    mapper = LinearModelMapper(wt.schema, TableSchema(["vec"], ["VECTOR"]),
                               Params({"prediction_col": "pred",
                                       "vector_col": "vec"}))
    mapper.load_model(wt)
    gpu = CompiledPredictor(mapper)
    gpu.swap_model(snaps[-1][1])
    last = held.take_rows(np.arange(6 * 1024, held.num_rows)).select(["vec"])
    card = [str(v) for v in gpu.predict_table(last).col("pred")]
    ftrl_labels = [str(v) for v in
                   scored.take_rows(np.arange(6 * 1024,
                                              held.num_rows)).col("pred")]
    host = gpu._active.mapper
    s_host = host.predict_scores(last)
    c = coefs[-1]
    terms = np.asarray([abs(c[0]) + np.abs(c[1 + v.indices]).sum()
                        for v in last.col("vec")])
    clear = np.abs(s_host) > 64 * 2.0 ** -24 * terms
    require(all(a == b for a, b, ok in zip(card, ftrl_labels, clear) if ok),
            "CompiledPredictor labels equal FtrlPredictStreamOp's")
    out["swap"] = {"rows": len(card), "rows_in_rounding_band":
                   int((~clear).sum()),
                   "labels_equal": sum(a == b for a, b in
                                       zip(card, ftrl_labels))}
    print(f"ftrl hot swap: {out['swap']}")

    # -- the other two modes, 2 micro-batches each -----------------------
    two = train.first_n(2 * FTRL_BATCH)
    for mode, kernels in (("staleness", ("ftrl_gather", "ftrl_scatter_add")),
                          ("chained", ("ftrl_gather", "ftrl_scatter_add",
                                       "ftrl_chained_corr"))):
        op = ftrl_op(warm, mode, time_interval=1e9).link_from(
            MemSourceStreamOp(two, batch_size=FTRL_BATCH))
        kf.reset_launch_counts()
        snaps_m, secs = drain_timed(op)
        counts = kf.launch_counts()
        require(all(counts[k] > 0 for k in kernels),
                f"the {mode} path launched {kernels}: {counts}")
        c = LinearModelDataConverter.load_table(snaps_m[-1][1]).coef
        require(bool(np.isfinite(c).all()), f"{mode} finite coefficients")
        pl = op.progressive_logloss()
        out[mode] = {"micro_batches": 2, "samples_per_s": two.num_rows / secs,
                     "drain_s": secs, "launches": counts,
                     "launches_per_micro_batch": {k: v / 2
                                                  for k, v in counts.items()},
                     "progressive_logloss": pl}
        print(f"ftrl {mode}: {two.num_rows} rows in {secs:.3f} s "
              f"({two.num_rows / secs:.1f} samples/s), launches {counts}")

    out["split_ms"] = {mode: ftrl_split(warm, train, mode,
                                        trace=mode == "sample")
                       for mode in ("sample", "staleness", "chained")}
    for mode, split in out["split_ms"].items():
        print(f"ftrl {mode} micro-batch split (ms): {split}")
    t0 = time.perf_counter()
    out["card_vs_cpu_f64"] = ftrl_card_vs_cpu(warm, train)
    print(f"ftrl card vs CPU, float64, 2 micro-batches "
          f"({time.perf_counter() - t0:.1f} s): {out['card_vs_cpu_f64']}")
    return out


BAD_SLOT_PROBE = """
import sys, torch
from alink_tpu_torch.kernels import ftrl as kf
st = torch.zeros(1 << 20, device="cuda")
ix = torch.tensor([3, 1 << 20, 5], dtype=torch.int32, device="cuda")
try:
    if sys.argv[1] == "gather":
        kf.gather_rows(st, ix)
    else:
        kf.scatter_add_rows(st, ix, torch.ones(3, device="cuda"))
    torch.cuda.synchronize()
except RuntimeError as e:
    print("raised:", str(e).splitlines()[0])
    sys.exit(0)
print("no error")
sys.exit(1)
"""


def phase_bad_slots():
    """An out-of-range slot fails the kernel's device-side assert and
    the caller's stream raises at its synchronize. Each probe runs in a
    process of its own, since the assert ends that process's CUDA
    context; both start together."""
    root = str(Path(__file__).resolve().parent)
    procs = {k: subprocess.Popen([sys.executable, "-c", BAD_SLOT_PROBE, k],
                                 cwd=root, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)
             for k in ("gather", "scatter")}
    out = {}
    for k, p in procs.items():
        try:
            log, _ = p.communicate(timeout=120)
        finally:
            p.kill()
        said = [ln for ln in log.splitlines() if ln.startswith("raised:")]
        require(p.returncode == 0 and len(said) == 1,
                f"an out-of-range slot in ftrl {k} raised on the card "
                f"(exit {p.returncode}): {log.strip()[-2000:]}")
        out[k] = said[0]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from alink_tpu_torch.common.mtable import MTable
    from alink_tpu_torch.common.vector import DenseVector, SparseVector
    from alink_tpu_torch.kernels import _build
    from alink_tpu_torch.kernels import ftrl as kf
    from alink_tpu_torch.kernels import serve as ks
    from alink_tpu_torch.serving import PredictServer

    # -- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    _build.build()
    print(f"build: {time.perf_counter() - t0:.3f} s (nvcc, sm_90a)")
    for name in _build.sources():
        print(f"build log {name}:\n{_build.build_log(name).strip()}")

    # -- 3. kernels against their plain versions -------------------------
    dev = torch.device("cuda")
    rng = np.random.default_rng(args.seed)
    parity = phase_kernels(ks, rng, dev)
    for name, modes in parity.items():
        for mode, rec in modes.items():
            print(f"{name} {mode}: bitwise={rec['bitwise']} "
                  f"kernel_ms={rec['kernel_ms']}"
                  + (f" plain_ms={rec['plain_ms']} library_ms="
                     f"{rec['library_ms']} bound_ms={rec['bound_ms']}"
                     if mode == "f32" else ""))

    # -- 4. the main path: Criteo-shape sparse LR -------------------------
    coef = rng.standard_normal(FEATURES + 1) * 0.05
    t0 = time.perf_counter()
    mapper = build_mapper(coef, FEATURES)
    print(f"model table save+load ({FEATURES} features): "
          f"{time.perf_counter() - t0:.3f} s")
    idx, val = criteo_rows(rng, N_REQUESTS)
    order = np.argsort(idx, axis=1)
    idx = np.take_along_axis(idx, order, 1)
    val = np.take_along_axis(val, order, 1)
    vecs = np.empty(N_REQUESTS, object)
    vecs[:] = [SparseVector(FEATURES, idx[i], val[i])
               for i in range(N_REQUESTS)]
    req = MTable({"vec": vecs}, "vec VECTOR")
    terms = np.abs(val * coef[1:][idx]).sum(1) + abs(coef[0])
    sp_launch, gpu, out, secs = check_path(ks, "serve_sparse", mapper, req,
                                           terms)
    print(f"sparse main path: {N_REQUESTS} rows in {secs:.4f} s "
          f"({N_REQUESTS / secs:.1f} rows/s), {sp_launch} kernel launches")

    # PredictServer: 64 single-row requests from 4 client threads
    ks.reset_launch_counts()
    answers = {}

    def client(lo, hi):
        futs = [(j, srv.submit(req.row(j))) for j in range(lo, hi)]
        for j, f in futs:
            answers[j] = f.result(60)

    per = N_SINGLE // CLIENTS
    with PredictServer(gpu) as srv:
        threads = [threading.Thread(target=client, args=(c * per,
                                                         (c + 1) * per))
                   for c in range(CLIENTS)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(120)
    require(not any(th.is_alive() for th in threads), "server clients done")
    server_launches = ks.launch_counts()["serve_sparse"]
    require(server_launches > 0, "PredictServer launched no kernel")
    require(len(answers) == N_SINGLE, "every request answered")
    for j, got in answers.items():
        require([str(v) for v in got] == [str(v) for v in out.row(j)],
                f"server answer {j} equals its predict_table row")
    print(f"PredictServer: {N_SINGLE} requests from {CLIENTS} threads "
          f"answered in {server_launches} kernel launches")
    sparse_buckets = bucket_latency(gpu, req)
    sparse_split = dispatch_breakdown(gpu, req)

    # the dense kernel's path: a 1024-wide model
    dim = DENSE_SHAPE[1]
    coef_d = rng.standard_normal(dim + 1) * 0.05
    Xd = rng.standard_normal((N_REQUESTS, dim))
    dvecs = np.empty(N_REQUESTS, object)
    dvecs[:] = [DenseVector(x) for x in Xd]
    dreq = MTable({"vec": dvecs}, "vec VECTOR")
    dterms = np.abs(Xd * coef_d[1:]).sum(1) + abs(coef_d[0])
    de_launch, dgpu, _, dsecs = check_path(
        ks, "serve_dense", build_mapper(coef_d, dim), dreq, dterms)
    print(f"dense path: {N_REQUESTS} rows in {dsecs:.4f} s "
          f"({N_REQUESTS / dsecs:.1f} rows/s), {de_launch} kernel launches")
    dense_buckets = bucket_latency(dgpu, dreq)
    dense_split = dispatch_breakdown(dgpu, dreq)
    for kind, table in (("sparse", sparse_buckets), ("dense", dense_buckets)):
        for b, r in table.items():
            print(f"{kind} bucket {b}: p50 {r['p50_ms']} ms, "
                  f"{r['rows_per_s']} rows/s")
    for kind, split in (("sparse", sparse_split), ("dense", dense_split)):
        print(f"{kind} 512-row dispatch, median ms per stage: {split}")

    # -- 6. the FTRL state kernels against their plain versions ----------
    ftrl_parity = phase_ftrl_kernels(kf, rng, dev)
    for name, shapes in ftrl_parity.items():
        for key, rec in shapes.items():
            print(f"{name} {key}: bitwise={rec['bitwise']} kernel_ms="
                  f"{rec['kernel_ms']} plain_ms={rec['plain_ms']} "
                  f"library_ms={rec['library_ms']} bound_ms="
                  f"{rec['bound_ms']} ({rec['bound_by']})")

    # -- 7. the FTRL main path: online training on Criteo-shape rows -----
    ftrl = phase_ftrl_main(kf, ks, rng)

    # -- 8. an out-of-range slot fails loudly on the card ----------------
    bad_slots = phase_bad_slots()
    print(f"out-of-range slots: {bad_slots}")

    # -- the record -------------------------------------------------------
    launches = {"serve_dense": de_launch, "serve_sparse": sp_launch}
    replaces = {"serve_dense": "alink_tpu/kernels/serve.py:221",
                "serve_sparse": "alink_tpu/kernels/serve.py:242"}
    kernels = []
    for name in ("serve_dense", "serve_sparse"):
        f32 = parity[name]["f32"]
        kernels.append({
            "name": name, "route": "cuda", "source": SRC,
            "replaces": replaces[name], "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"]
                               for r in parity[name].values()),
            "ms": f32["kernel_ms"], "plain_ms": f32["plain_ms"],
            "bound_ms": f32["bound_ms"], "bound_by": f32["bound_by"],
            "library_ms": f32["library_ms"],
            "bitwise": all(r["bitwise"] for r in parity[name].values()),
            "kernel_ms": f32["kernel_ms"],
            "mode_ms": {m: r["kernel_ms"] for m, r in parity[name].items()},
        })
    # the FTRL kernels' record: each at the shape of the path that
    # counts it (sample mode for gather and scatter-add, chained for the
    # correction), in f32; every shape's times are in "shapes"
    ftrl_rec = (
        ("ftrl_gather", "alink_tpu/kernels/ftrl.py:90",
         f"f32 sample M={FTRL_M['sample']} C=1",
         ftrl["sample"]["main_path_launches"]["ftrl_gather"]),
        ("ftrl_scatter_add", "alink_tpu/kernels/ftrl.py:129",
         f"f32 sample M={FTRL_M['sample']} C=1",
         ftrl["sample"]["main_path_launches"]["ftrl_scatter_add"]),
        ("ftrl_chained_corr", "alink_tpu/kernels/ftrl.py:190",
         f"f32 K={CHAIN_K} w={FTRL_WIDTH} k={CHAIN_K - 1}",
         ftrl["chained"]["launches"]["ftrl_chained_corr"]))
    for name, where, key, count in ftrl_rec:
        r = ftrl_parity[name][key]
        kernels.append({
            "name": name, "route": "cuda", "source": FTRL_SRC,
            "replaces": where, "launches": count,
            "max_abs_err": max(v["max_abs_err"]
                               for v in ftrl_parity[name].values()),
            "ms": r["kernel_ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "bitwise": True,
            "kernel_ms": r["kernel_ms"], "shape": key,
            "shapes": {k: {f: v[f] for f in ("kernel_ms", "plain_ms",
                                               "library_ms", "bound_ms")}
                       for k, v in ftrl_parity[name].items()}})
    print(json.dumps({"main_path": {
        "ftrl": ftrl, "out_of_range_slots": bad_slots,
        "card": card, "sparse_rows_per_s": N_REQUESTS / secs,
        "dense_rows_per_s": N_REQUESTS / dsecs,
        "server_requests": N_SINGLE, "server_launches": server_launches,
        "sparse_buckets": sparse_buckets, "dense_buckets": dense_buckets,
        "sparse_dispatch_ms": sparse_split,
        "dense_dispatch_ms": dense_split}}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
