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
   and decode.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import threading
import time

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

    # -- 5. the record ----------------------------------------------------
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
    print(json.dumps({"main_path": {
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
