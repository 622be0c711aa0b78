#!/usr/bin/env python3
"""Old against new: the FTRL steps and drains, the sparse serving kernel,
the ordered gradient kernel and the L-BFGS superstep of two trees of
this repository, timed in turns on one NVIDIA GPU.

    mkdir -p ab/parent && git archive <commit> | tar -x -C ab/parent
    python3 kernel_ab.py ab/parent . . ab/parent     # ab/: listed in .gitignore
    python3 kernel_ab.py --parts=p2,steps,linear_grad ab/parent . . ab/parent

``--parts`` names the parts below to measure (default: all of them:
``sparse``, ``walk``, ``split``, ``linear_grad``, ``lbfgs``, ``p2``,
``steps``, ``drain``, ``p3``). Each tree named on the command line is measured in a process
of its own,
in the order given (parent, change, change, parent is the fair order),
from its own checkout: its kernels are built from its own sources into
its own ``build/``, and its own wrappers, trainer and ``chip_smoke.py``
helpers are called, so trees whose APIs differ compare. Each run prints
one JSON line; the last line sums them up by tree (the median of its
runs).

What a run measures (the tree's ``chip_smoke.py`` helpers: kernel time
by CUDA events over back-to-back calls, device time by
``torch.profiler``, host time as the enqueue cost of back-to-back calls;
a kernel and the library call it is held against are timed in turns):

* the chunk walk (``ftrl_walk``, where the tree has it) on one Criteo
  chunk of each strict step (K = 4 and 16, width 40), f32 and f64:
  device time;
* ``serve_sparse`` at (512, 40) over 2^20 features in the four modes, and
  ``F.embedding_bag`` beside it; the "kernel" stage of a dispatch (one
  call and a synchronize, host clock, median of 50);
* one 4096-row micro-batch of Criteo-shape rows (``chip_smoke.py``'s
  ``criteo_ftrl_rows``, float32) through ``FtrlTrainer`` in each
  update mode (``sample``; ``staleness``, K = 32; ``chained``, K = 16),
  split into encode, copy in, step and snapshot (host clock, each stage
  ending in a synchronize, median of 3), and the step's kernel launches;
  then, after every mode's split (a step measured after a profiled one
  runs slower), the card's busy time under one more step of each mode
  (``torch.profiler``);
* the ordered gradient kernel (``linear_grad``) at both main-path
  shapes in f32 and f64 (``chip_smoke.py`` phase 12(a)'s field-blocked
  ``bench_logreg`` design, 200,000 x 33 over 67,584 slots, and its
  padded-COO design, 100,000 x 40 over 2^20 + 1), each without its
  intercept column (the bulk alone) and the intercept's run alone
  (200,000 terms in one slot), f32: ``kernel_ms`` by CUDA events
  in turns with ``index_add_`` (not deterministic on the card: a
  yardstick), device time by the profiler (over the launches it
  recorded), the chain bound of the longest run (its dependent adds at
  the latency a one-thread probe reads, at the top SM clock) and the
  kernel's fraction of it, and whether the kernel is bitwise to its
  plain version (run on the CPU);
* the L-BFGS superstep at ``bench_logreg``'s configuration (phase
  12(b)): ms a superstep (median of the untraced ones of a 30-superstep
  run), the card's busy share over 5 profiled supersteps, and the
  ``StageSplit`` of the superstep into gradient, direction, line search
  and update (each stage ending in a synchronize, median of supersteps
  2-10);
* ``p2``: the ordered scatter-add (``scatter_walk``) at ``chip_smoke.py``
  phase 14's shapes (``scatter_inputs``): the padded-COO batch shape
  (4096 x 40 over 65,537 slots, the intercept in column 0), its
  intercept column alone (one run of 4,096 terms) and its bulk alone (no
  run of ``HEAVY_MIN`` terms), the stream's 16,384 x 4 over 3 x 1648 + 1,
  and the field-blocked step's use (float32 terms into zeroed states
  over 40 x 1648, and over the stream's 3 x 1648 + 1), f32 and f64: the
  kernel on a built plan, the wrapper (plan and walk), the plan alone and
  two ``index_add_`` calls, by CUDA events in turns; the walk's device
  span (``device_span_ms``); the enqueue cost of the kernel and of the
  wrapper; the chain bound of the longest run; bitwise to its plain
  version on the CPU. At the padded-COO and field-blocked shapes in
  f32, the plan's device ops one by one (``torch.profiler``: each op's
  count, host time and device time a plan);
* ``steps``: one 4096-row micro-batch of the padded-COO and the
  field-blocked batch steps (``chip_smoke.py``'s ``step_inputs``,
  float32 state): ms by the host clock, each call ending in a
  synchronize (median of 15), device ops and busy time under one
  profiled step, the launches of each wrapper;
* ``drain``: ``chip_smoke.py`` phase 14's two FTRL batch drains through
  the entry point, ``FtrlTrainStreamOp(update_mode="batch")`` in float32:
  the padded-COO main path (6 micro-batches of 4096 rows over 65,537
  slots, a snapshot every 2) and bench_ftrl's stream (16 field-blocked
  micro-batches of 16,384 hashed rows, one snapshot at the end), each
  the median of 5 drains after a warm one (host clock, from a
  synchronize to a synchronize), without a monitor and, where the tree
  has ``common/health.py``, with a default ``HealthMonitor``, the two in
  turns;
* ``p3``: the ordered row scatter-add (``kernels/rows.py::scatter_rows``)
  at Word2Vec's ``in`` and ``out`` scatters of one batch
  (``chip_smoke.py``'s ``w2v_p3_inputs`` on its text8-shaped corpus,
  float32, 100 columns), each call made as the trainer makes it (no plan
  passed; ``small_path`` says whether the tree took P3's one-block path):
  the wrapper and ``index_add_`` by CUDA events in turns, the device
  time a call (``torch.profiler``, every kernel of the call, a plan's
  too), the enqueue cost, the launches a call and bitwise to the plain
  version on the CPU; then one epoch of ``word2vec_train`` on that corpus
  (host clock from a synchronize to a synchronize, the median of 3 after
  a warm one).
"""

from __future__ import annotations

import functools
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

def _helpers(tree: Path):
    """The tree's own ``chip_smoke.py``, loaded as a module."""
    spec = importlib.util.spec_from_file_location("_smoke_helpers",
                                                  tree / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SPAN_SLEEP_CYCLES = 10_000_000        # about 5 ms at 1980 MHz
PARTS = ("sparse", "walk", "split", "linear_grad", "lbfgs", "p2", "steps",
         "drain", "p3")


def device_span_ms(fn, part: str, reps: int = 20, sessions: int = 6):
    """The device time a call of ``fn`` holds the card with the kernels
    whose names hold ``part``: the union of those kernels' intervals in a
    ``torch.profiler`` trace of ``reps`` back-to-back calls, over the
    calls it saw (a call's launches overlap and count once, and a call is
    a run of overlapping launches: the gaps between calls do not count,
    and a call whose records the profiler dropped does not count either).
    The calls are queued behind a sleeping kernel
    of a few milliseconds, so the host's enqueue does not space a call's
    launches apart. A session that recorded none of them is made again,
    up to ``sessions`` in all. Returns (ms, kernels recorded)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for _ in range(sessions):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(SPAN_SLEEP_CYCLES)
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        iv = sorted((e.time_range.start, e.time_range.end)
                    for e in prof.events()
                    if e.device_type == DeviceType.CUDA and part in e.name)
        if iv:
            break
        time.sleep(0.1)
    if not iv:
        raise SystemExit(f"kernel_ab: the profiler saw no {part} kernel")
    covered, calls, lo, hi = 0.0, 1, iv[0][0], iv[0][1]
    for a, b in iv[1:]:
        if a > hi:
            covered += hi - lo
            calls += 1
            lo, hi = a, b
        else:
            hi = max(hi, b)
    covered += hi - lo
    return covered / calls / 1e3, len(iv)


def measure(tree: Path, parts=PARTS) -> dict:
    sys.path.insert(0, str(tree))
    import torch
    h = _helpers(tree)
    from alink_tpu_torch.kernels import _build
    from alink_tpu_torch.kernels import ftrl as kf
    from alink_tpu_torch.kernels import serve as ks
    assert Path(ks.__file__).resolve().is_relative_to(tree.resolve())
    _build.build()
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    out = {"tree": str(tree), "sparse": {}, "split_ms": {}, "launches": {}}
    out["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    if "sparse" in parts:
        sparse_times(h, ks, rng, dev, out)
    if "walk" in parts and hasattr(kf, "walk_chunk"):
        # the walk of one Criteo chunk at each strict step's K
        out["walk"] = {}
        for dtype, kind in ((torch.float32, "f32"), (torch.float64, "f64")):
            for chained, K in ((False, 4), (True, h.CHAIN_K)):
                xi, xv, yy, zn = h.walk_inputs(rng, "criteo", K, dtype, dev)
                mg = xv.new_zeros(K)
                fn = functools.partial(kf.walk_chunk, xi, xv, yy, zn, mg, 0,
                                       **h.FTRL_HP, chained=chained)
                out["walk"][f"{kind} K={K}"] = {
                    "device_ms": h.device_ms(fn, "ftrl_walk")[0]}
    if "split" in parts:
        warm = h.ftrl_warm_model(rng)
        train = h.criteo_ftrl_rows(1, h.FTRL_BATCH)
        out["split_ms"], out["launches"] = h.ftrl_splits(warm, train, kf)
    from alink_tpu_torch.kernels import linear as kl
    lat = h.add_latency(*h.start_chain_probe(_build))
    if "linear_grad" in parts:
        out["linear_grad"] = linear_grad_times(h, kl, lat)
    if "lbfgs" in parts:
        fb, y = h.fb_criteo(0)
        out["lbfgs"] = h.lbfgs_timing(kl, ks, {
            "fb_idx": fb, "y": y, "w": np.ones(len(y), np.float32)}, 0)
    if "p2" in parts:
        out["p2"] = scatter_times(h, kl, lat)
    if "steps" in parts:
        out["steps"] = step_times(h, kl, kf)
    if "drain" in parts:
        out["drain"] = drain_times(h)
    if "p3" in parts:
        out["p3"] = row_scatter_times(h)
    return out


def row_scatter_times(h, reps=3):
    """``p3``: see the module's docstring."""
    import torch
    from alink_tpu_torch.common.mlenv import MLEnvironment
    from alink_tpu_torch.kernels import linear as kl
    from alink_tpu_torch.kernels import rows as kr
    from alink_tpu_torch.operator.common.nlp.word2vec import (
        Word2VecParams, word2vec_train)
    dev = torch.device("cuda")
    table = h.text8_corpus(8)
    p = Word2VecParams(num_iter=1)
    vocab, pairs, points = h.w2v_layout(table, p)
    out = {}
    for name, state, keys, terms in h.w2v_p3_inputs(vocab, pairs, points, p,
                                                    dev):
        got = kr.scatter_rows(state.clone(), keys, terms)
        want = kr.scatter_rows_plain(state.cpu(), keys.cpu(), terms.cpu())
        st = state.clone()

        def call():
            kr.scatter_rows(st, keys, terms)

        def lib():
            st.index_add_(0, keys, terms)
        k_ms, l_ms = h.cuda_ms_turns(call, lib, trials=9, reps=10)
        dev_ms, per = h.device_ms_seen(call, "")
        kr.reset_launch_counts()
        kl.reset_launch_counts()
        call()
        torch.cuda.synchronize()
        out[name] = {"bitwise": h.same_bits(got.cpu(), want)[0],
                     "kernel_ms": k_ms, "index_add_ms": l_ms,
                     "device_ms": dev_ms, "device_kernels": per,
                     "host_ms": h.host_ms(call, trials=9, reps=10),
                     "launches": {**kr.launch_counts(),
                                  **kl.launch_counts()},
                     "positions": int(keys.numel()),
                     "small_path": keys.numel() <= getattr(kr, "SMALL_MAX",
                                                           0)}
    secs = []
    for i in range(reps + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        word2vec_train(table, "doc", p, env=MLEnvironment(device="cuda"))
        torch.cuda.synchronize()
        if i:
            secs.append(time.perf_counter() - t0)
    out["epoch"] = {"s": float(np.median(secs)), "runs_s": secs,
                    "batches": -(-int(pairs.shape[0]) // p.batch_size)}
    return out


def sparse_times(h, ks, rng, dev, out):
    """``serve_sparse`` in the four modes and ``F.embedding_bag``."""
    import torch
    import torch.nn.functional as F
    n, width = h.SPARSE_ROWS, -(-h.NNZ // 8) * 8
    ws = torch.from_numpy((rng.standard_normal(h.FEATURES) * 0.05)
                          .astype(np.float32))
    b = torch.tensor(0.125, dtype=torch.float32)
    idx0, val0 = h.criteo_rows(rng, n)
    idx = torch.zeros((n, width), dtype=torch.int32)
    val = torch.zeros((n, width), dtype=torch.float32)
    idx[:, :h.NNZ] = torch.from_numpy(idx0)
    val[:, :h.NNZ] = torch.from_numpy(val0)
    i = idx.to(dev)
    for mode, sdtype in h.MODES:
        v = val.to(dev, torch.float64 if mode == "f64" else torch.float32)
        md = h.model_arrays(ks, ws, b, mode, dev)
        fn = lambda: ks.sparse_scores(md, i, v, sdtype)       # noqa: E731
        out["sparse"][mode] = {"device_ms": h.device_ms(fn,
                                                        "serve_sparse")[0]}
        if mode != "f32":
            continue
        lib = lambda: F.embedding_bag(                        # noqa: E731
            i, md[0][:, None], per_sample_weights=v, mode="sum")
        k_ms, l_ms = h.cuda_ms_turns(fn, lib)
        k_host, l_host = h.host_ms_turns(fn, lib)
        out["sparse"][mode].update(kernel_ms=k_ms, host_ms=k_host)
        out["sparse"]["embedding_bag"] = {
            "kernel_ms": l_ms, "device_ms": h.device_ms(lib)[0],
            "host_ms": l_host}
        stage = []
        for _ in range(51):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            stage.append((time.perf_counter() - t0) * 1e3)
        out["sparse"]["kernel_stage_ms"] = float(np.median(stage[1:]))


LINEAR_CASES = (("fieldblock", "f32"), ("fieldblock", "f64"), ("coo", "f32"),
                ("coo", "f64"), ("fieldblock_bulk", "f32"),
                ("coo_bulk", "f32"), ("intercept", "f32"))


def linear_grad_times(h, kl, lat):
    """The gradient kernel at :data:`LINEAR_CASES` (inputs from
    ``chip_smoke.py::grad_inputs``, seeded), through the API every tree
    has: ``grad_plan(keys, dim, val)``, whose plan holds the keys and
    values, and ``linear_grad(plan, c)``."""
    import torch
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    out = {}
    for case, kind in LINEAR_CASES:
        keys, val, c, dim = h.grad_inputs(
            rng, case, np.float32 if kind == "f32" else np.float64)
        plan = kl.grad_plan(torch.from_numpy(keys).to(dev), dim,
                            torch.from_numpy(val).to(dev))
        cc = torch.from_numpy(c).to(dev)
        keys_l = plan.keys.reshape(-1).long()

        def call():
            return kl.linear_grad(plan, cc)

        def lib():
            return torch.zeros(dim, dtype=cc.dtype, device=dev).index_add_(
                0, keys_l, (plan.val * cc[:, None]).reshape(-1))
        host = kl.grad_plan(torch.from_numpy(keys), dim,
                            torch.from_numpy(val))
        same, _ = h.same_bits(call().cpu(), kl.linear_grad_plain(
            host, torch.from_numpy(c)))
        k_ms, l_ms = h.cuda_ms_turns(call, lib, trials=9, reps=5)
        longest = int(np.unique(keys, return_counts=True)[1].max())
        chain = h.chain_bound_ms(longest, kind, lat)
        out[f"{case} {kind}"] = {
            "bitwise": same, "kernel_ms": k_ms,
            "device_ms": device_span_ms(call, "linear_grad")[0],
            "index_add_ms": l_ms, "chain_bound_ms": chain,
            "chain_fraction": chain / k_ms, "longest_run": longest}
    out["add_latency"] = lat
    return out


P2_CASES = (("coo", "f32"), ("coo", "f64"), ("coo_intercept", "f32"),
            ("coo_intercept", "f64"), ("coo_bulk", "f32"), ("coo_bulk", "f64"),
            ("stream", "f32"), ("stream", "f64"), ("fb_use", "f32"),
            ("stream_use", "f32"))


def p2_inputs(h, rng, case, dtype):
    """(keys, terms, states) of one ``P2_CASES`` case, from the tree's
    ``chip_smoke.py::scatter_inputs``: the intercept column alone, the
    bulk alone, or zeroed states (the field-blocked step's use)."""
    base = {"coo_intercept": "coo", "coo_bulk": "coo", "fb_use": "fb",
            "stream_use": "stream"}.get(case, case)
    keys, terms, states = h.scatter_inputs(rng, base, dtype)
    if case == "coo_intercept":
        keys, terms = keys[:, :1], terms[:, :1]
    elif case == "coo_bulk":
        keys, terms = keys[:, 1:], terms[:, 1:]
    elif case.endswith("_use"):
        states = np.zeros_like(states)
    return (np.ascontiguousarray(keys), np.ascontiguousarray(terms),
            states)


def plan_ops(kl, kd, size, reps=5):
    """The plan's ops one by one under ``torch.profiler`` (host and
    device): each op's count, self host time and device time a plan."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        kl.run_plan(kd, size)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            kl.run_plan(kd, size)
        torch.cuda.synchronize()
    ops = {}
    for e in prof.key_averages():
        dev_us = float(getattr(e, "self_device_time_total",
                               getattr(e, "self_cuda_time_total", 0)) or 0)
        ops[e.key] = {"count": e.count / reps,
                      "self_host_us": e.self_cpu_time_total / reps,
                      "device_us": dev_us / reps,
                      "device": str(getattr(e, "device_type", ""))}
    return ops


def scatter_times(h, kl, lat):
    """The ordered scatter-add at :data:`P2_CASES`, through the API every
    tree has: ``run_plan(keys, size)`` and ``scatter_walk(z, n, keys,
    terms, plan=)``."""
    import torch
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    out = {}
    for case, kind in P2_CASES:
        dtype = np.float32 if kind == "f32" else np.float64
        keys, terms, states = p2_inputs(h, rng, case, dtype)
        S = states.shape[1]
        kd, td = torch.from_numpy(keys).to(dev), torch.from_numpy(terms).to(dev)
        z, n = (torch.from_numpy(s.copy()).to(dev) for s in states)
        kl.scatter_walk(z, n, kd, td)
        zc, nc = (torch.from_numpy(s.copy()) for s in states)
        kl.scatter_walk_plain(zc, nc, torch.from_numpy(keys),
                              torch.from_numpy(terms))
        same = all(h.same_bits(a.cpu(), b)[0] for a, b in ((z, zc), (n, nc)))
        plan = kl.run_plan(kd, S)
        kls = kd.reshape(-1).long()
        tz, tn = td[..., 0].reshape(-1), td[..., 1].reshape(-1)

        def call():
            kl.scatter_walk(z, n, kd, td, plan=plan)

        def wrapper():
            kl.scatter_walk(z, n, kd, td)

        def plan_only():
            kl.run_plan(kd, S)

        def lib():
            z.index_add_(0, kls, tz)
            n.index_add_(0, kls, tn)
        k_ms, w_ms, p_ms, l_ms = h.cuda_ms_turns(call, wrapper, plan_only,
                                                 lib, trials=9, reps=5)
        k_host, w_host = h.host_ms_turns(call, wrapper, trials=9, reps=5)
        span, seen = device_span_ms(call, "scatter_walk")
        longest = int(np.unique(keys, return_counts=True)[1].max())
        chain = h.chain_bound_ms(longest, kind, lat)
        rec = {"bitwise": same, "kernel_ms": k_ms, "device_ms": span,
               "device_kernels_recorded": seen, "wrapper_ms": w_ms,
               "plan_ms": p_ms, "index_add_ms": l_ms, "host_ms": k_host,
               "wrapper_host_ms": w_host, "chain_bound_ms": chain,
               "device_chain_fraction": chain / span,
               "longest_run": longest, "positions": int(keys.size)}
        if kind == "f32" and case in ("coo", "fb_use"):
            rec["plan_ops"] = plan_ops(kl, kd, S)
        out[f"{case} {kind}"] = rec
    out["add_latency"] = lat
    return out


def step_times(h, kl, kf, reps=15):
    """One 4096-row micro-batch of the padded-COO and field-blocked batch
    steps, float32: ms (host clock, each call ending in a synchronize),
    device ops and busy time under one profiled step, launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from alink_tpu_torch.operator.stream.onlinelearning import ftrl as tf
    from alink_tpu_torch.ops.fieldblock import FieldBlockMeta
    rng = np.random.default_rng(0)
    hp = tuple(h.FTRL_HP[k] for k in ("alpha", "beta", "l1", "l2"))
    out = {}
    for kind, size in (("coo", h.BF_DIM), ("fb", h.BF_FIELDS * h.BF_S)):
        arrays = h.step_inputs(rng, kind, h.BF_ROWS, np.float32)
        t = [None if a is None else torch.from_numpy(a).cuda()
             for a in arrays]
        z = torch.from_numpy(rng.standard_normal(size) * 0.01).cuda().float()
        n = torch.from_numpy(np.abs(rng.standard_normal(size))
                             * 0.01).cuda().float()
        meta = FieldBlockMeta(h.BF_FIELDS, h.BF_S)

        def one():
            if kind == "coo":
                return tf.ftrl_batch_step(*t, z, n, *hp)
            return tf.ftrl_fb_batch_step(*t, z, n, meta, *hp)
        one()
        for k in (kl, kf):
            k.reset_launch_counts()
        one()
        torch.cuda.synchronize()
        launches = {k: v for m in (kl, kf)
                    for k, v in m.launch_counts().items() if v}
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            one()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            one()
            torch.cuda.synchronize()
        busy_us, ops = 0.0, 0
        for e in prof.key_averages():
            if str(getattr(e, "device_type", "")).endswith("CUDA"):
                busy_us += float(getattr(e, "self_device_time_total",
                                         getattr(e, "self_cuda_time_total",
                                                 0)) or 0)
                ops += int(e.count)
        out[kind] = {"step_ms": float(np.median(times)), "device_ops": ops,
                     "device_busy_ms": busy_us / 1e3, "launches": launches}
    return out


def drain_times(h, reps=5):
    """Phase 14's padded-COO batch main path and bench_ftrl's stream,
    each drained through ``FtrlTrainStreamOp`` on the card: seconds a
    drain (median of ``reps`` after a warm one), bare and, where the tree
    has health, with a ``HealthMonitor``, in turns."""
    import torch
    from alink_tpu_torch.model.interop import linear_model_from_numpy
    from alink_tpu_torch.operator.batch.classification import \
        LogisticRegressionTrainBatchOp
    from alink_tpu_torch.operator.batch.feature.feature_ops import \
        FeatureHasherBatchOp
    from alink_tpu_torch.operator.batch.source import MemSourceBatchOp
    from alink_tpu_torch.operator.common.linear.base import \
        LinearModelDataConverter
    from alink_tpu_torch.operator.stream.batch_twins import \
        FeatureHasherStreamOp
    from alink_tpu_torch.operator.stream.onlinelearning import \
        FtrlTrainStreamOp
    from alink_tpu_torch.operator.stream.source import MemSourceStreamOp
    try:
        from alink_tpu_torch.common.health import HealthMonitor
    except ImportError:
        HealthMonitor = None
    rng = np.random.default_rng(1417)
    micro = 6
    rows = h.batch_rows(rng, micro * h.BF_ROWS)
    coef = rng.standard_normal(h.BF_DIM) * 0.01
    coo_warm = MemSourceBatchOp(LinearModelDataConverter("LONG").save_model(
        linear_model_from_numpy(coef, has_intercept=True, label_values=[1, 0],
                                vector_col="vec", vector_size=h.BF_DIM - 1,
                                label_type="LONG")))
    table = h.bench_stream_data()
    st_warm = LogisticRegressionTrainBatchOp(
        vector_col="vec", label_col="click",
        max_iter=h.ST_WARM_ITER).link_from(FeatureHasherBatchOp(
            **h.ST_HASH).link_from(MemSourceBatchOp(
                table.first_n(h.ST_WARM_ROWS))))
    st_warm.get_output_table()

    def coo(**kw):
        op = FtrlTrainStreamOp(coo_warm, vector_col="vec", label_col="label",
                               update_mode="batch", time_interval=2.0,
                               **h.FTRL_HP, **kw).link_from(
            MemSourceStreamOp(rows, batch_size=h.BF_ROWS))
        snaps, secs = h.drain_timed(op)
        assert len(snaps) == micro // 2
        return secs

    def stream(**kw):
        feat = FeatureHasherStreamOp(**h.ST_HASH).link_from(
            MemSourceStreamOp(table, batch_size=h.ST_MICRO))
        op = FtrlTrainStreamOp(st_warm, vector_col="vec", label_col="click",
                               update_mode="batch", time_interval=1e9,
                               **h.FTRL_HP, **kw).link_from(feat)
        snaps, secs = h.drain_timed(op)
        assert snaps
        return secs

    out = {}
    for name, fn in (("coo", coo), ("stream", stream)):
        kinds = ["bare"] + (["monitored"] if HealthMonitor else [])
        times = {k: [] for k in kinds}
        for i in range(reps + 1):
            for k in kinds:
                kw = {"health": HealthMonitor()} if k == "monitored" else {}
                secs = fn(**kw)
                if i:
                    times[k].append(secs)
        torch.cuda.synchronize()
        for k, v in times.items():
            out[f"{name} {k}"] = {"drain_s": float(np.median(v)),
                                  "runs_s": v}
    return out


def _summary(runs):
    by = {}
    for r in runs:
        by.setdefault(r["tree"], []).append(r)

    def med(rs, *path):
        vals = []
        for r in rs:
            v = r
            for p in path:
                v = v.get(p) if isinstance(v, dict) else None
            if v is not None:
                vals.append(v)
        return float(np.median(vals)) if vals else None
    out = {}
    for tree, rs in by.items():
        s = {"runs": len(rs),
             "sparse kernel_stage_ms": med(rs, "sparse", "kernel_stage_ms")}
        for key, rec in rs[0]["sparse"].items():
            if isinstance(rec, dict):
                for f in rec:
                    s[f"sparse {key} {f}"] = med(rs, "sparse", key, f)
        for key, rec in rs[0].get("walk", {}).items():
            s[f"walk {key} device_ms"] = med(rs, "walk", key, "device_ms")
        for mode, rec in rs[0]["split_ms"].items():
            for f in rec:
                s[f"{mode} {f}"] = med(rs, "split_ms", mode, f)
        for key, rec in rs[0].get("linear_grad", {}).items():
            if key != "add_latency":
                for f in rec:
                    if f != "bitwise":
                        s[f"linear_grad {key} {f}"] = med(
                            rs, "linear_grad", key, f)
                s[f"linear_grad {key} bitwise"] = all(
                    r["linear_grad"][key]["bitwise"] for r in rs)
        for key, rec in rs[0].get("p2", {}).items():
            if key == "add_latency":
                continue
            for f, v in rec.items():
                if isinstance(v, (int, float)) and not isinstance(v, bool):
                    s[f"p2 {key} {f}"] = med(rs, "p2", key, f)
            s[f"p2 {key} bitwise"] = all(r["p2"][key]["bitwise"] for r in rs)
        for kind, rec in rs[0].get("steps", {}).items():
            for f in ("step_ms", "device_ops", "device_busy_ms"):
                s[f"step {kind} {f}"] = med(rs, "steps", kind, f)
        for key in rs[0].get("drain", {}):
            s[f"drain {key} s"] = med(rs, "drain", key, "drain_s")
        for key, rec in rs[0].get("p3", {}).items():
            if key == "epoch":
                s["p3 epoch s"] = med(rs, "p3", "epoch", "s")
                continue
            for f in ("kernel_ms", "index_add_ms", "device_ms", "host_ms"):
                s[f"p3 {key} {f}"] = med(rs, "p3", key, f)
            s[f"p3 {key} bitwise"] = all(r["p3"][key]["bitwise"] for r in rs)
        lb = rs[0].get("lbfgs")
        if lb:
            for f in ("ms_per_superstep", "device_busy_ms",
                      "device_busy_share"):
                s[f"lbfgs {f}"] = med(rs, "lbfgs", f)
            for f in lb["stage_ms"]:
                s[f"lbfgs stage {f}"] = med(rs, "lbfgs", "stage_ms", f)
        out[tree] = s
    return out


def main(argv) -> int:
    parts = PARTS
    if argv and argv[0].startswith("--parts="):
        parts = tuple(argv[0].split("=", 1)[1].split(","))
        if not set(parts) <= set(PARTS):
            print(f"kernel_ab: parts are {PARTS}", file=sys.stderr)
            return 2
        argv = argv[1:]
    if len(argv) >= 2 and argv[0] == "--measure":
        print(json.dumps(measure(Path(argv[1]), parts)))
        return 0
    import torch
    if not torch.cuda.is_available() or not argv:
        print("kernel_ab: needs a CUDA device and at least one tree",
              file=sys.stderr)
        return 2
    runs = []
    for tree in argv:
        res = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                              f"--parts={','.join(parts)}", "--measure",
                              str(Path(tree).resolve())],
                             cwd=tree, capture_output=True, text=True,
                             timeout=1200)
        if res.returncode != 0:
            print(res.stdout[-4000:], res.stderr[-4000:], file=sys.stderr)
            return 1
        runs.append(json.loads(res.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]), flush=True)
    print(json.dumps({"summary": _summary(runs)}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
