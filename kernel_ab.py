#!/usr/bin/env python3
"""Old against new: the FTRL steps, the sparse serving kernel, the ordered
gradient kernel and the L-BFGS superstep of two trees of this
repository, timed in turns on one NVIDIA GPU.

    mkdir -p ab/parent && git archive <commit> | tar -x -C ab/parent
    python3 kernel_ab.py ab/parent . . ab/parent     # ab/: listed in .gitignore

Each tree named on the command line is measured in a process of its own,
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
  2-10).
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


def measure(tree: Path) -> dict:
    sys.path.insert(0, str(tree))
    import torch
    import torch.nn.functional as F
    h = _helpers(tree)
    from alink_tpu_torch.kernels import _build
    from alink_tpu_torch.kernels import ftrl as kf
    from alink_tpu_torch.kernels import serve as ks
    assert Path(ks.__file__).resolve().is_relative_to(tree.resolve())
    _build.build()
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    out = {"tree": str(tree), "sparse": {}, "split_ms": {}, "launches": {}}
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
    if hasattr(kf, "walk_chunk"):
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
    warm = h.ftrl_warm_model(rng)
    train = h.criteo_ftrl_rows(1, h.FTRL_BATCH)
    out["split_ms"], out["launches"] = h.ftrl_splits(warm, train, kf)
    from alink_tpu_torch.kernels import linear as kl
    out["linear_grad"] = linear_grad_times(h, kl, h.add_latency(
        *h.start_chain_probe(_build)))
    fb, y = h.fb_criteo(0)
    out["lbfgs"] = h.lbfgs_timing(kl, ks, {
        "fb_idx": fb, "y": y, "w": np.ones(len(y), np.float32)}, 0)
    out["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    return out


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
            "device_ms": h.device_ms_per_launch(call,
                                                "linear_grad_kernel")[0],
            "index_add_ms": l_ms, "chain_bound_ms": chain,
            "chain_fraction": chain / k_ms, "longest_run": longest}
    out["add_latency"] = lat
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
    if len(argv) >= 2 and argv[0] == "--measure":
        print(json.dumps(measure(Path(argv[1]))))
        return 0
    import torch
    if not torch.cuda.is_available() or not argv:
        print("kernel_ab: needs a CUDA device and at least one tree",
              file=sys.stderr)
        return 2
    runs = []
    for tree in argv:
        res = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                              "--measure", str(Path(tree).resolve())],
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
