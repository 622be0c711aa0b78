#!/usr/bin/env python3
"""Old against new: the serving and FTRL gather kernels of two trees of
this repository, timed in turns on one NVIDIA GPU.

    mkdir -p ab/parent && git archive <commit> | tar -x -C ab/parent
    python3 kernel_ab.py ab/parent . . ab/parent     # ab/: listed in .gitignore

Each tree named on the command line is measured in a process of its own,
in the order given (parent, change, change, parent is the fair order),
from its own checkout: its kernels are built from its own sources into
its own ``build/``, and its own wrappers are called. Each run prints one
JSON line; the last line sums them up by tree (the median of its runs).

What a run measures (``chip_smoke.py``'s helpers: kernel time by CUDA
events over back-to-back calls, device time by ``torch.profiler``, host
time as the enqueue cost of back-to-back calls; a kernel and the library
call it is held against are timed in turns):

* ``serve_dense`` at (512, 1024) in the four modes, and ``torch.mv``;
  the "kernel" stage of a dispatch (one call and a synchronize, host
  clock, median of 50);
* ``gather_rows`` at the FTRL steps' shapes (f32, M = 160, 640, 1280,
  C = 1 and 2), ``index_select`` beside it, and ``gather_pair`` where the
  tree has it;
* one 4096-row micro-batch of ``ftrl_sample_step`` on Criteo-shape rows
  (40 slots of 2^20 + 1, float32), host clock ending in a synchronize,
  median of 3 after a warm-up, with its launches counted; where the tree
  has ``gather_pair``, the same step with each chunk's z and n gathered
  by two ``gather_rows`` and a stack instead, 4 of each in turns in the
  one process.
"""

from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent


def _helpers():
    spec = importlib.util.spec_from_file_location("_smoke_helpers",
                                                  HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def measure(tree: Path) -> dict:
    sys.path.insert(0, str(tree))
    import torch
    h = _helpers()
    from alink_tpu_torch.kernels import _build
    from alink_tpu_torch.kernels import ftrl as kf
    from alink_tpu_torch.kernels import serve as ks
    from alink_tpu_torch.operator.stream.onlinelearning.ftrl import \
        ftrl_sample_step
    assert Path(ks.__file__).resolve().is_relative_to(tree.resolve())
    _build.build()
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    out = {"tree": str(tree), "dense": {}, "gather": {}, "gather_pair": {}}
    X32 = torch.from_numpy(rng.standard_normal((512, 1024))
                           .astype(np.float32))
    w32 = torch.from_numpy((rng.standard_normal(1024) * 0.05)
                           .astype(np.float32))
    b = torch.tensor(0.125, dtype=torch.float32)
    for mode, sdtype in h.MODES:
        X = X32.to(dev, torch.float64 if mode == "f64" else torch.float32)
        md = h.model_arrays(ks, w32, b, mode, dev)
        fn = lambda: ks.dense_scores(md, X, sdtype)          # noqa: E731
        out["dense"][mode] = {"device_ms": h.device_ms(fn, "serve_dense")[0]}
        if mode != "f32":
            out["dense"][mode].update(kernel_ms=h.cuda_ms(fn),
                                      host_ms=h.host_ms(fn))
        else:
            lib = lambda: torch.mv(X, md[0])                  # noqa: E731
            k_ms, l_ms = h.cuda_ms_turns(fn, lib)
            k_host, l_host = h.host_ms_turns(fn, lib)
            out["dense"][mode].update(kernel_ms=k_ms, host_ms=k_host)
            out["dense"]["torch.mv"] = {"kernel_ms": l_ms,
                                        "device_ms": h.device_ms(lib)[0],
                                        "host_ms": l_host}
            stage = []
            for _ in range(51):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                stage.append((time.perf_counter() - t0) * 1e3)
            out["dense"]["kernel_stage_ms"] = float(np.median(stage[1:]))
    for M in (160, 640, 1280):
        for C in (1, 2):
            st, ix, _ = h.ftrl_kernel_inputs(rng, torch.float32, C, M, dev)
            fn = lambda: kf.gather_rows(st, ix)               # noqa: E731
            lib = lambda: torch.index_select(st, 0, ix)       # noqa: E731
            k_ms, l_ms = h.cuda_ms_turns(fn, lib)
            k_host, l_host = h.host_ms_turns(fn, lib)
            out["gather"][f"M={M} C={C}"] = {
                "kernel_ms": k_ms,
                "device_ms": h.device_ms(fn, "ftrl_gather")[0],
                "host_ms": k_host, "index_select_kernel_ms": l_ms,
                "index_select_host_ms": l_host}
            if C == 2 and hasattr(kf, "gather_pair"):
                z, n = st[:, 0].contiguous(), st[:, 1].contiguous()
                fn = lambda: kf.gather_pair(z, n, ix)         # noqa: E731
                out["gather_pair"][f"M={M}"] = {
                    "kernel_ms": h.cuda_ms(fn),
                    "device_ms": h.device_ms(fn, "ftrl_gather")[0],
                    "host_ms": h.host_ms(fn)}
    # one sample-mode micro-batch
    S, B, width = h.FEATURES + 1, h.FTRL_BATCH, h.FTRL_WIDTH
    idx = np.sort(rng.integers(1, S, (B, width)), 1).astype(np.int32)
    idx[:, 0] = 0                                   # the intercept slot
    idx_t = torch.from_numpy(idx).to(dev)
    val = torch.ones((B, width), device=dev)
    y = torch.from_numpy((rng.random(B) < 0.5).astype(np.float32)).to(dev)
    z0 = torch.zeros(S, device=dev)
    n0 = torch.zeros(S, device=dev)

    def step():
        z, n = z0.clone(), n0.clone()
        kf.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ftrl_sample_step(idx_t, val, y, z, n, **h.FTRL_HP)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3
    times = [step() for _ in range(4)]
    out["sample_step_ms"] = float(np.median(times[1:]))
    out["sample_step_launches"] = kf.launch_counts()
    if hasattr(kf, "gather_pair"):
        # the same step with the chunk's z and n gathered as before the
        # pair form (two gathers and a stack), in turns with the pair form
        from alink_tpu_torch.operator.stream.onlinelearning import ftrl as op

        def stacked(z, n, flat):
            return torch.stack([kf.gather_rows(z, flat),
                                kf.gather_rows(n, flat)], -1)
        forms = {"pair": [], "two_gathers_and_stack": []}
        for _ in range(4):
            for form in forms:
                op.gather_pair = kf.gather_pair if form == "pair" \
                    else stacked
                forms[form].append(step())
        op.gather_pair = kf.gather_pair
        out["sample_step_gather_forms_ms"] = forms
    out["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
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
        s = {"runs": len(rs), "sample_step_ms": med(rs, "sample_step_ms"),
             "kernel_stage_ms": med(rs, "dense", "kernel_stage_ms")}
        for sec in ("dense", "gather", "gather_pair"):
            for key in rs[0][sec]:
                if isinstance(rs[0][sec][key], dict):
                    for f in rs[0][sec][key]:
                        s[f"{sec} {key} {f}"] = med(rs, sec, key, f)
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
                             timeout=900)
        if res.returncode != 0:
            print(res.stdout[-4000:], res.stderr[-4000:], file=sys.stderr)
            return 1
        runs.append(json.loads(res.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]), flush=True)
    print(json.dumps({"summary": _summary(runs)}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
