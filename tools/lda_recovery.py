#!/usr/bin/env python3
"""Planted-topic recovery of the LDA trainers on ``chip_smoke.py`` phase
21(b)'s corpus, on the CPU: the JAX package's and the port's.

    JAX_PLATFORMS=cpu python3 tools/lda_recovery.py [--seeds 3,0,1]
        [--methods em,gibbs,online] [--no-port] [--out FILE]

The corpus is phase 21(b)'s (``chip_smoke.py::newsgroups_corpus(5)``:
11,314 documents of Poisson(150) tokens over 30,000 words from 20
planted topics), each trainer runs ``LDA_ITERS`` (10) iterations with
phase 21's settings (online at ``LDA_ONLINE``), and a planted topic counts
as recovered when its best learned topic reaches ``LDA_COSINE`` (0.9), as
the phase counts it. The JAX package runs under a one-device
``MLEnvironment`` (the CPU reference, as the tests run it); the port runs
with ``device="cpu"``. Prints one JSON line a run and a summary line:
for each package and method, the recovered counts and mean best cosines
over the seeds. A few minutes and a few GiB of memory at the defaults.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def _trainers(pkg, env, m):
    """``{method: (ids, cnts, seed) -> (word-topic (V, k), ...)}``."""
    common = dict(num_iter=m.LDA_ITERS, env=env)
    return {
        "em": lambda ids, cnts, s: pkg.em_lda_train(
            ids, cnts, m.LDA_K, m.LDA_VOCAB, seed=s, **common),
        "gibbs": lambda ids, cnts, s: pkg.gibbs_lda_train(
            ids, cnts, m.LDA_K, m.LDA_VOCAB, seed=s, **common),
        "online": lambda ids, cnts, s: pkg.online_lda_train(
            ids, cnts, m.LDA_K, m.LDA_VOCAB, seed=s, **common,
            **m.LDA_ONLINE)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", default="3,0,1")
    ap.add_argument("--methods", default="em,gibbs,online")
    ap.add_argument("--no-port", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import chip_smoke as m
    planted, ids, cnts, _ = m.newsgroups_corpus(5)
    seeds = [int(s) for s in args.seeds.split(",")]
    methods = args.methods.split(",")
    packages = {}
    import jax
    from alink_tpu.common.mlenv import MLEnvironment as JEnv
    from alink_tpu.operator.common.clustering import lda as jl
    packages["jax"] = _trainers(jl, JEnv(parallelism=1,
                                         devices=jax.devices()[:1]), m)
    if not args.no_port:
        from alink_tpu_torch.common.mlenv import MLEnvironment as TEnv
        from alink_tpu_torch.operator.common.clustering import lda as tl
        packages["port"] = _trainers(tl, TEnv(device="cpu"), m)
    runs = []
    for pkg, fns in packages.items():
        for method in methods:
            for s in seeds:
                t0 = time.perf_counter()
                res = fns[method](ids, cnts, s)
                secs = time.perf_counter() - t0
                wt = np.asarray(res[0], np.float64)
                if method == "online":
                    wt = (wt / wt.sum(1, keepdims=True)).T
                cos = m._best_cosines(planted, wt)
                rec = {"package": pkg, "method": method, "seed": s,
                       "recovered": int((cos >= m.LDA_COSINE).sum()),
                       "mean_cosine": float(cos.mean()),
                       "best_cosines": np.sort(cos).round(4).tolist(),
                       "log_perplexity": float(res[-1]), "s": secs}
                runs.append(rec)
                print(json.dumps(rec), flush=True)
    summary = {}
    for r in runs:
        d = summary.setdefault(r["package"], {}).setdefault(
            r["method"], {"seeds": [], "recovered": [], "mean_cosine": []})
        d["seeds"].append(r["seed"])
        d["recovered"].append(r["recovered"])
        d["mean_cosine"].append(r["mean_cosine"])
    print(json.dumps({"summary": summary}), flush=True)
    if args.out:
        Path(args.out).write_text(json.dumps({"runs": runs,
                                              "summary": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
