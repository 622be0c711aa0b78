"""The port's durability layer on the CPU: superstep kill-and-resume for
the optimizers and KMeans, FTRL crash-restart in every update mode, the
engine's boundary hooks and snapshot writer, and the checkpoint sink.

Every kill-and-resume case runs the port three times on seeded data:
uninterrupted, killed by an armed fault (``comqueue.superstep`` at a
superstep boundary before its snapshot publishes, ``ftrl.batch`` after a
micro-batch commits, before its periodic save), and resumed from the
newest surviving snapshot. The resumed result equals the uninterrupted
one bit for bit (coefficients, loss curve and step count; centroids and
weights; the final FTRL model table), and it is held against the JAX
package's uninterrupted run of the same case, under a 1-device
``MLEnvironment`` and x64, at the tolerances the other port tests pinned:
rtol 1e-10 (atol 1e-12) for the optimizers, field-blocked L-BFGS rtol
1e-6 on the loss curve and 1e-4 of max|coef| on the coefficients
(``tests/test_torch_optim.py``), rtol 1e-12 for KMeans
(``tests/test_torch_kmeans.py``), rtol 1e-10 for an FTRL stream and
``FB_RTOL`` = 1e-6 for its field-blocked layouts
(``tests/test_torch_ftrl_batch.py``). SGD below ``mini_batch_fraction``
1.0 and the k-means|| init draw from torch generators, whose draws are
not JAX's: those cases are held to the port's own run only.

Then the refusals (other data, a foreign snapshot, other FTRL
hyperparameters or ship dtype, ``resume_from`` without
``checkpoint_dir``), ``set_boundary`` with and without a checkpoint, the
async writer's files equal to the synchronous ones and its failure
failing the run, the corrupted-snapshot fallback, the design plan rebuilt
once on resume and held out of the snapshot, and
``CheckpointSinkStreamOp``.
"""

import hashlib
import os

import jax
import numpy as np
import pytest
import torch

from alink_tpu.common.mlenv import MLEnvironment as JEnv
from alink_tpu.operator.common.optim import objfunc as jo
from alink_tpu.operator.common.optim import optimizers as jopt
from alink_tpu.ops.fieldblock import FieldBlockMeta as JMeta
from alink_tpu_torch.common.checkpoint import (CheckpointError,
                                               checkpoint_tag,
                                               latest_checkpoint,
                                               list_checkpoints,
                                               load_checkpoint)
from alink_tpu_torch.common.faults import FaultInjected, scoped_fault_env
from alink_tpu_torch.common.mlenv import MLEnvironment as TEnv
from alink_tpu_torch.common.mtable import MTable as TMTable
from alink_tpu_torch.common.vector import SparseVector as TSparse
from alink_tpu_torch.engine import AllReduce, IterativeComQueue
from alink_tpu_torch.engine import recovery
from alink_tpu_torch.model.interop import model_table_from_reference
from alink_tpu_torch.operator.batch.source import MemSourceBatchOp as TMemB
from alink_tpu_torch.operator.common.clustering import kmeans as tk
from alink_tpu_torch.operator.common.linear.base import \
    LinearModelDataConverter as TConverter
from alink_tpu_torch.operator.common.optim import objfunc as to
from alink_tpu_torch.operator.common.optim import optimizers as topt
from alink_tpu_torch.operator.stream.onlinelearning import ftrl as tf
from alink_tpu_torch.operator.stream.source import MemSourceStreamOp as TMemS
from alink_tpu_torch.ops.fieldblock import FieldBlockMeta as TMeta

N, D, F, S = 600, 12, 6, 32
FB_RTOL = 1e-6
STREAM_HP = dict(alpha=0.05, beta=1.0, l1=1e-5, l2=1e-5)


@pytest.fixture(scope="module")
def jenv():
    return JEnv(parallelism=1, devices=jax.devices()[:1])


@pytest.fixture(scope="module")
def tenv():
    return TEnv(device="cpu")


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int64) if a.dtype == np.float64 else a.view(np.int32)


def _same_bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype
    np.testing.assert_array_equal(_bits(a), _bits(b))


def _tags(d):
    return [checkpoint_tag(p) for p in list_checkpoints(d)]


# ---------------------------------------------------------------------------
# the optimizers
# ---------------------------------------------------------------------------

def _data(layout, seed=0, n=N):
    """Dense X (an intercept column first), the same X as padded-COO, or a
    field-blocked design (field 0 the intercept), float64, labels from a
    seeded true model."""
    rng = np.random.RandomState(seed)
    if layout == "fieldblock":
        fb = rng.randint(0, S, (n, F)).astype(np.int32)
        fb[:, 0] = 0
        margin = (rng.randn(F * S) * 0.5)[fb + np.arange(F) * S].sum(1)
        data, dim, meta = {"fb_idx": fb}, F * S, (F, S)
    else:
        X = rng.randn(n, D)
        X[:, 0] = 1.0
        margin = X @ (rng.randn(D) * 0.7)
        data = {"X": X} if layout == "dense" else {
            "idx": np.tile(np.arange(D, dtype=np.int32), (n, 1)), "val": X}
        dim, meta = D, None
    y = np.where(rng.rand(n) < 1.0 / (1.0 + np.exp(-margin)), 1.0, -1.0)
    data.update(y=y, w=np.ones(n))
    return data, dim, meta


# (layout, method, loss, mini_batch_fraction, compared with the JAX package)
OPT_CASES = [
    ("dense", "LBFGS", "log", None, True),
    ("coo", "LBFGS", "log", None, True),
    ("fieldblock", "LBFGS", "log", None, True),
    ("coo", "OWLQN", "log", None, True),
    ("coo", "GD", "log", None, True),
    ("dense", "SGD", "log", 1.0, True),
    ("coo", "SGD", "log", 0.5, False),
    ("coo", "NEWTON", "square", None, True),
]
OPT_MAX_ITER, OPT_EVERY, OPT_KILL = 10, 4, 8


def _objective(lib, loss, dim, meta, method):
    kw = dict(l2=1e-3, reg_free_head=S if meta else 1,
              l1=1e-3 if method == "OWLQN" else 0.0)
    fn = {"log": "LogLossFunc", "square": "SquareLossFunc"}[loss]
    if lib == "jax":
        return jo.UnaryLossObjFunc(getattr(jo, fn)(), dim,
                                   fb_meta=JMeta(*meta) if meta else None,
                                   **kw)
    return to.UnaryLossObjFunc(getattr(to, fn)(), dim,
                               fb_meta=TMeta(*meta) if meta else None, **kw)


def _params(method, frac, lib=topt, **ck):
    kw = dict(method=method, max_iter=OPT_MAX_ITER, epsilon=0.0, **ck)
    if frac is not None:
        kw.update(mini_batch_fraction=frac, learning_rate=0.5)
    return lib.OptimParams(**kw)


def _port_run(case, tenv, **ck):
    layout, method, loss, frac, _ = case
    data, dim, meta = _data(layout)
    return topt.optimize(_objective("torch", loss, dim, meta, method), data,
                         _params(method, frac, **ck), tenv)


@pytest.mark.parametrize("case", OPT_CASES,
                         ids=[f"{c[0]}-{c[1]}-{c[3]}" for c in OPT_CASES])
def test_optimizer_kill_and_resume_bitwise(case, tenv, jenv, tmp_path):
    """Uninterrupted, checkpointed every 4, killed at superstep 8 (only
    ckpt-4 survives) and resumed: the same coefficients, loss curve and
    step count, bit for bit; and the JAX package's uninterrupted run
    within the pinned tolerances."""
    plain = _port_run(case, tenv)
    d_full, d_kill = str(tmp_path / "full"), str(tmp_path / "kill")
    full = _port_run(case, tenv, checkpoint_dir=d_full,
                     checkpoint_every=OPT_EVERY)
    assert _tags(d_full) == [4, 8, 10]
    with scoped_fault_env(f"comqueue.superstep:{OPT_KILL}"):
        with pytest.raises(FaultInjected):
            _port_run(case, tenv, checkpoint_dir=d_kill,
                      checkpoint_every=OPT_EVERY)
    assert _tags(d_kill) == [4]
    res = _port_run(case, tenv, checkpoint_dir=d_kill,
                    checkpoint_every=OPT_EVERY, resume_from=d_kill)
    for got in (full, res):
        assert got[2] == plain[2] == OPT_MAX_ITER
        _same_bits(got[0], plain[0])
        _same_bits(got[1], plain[1])
    assert _tags(d_kill) == [4, 8, 10]
    layout, method, loss, frac, vs_jax = case
    if not vs_jax:
        return
    data, dim, meta = _data(layout)
    jc, jl, js = jopt.optimize(_objective("jax", loss, dim, meta, method),
                               data, _params(method, frac, lib=jopt), jenv)
    assert js == res[2]
    if layout == "fieldblock":
        np.testing.assert_allclose(res[1], jl, rtol=FB_RTOL)
        np.testing.assert_allclose(res[0], jc, rtol=0,
                                   atol=1e-4 * np.abs(jc).max())
    else:
        np.testing.assert_allclose(res[1], jl, rtol=1e-10, atol=1e-12)
        np.testing.assert_allclose(res[0], jc, rtol=1e-10, atol=1e-12)


def test_resume_rebuilds_the_design_plan_once(tenv, tmp_path, monkeypatch):
    """The design's plan is built once a run, on its entry superstep: one
    build for the uninterrupted run, one for the resumed one (none a
    product); a snapshot holds the carry without it."""
    case = OPT_CASES[1]
    built = []
    orig = topt.design_plan

    def spy(*a, **kw):
        built.append(1)
        return orig(*a, **kw)
    monkeypatch.setattr(topt, "design_plan", spy)
    d = str(tmp_path)
    _port_run(case, tenv, checkpoint_dir=d, checkpoint_every=OPT_EVERY)
    assert len(built) == 1
    payload, meta = load_checkpoint(list_checkpoints(d)[0])
    assert "__design" not in payload and {"coef", "sk", "yk"} <= set(payload)
    assert isinstance(payload["pos"], int) and payload["nvalid"] == 3
    assert meta["step"] == 4 and meta["stopped"] is False
    with scoped_fault_env("comqueue.superstep:8"):
        with pytest.raises(FaultInjected):
            _port_run(case, tenv, checkpoint_dir=str(tmp_path / "k"),
                      checkpoint_every=OPT_EVERY)
    built.clear()
    _port_run(case, tenv, checkpoint_dir=str(tmp_path / "k"),
              checkpoint_every=OPT_EVERY, resume_from=str(tmp_path / "k"))
    assert len(built) == 1


def test_resume_of_a_finished_run_returns_its_result(tenv, tmp_path):
    """Resuming from a run's final snapshot runs no superstep and returns
    the run's result."""
    case = OPT_CASES[0]
    d = str(tmp_path)
    full = _port_run(case, tenv, checkpoint_dir=d, checkpoint_every=5)
    assert _tags(d) == [5, 10]
    calls = []
    orig = topt._record_loss

    def spy(*a):
        calls.append(1)
        return orig(*a)
    topt._record_loss, saved = spy, orig
    try:
        again = _port_run(case, tenv, checkpoint_dir=d, checkpoint_every=5,
                          resume_from=d)
    finally:
        topt._record_loss = saved
    assert calls == [] and again[2] == full[2]
    _same_bits(again[0], full[0])


# ---------------------------------------------------------------------------
# KMeans
# ---------------------------------------------------------------------------

def _blobs(seed=0):
    r = np.random.RandomState(seed)
    return np.concatenate([r.randn(70, 4) + c for c in (-4.0, 0.0, 4.0)])


@pytest.mark.parametrize("init", ["RANDOM", "K_MEANS_PARALLEL"])
def test_kmeans_kill_and_resume_bitwise(init, tenv, tmp_path):
    """Nine Lloyd supersteps (``tol=0``: no early stop), checkpointed every
    3, killed at superstep 6 (only ckpt-3 survives) and resumed:
    centroids, weights and step count bit for bit; RANDOM
    (whose draws are the JAX package's) within rtol 1e-12 of the JAX
    package's run."""
    X = _blobs()
    kw = dict(k=3, max_iter=9, tol=0.0, init=init, seed=5, env=tenv)
    full = tk.kmeans_train(X, **kw)
    d = str(tmp_path)
    with scoped_fault_env("comqueue.superstep:6"):
        with pytest.raises(FaultInjected):
            tk.kmeans_train(X, checkpoint_dir=d, checkpoint_every=3, **kw)
    assert _tags(d) == [3]
    res = tk.kmeans_train(X, checkpoint_dir=d, checkpoint_every=3,
                          resume_from=d, **kw)
    assert res[2] == full[2] == 9
    _same_bits(res[0], full[0])
    _same_bits(res[1], full[1])
    if init == "RANDOM":
        from alink_tpu.operator.common.clustering.kmeans import \
            kmeans_train as jkmeans
        jc, jw, js = jkmeans(X, k=3, max_iter=9, tol=0.0, init=init,
                             seed=5, env=JEnv(parallelism=1,
                                              devices=jax.devices()[:1]))
        assert js == res[2]
        np.testing.assert_allclose(res[0], np.asarray(jc), rtol=1e-12)
        np.testing.assert_allclose(res[1], np.asarray(jw), rtol=1e-12)


# ---------------------------------------------------------------------------
# the engine: refusals, boundaries, the writer
# ---------------------------------------------------------------------------

def _counter_queue(tenv, scale=1.0, name="acc", **kw):
    def stage(ctx):
        if ctx.is_init_step:
            ctx.put_obj(name, torch.zeros((), dtype=torch.float64))
            ctx.put_obj("seen", [])
        ctx.put_obj("v", ctx.get_obj("scale") * ctx.step_no)
        ctx.put_obj(name, ctx.get_obj(name) + ctx.get_obj("v"))
        ctx.put_obj("seen", ctx.get_obj("seen") + [ctx.step_no])
    stage.__qualname__ = f"stage_{name}"
    return (IterativeComQueue(env=tenv, max_iter=6, **kw)
            .init_with_broadcast_data("scale", np.float64(scale) * np.ones(1))
            .add(stage).add(AllReduce("v")))


def test_resume_refuses_different_data(tenv, tmp_path):
    """Same geometry, other data: the data digest in the signature
    refuses the resume."""
    d = str(tmp_path)
    data, dim, meta = _data("dense", seed=3)
    obj = _objective("torch", "log", dim, meta, "LBFGS")
    topt.optimize(obj, data, _params("LBFGS", None, checkpoint_dir=d,
                                     checkpoint_every=4), tenv)
    other, _, _ = _data("dense", seed=4)
    with pytest.raises(CheckpointError, match="different program"):
        topt.optimize(obj, other, _params("LBFGS", None, checkpoint_dir=d,
                                          checkpoint_every=4, resume_from=d),
                      tenv)


def test_resume_refuses_foreign_snapshot(tenv, tmp_path):
    """Another program (other stage names, other broadcast data, another
    optimizer over the same stages) refuses the snapshot."""
    d = str(tmp_path)
    _counter_queue(tenv).set_checkpoint(d, every=2).exec()
    for q in (_counter_queue(tenv, name="other"),
              _counter_queue(tenv, scale=2.0)):
        with pytest.raises(CheckpointError, match="different program"):
            q.set_checkpoint(d, every=2, resume_from=d).exec()
    data, dim, meta = _data("coo")
    obj = _objective("torch", "log", dim, meta, "LBFGS")
    dq = str(tmp_path / "qn")
    topt.optimize(obj, data, _params("LBFGS", None, checkpoint_dir=dq,
                                     checkpoint_every=4), tenv)
    with pytest.raises(CheckpointError, match="different program"):
        topt.optimize(obj, data, _params("GD", None, checkpoint_dir=dq,
                                         checkpoint_every=4, resume_from=dq),
                      tenv)


def test_resume_from_requires_checkpoint_dir(tenv):
    with pytest.raises(ValueError, match="requires checkpoint_dir"):
        IterativeComQueue(env=tenv, max_iter=2, resume_from="/nowhere")
    data, dim, meta = _data("dense")
    with pytest.raises(ValueError, match="requires checkpoint_dir"):
        topt.optimize(_objective("torch", "log", dim, meta, "LBFGS"), data,
                      _params("LBFGS", None, resume_from="/nowhere"), tenv)
    with pytest.raises(ValueError, match="requires checkpoint_dir"):
        tk.kmeans_train(_blobs(), 3, env=tenv, resume_from="/nowhere")
    for bad in (dict(every=0), dict(keep_last=0)):
        with pytest.raises(ValueError, match=">= 1"):
            IterativeComQueue(env=tenv).set_checkpoint("/x", **bad)


def test_carry_objects_a_snapshot_cannot_hold_raise(tenv, tmp_path):
    def stage(ctx):
        ctx.put_obj("gen", torch.Generator())
    q = IterativeComQueue(env=tenv, max_iter=2).add(stage)
    with pytest.raises(CheckpointError, match="put_derived"):
        q.set_checkpoint(str(tmp_path)).exec()


@pytest.mark.parametrize("with_checkpoint", [False, True])
def test_set_boundary_cadence(tenv, tmp_path, with_checkpoint):
    """The hook runs every 3 supersteps (not at the final state), may
    replace the carry, and wins the cadence over the checkpoint's; with a
    checkpoint, a run killed at superstep 7 (the crash fires at boundary
    9) resumes from ckpt-6, runs the hook again at 6, and ends as the
    uninterrupted run did."""
    def make(calls):
        def hook(carry, step):
            calls.append(step)
            new = dict(carry)
            new["acc"] = carry["acc"] * 2
            return new
        q = _counter_queue(tenv).set_max_iter(10).set_boundary(3, hook)
        if with_checkpoint:
            q.set_checkpoint(str(tmp_path / "ck"), every=2, keep_last=9)
        return q
    calls = []
    full = make(calls).exec()
    assert calls == [3, 6, 9]
    want = full.get("acc").item()
    assert full.step_count == 10 and full.get("seen") == list(range(1, 11))
    if not with_checkpoint:
        assert not os.path.exists(tmp_path / "ck")
        return
    assert _tags(str(tmp_path / "ck")) == [3, 6, 9, 10]
    d = str(tmp_path / "kill")
    calls = []
    q = make(calls)
    q.set_checkpoint(d, every=2)
    with scoped_fault_env("comqueue.superstep:7"):
        with pytest.raises(FaultInjected):
            q.exec()
    assert calls == [3, 6] and _tags(d) == [3, 6]
    calls = []
    q = make(calls)
    q.set_checkpoint(d, every=2, resume_from=d)
    res = q.exec()
    assert calls == [6, 9]
    assert res.get("acc").item() == want and res.step_count == 10
    assert res.get("seen") == list(range(1, 11))


def test_boundary_hook_can_stop_the_run(tenv):
    """A replaced carry is read again by the criterion: a hook that sets
    the stop flag ends the run at its boundary."""
    def stage(ctx):
        if ctx.is_init_step:
            ctx.put_obj("stop", False)
        ctx.put_obj("n", ctx.step_no)

    def hook(carry, step):
        return dict(carry, stop=step >= 4)
    res = (IterativeComQueue(env=tenv, max_iter=20).add(stage)
           .set_compare_criterion(lambda ctx: ctx.get_obj("stop"))
           .set_boundary(2, hook).exec())
    assert res.step_count == 4


def _digests(d):
    out = {}
    for p in list_checkpoints(d):
        man = load_checkpoint(p)[1]
        out[checkpoint_tag(p)] = (man["step"], [
            hashlib.blake2b(open(os.path.join(p, f), "rb").read(),
                            digest_size=16).hexdigest()
            for f in sorted(os.listdir(p)) if f.endswith(".npy")])
    return out


def test_async_and_sync_writers_write_the_same_snapshots(tenv, tmp_path,
                                                         monkeypatch):
    """``ALINK_TPU_ASYNC_SNAPSHOT`` on and off: the same snapshots, array
    file for array file, and the same result."""
    got = {}
    for flag in ("1", "0"):
        monkeypatch.setenv("ALINK_TPU_ASYNC_SNAPSHOT", flag)
        d = str(tmp_path / flag)
        got[flag] = (_port_run(OPT_CASES[1], tenv, checkpoint_dir=d,
                               checkpoint_every=3), _digests(d))
    assert got["1"][1] == got["0"][1] and sorted(got["1"][1]) == [6, 9,
                                                                10]
    _same_bits(got["1"][0][0], got["0"][0][0])
    modes = {r["mode"] for r in recovery.snapshot_records()
             if r["what"] == "save" and r["scope"] == "comqueue"}
    assert modes == {"async", "sync"}


@pytest.mark.parametrize("flag", ["1", "0"])
def test_a_failed_snapshot_fails_the_run(tenv, tmp_path, monkeypatch, flag):
    """A writer failure (an injected ``ckpt.save`` kill at the second
    snapshot) fails the run, with the async writer too; the first
    snapshot stays, and no half snapshot is visible."""
    monkeypatch.setenv("ALINK_TPU_ASYNC_SNAPSHOT", flag)
    d = str(tmp_path)
    with scoped_fault_env("ckpt.save:2-2"):
        with pytest.raises(FaultInjected):
            _port_run(OPT_CASES[0], tenv, checkpoint_dir=d,
                      checkpoint_every=4)
    assert _tags(d) == [4]


def test_corrupt_snapshot_falls_back_to_the_older_one(tenv, tmp_path):
    """A corrupted newest snapshot is skipped: the run resumes from the
    older one and still ends bit for bit as the uninterrupted run."""
    case = OPT_CASES[0]
    plain = _port_run(case, tenv)
    d = str(tmp_path)
    with scoped_fault_env("comqueue.superstep:10"):
        with pytest.raises(FaultInjected):
            _port_run(case, tenv, checkpoint_dir=d, checkpoint_every=4)
    assert _tags(d) == [4, 8]
    newest = list_checkpoints(d)[-1]
    with open(os.path.join(newest, "arr_00000.npy"), "r+b") as f:
        f.seek(-1, os.SEEK_END)
        f.write(b"\x7f")
    assert checkpoint_tag(latest_checkpoint(d)) == 4
    recovery.reset_snapshot_records()
    res = _port_run(case, tenv, checkpoint_dir=d, checkpoint_every=4,
                    resume_from=d)
    _same_bits(res[0], plain[0])
    loads = [r for r in recovery.snapshot_records() if r["what"] == "load"]
    assert [r["tag"] for r in loads] == [4]


# ---------------------------------------------------------------------------
# FTRL crash-restart
# ---------------------------------------------------------------------------

DIM, NNZ, NROWS = 200, 9, 150


def _coo_rows(seed=7, wide=False):
    """Sparse rows over DIM features; ``wide``: the row widths vary (3 to
    20 non-zeros, the widest early), so the padded-COO width grows and
    the later micro-batches are narrower than it."""
    rng = np.random.RandomState(seed)
    wtrue = rng.randn(DIM) * (rng.rand(DIM) < 0.3)
    if wide:
        nnz = np.where(np.arange(NROWS) < 40, rng.randint(12, 21, NROWS),
                       rng.randint(3, 8, NROWS))
    else:
        nnz = np.full(NROWS, NNZ)
    idx = [np.sort(rng.choice(DIM, k, False)) for k in nnz]
    val = [rng.randn(k) for k in nnz]
    y = np.asarray([int(v @ wtrue[i] + 0.1 * rng.randn() > 0)
                    for i, v in zip(idx, val)])
    return idx, val, y


def _fb_cols(seed=11, n=650):
    rng = np.random.RandomState(seed)
    site = rng.randint(0, 60, n)
    cols = {"site": np.char.add("s", site.astype("U3")).astype(object),
            "dev": np.char.add("d", rng.randint(0, 60, n).astype("U3"))
            .astype(object),
            "app": np.char.add("a", rng.randint(0, 60, n).astype("U3"))
            .astype(object),
            "click": (rng.rand(n) < 0.2 + 0.6 * (site % 2)).astype(np.int64)}
    return cols, "site STRING, dev STRING, app STRING, click LONG"


HASH_KW = dict(selected_cols=["site", "dev", "app"],
               categorical_cols=["site", "dev", "app"], output_col="vec",
               num_features=48, field_aware=True)


def _tables(kind):
    """(JAX table, port table, train kwargs) of one stream kind."""
    from alink_tpu.common.mtable import MTable
    from alink_tpu.common.vector import SparseVector
    if kind in ("coo", "wide"):
        idx, val, y = _coo_rows(wide=kind == "wide")
        jv, tv = np.empty(NROWS, object), np.empty(NROWS, object)
        jv[:] = [SparseVector(DIM, i, v) for i, v in zip(idx, val)]
        tv[:] = [TSparse(DIM, i, v) for i, v in zip(idx, val)]
        sch = "vec VECTOR, label LONG"
        return (MTable({"vec": jv, "label": y}, sch),
                TMTable({"vec": tv, "label": y}, sch),
                dict(vector_col="vec", label_col="label"))
    if kind == "fb":
        cols, sch = _fb_cols()
        return (MTable(dict(cols), sch), TMTable(dict(cols), sch),
                dict(vector_col="vec", label_col="click"))
    if kind == "demote":
        # 3 fields of 16: rows one-hot in each field, then, from row 120
        # on, rows with a second slot in field 0 (no longer field-blocked)
        rng = np.random.RandomState(13)
        n, jv, tv = 240, np.empty(240, object), np.empty(240, object)
        y = rng.randint(0, 2, n)
        for i in range(n):
            ix = np.arange(3) * 16 + rng.randint(0, 16, 3)
            if i >= 120:
                ix = np.sort(np.append(ix, (ix[0] + 1) % 16))
            v = np.ones(len(ix)) if i % 7 else rng.rand(len(ix)) + 0.5
            jv[i] = SparseVector(48, ix, v)
            tv[i] = TSparse(48, ix, v)
        sch = "vec VECTOR, label LONG"
        return (MTable({"vec": jv, "label": y}, sch),
                TMTable({"vec": tv, "label": y}, sch),
                dict(vector_col="vec", label_col="label"))
    rng = np.random.RandomState(5)
    X = rng.randn(130, 6)
    y = (X @ rng.randn(6) + 0.3 * rng.randn(130) > 0).astype(np.int64)
    cols = {f"f{j}": X[:, j] for j in range(6)}
    cols["label"] = y
    sch = ", ".join(f"f{j} DOUBLE" for j in range(6)) + ", label LONG"
    return (MTable(dict(cols), sch), TMTable(dict(cols), sch),
            dict(feature_cols=[f"f{j}" for j in range(6)],
                 label_col="label"))


@pytest.fixture(scope="module")
def jax_sid():
    from alink_tpu.common.mlenv import MLEnvironment, MLEnvironmentFactory
    sid = MLEnvironmentFactory.register(
        MLEnvironment(parallelism=1, devices=jax.devices()[:1]))
    yield sid
    MLEnvironmentFactory.remove(sid)


_WARM = {}


def _warm(kind, sid):
    """The JAX package's LR warm start on the first rows of ``kind``'s
    table (hashed field-aware for ``"fb"``), and the port's copy."""
    if kind in _WARM:
        return _WARM[kind]
    from alink_tpu.operator.batch.classification.linear import (
        LogisticRegressionTrainBatchOp)
    from alink_tpu.operator.batch.feature.feature_ops import (
        FeatureHasherBatchOp)
    from alink_tpu.operator.batch.source.sources import MemSourceBatchOp
    jt, _, kw = _tables(kind)
    src = MemSourceBatchOp(jt.first_n(60), ml_environment_id=sid)
    if kind == "fb":
        src = FeatureHasherBatchOp(ml_environment_id=sid,
                                   **HASH_KW).link_from(src)
    warm = LogisticRegressionTrainBatchOp(
        max_iter=3, ml_environment_id=sid, **kw).link_from(src)
    wt = warm.get_output_table()
    _WARM[kind] = (warm, TMemB(model_table_from_reference(
        wt.to_rows(), wt.schema.types[2])))
    return _WARM[kind]


def _port_source(kind, batch_size):
    from alink_tpu_torch.operator.stream.batch_twins import \
        FeatureHasherStreamOp
    src = TMemS(_tables(kind)[1], batch_size=batch_size)
    return FeatureHasherStreamOp(**HASH_KW).link_from(src) \
        if kind == "fb" else src


def _port_model(kind, mode, sid, batch_size, **kw):
    """The final model table's coefficients of one port drain (a snapshot
    only at the end)."""
    op = tf.FtrlTrainStreamOp(
        _warm(kind, sid)[1], device="cpu", ship_dtype=torch.float64,
        update_mode=mode, time_interval=1e9, **_tables(kind)[2],
        **dict(STREAM_HP, **kw)).link_from(_port_source(kind, batch_size))
    snaps = list(op.timed_batches())
    assert len(snaps) == 1
    return TConverter.load_table(snaps[-1][1]).coef


def _jax_model(kind, mode, sid, batch_size):
    from alink_tpu.operator.common.linear.base import LinearModelDataConverter
    from alink_tpu.operator.stream.batch_twins import FeatureHasherStreamOp
    from alink_tpu.operator.stream.onlinelearning.ftrl import \
        FtrlTrainStreamOp
    from alink_tpu.operator.stream.source.sources import MemSourceStreamOp
    src = MemSourceStreamOp(_tables(kind)[0], batch_size=batch_size,
                            ml_environment_id=sid)
    if kind == "fb":
        src = FeatureHasherStreamOp(ml_environment_id=sid,
                                    **HASH_KW).link_from(src)
    op = FtrlTrainStreamOp(_warm(kind, sid)[0], ml_environment_id=sid,
                           update_mode=mode, time_interval=1e9,
                           **_tables(kind)[2], **STREAM_HP).link_from(src)
    return LinearModelDataConverter.load_table(
        list(op.timed_batches())[-1][1]).coef


# (kind, update mode, micro-batch rows, checkpoint every, kill after
# batch, surviving snapshots, batches)
FTRL_CASES = [
    ("coo", "sample", 16, 3, 8, [3, 6], 10),
    ("coo", "chained", 16, 3, 8, [3, 6], 10),
    ("coo", "staleness", 16, 3, 8, [3, 6], 10),
    ("coo", "batch", 16, 3, 8, [3, 6], 10),
    ("wide", "sample", 16, 3, 7, [3, 6], 10),
    ("fb", "batch", 100, 2, 5, [2, 4], 7),
    ("demote", "batch", 40, 2, 5, [2, 4], 6),
    ("demote", "batch", 40, 2, 3, [2], 6),
    ("dense", "batch", 25, 2, 5, [2, 4], 6),
]


@pytest.mark.parametrize("case", FTRL_CASES, ids=[
    f"{c[0]}-{c[1]}-kill{c[4]}" for c in FTRL_CASES])
def test_ftrl_kill_and_resume_bitwise(case, jax_sid, tmp_path, monkeypatch):
    """Killed after micro-batch ``kill`` commits (before its periodic
    save) and restarted on the replayed stream: the final model equals
    the uninterrupted drain's bit for bit, every resumed micro-batch is
    encoded to the uninterrupted one's padded width, and the model is
    within rtol 1e-10 of the JAX package's (``FB_RTOL`` on the
    field-blocked streams). ``demote`` kills after the state left the
    field-blocked layout (kill 5) and before it (kill 3)."""
    kind, mode, bs, every, kill, survivors, batches = case
    widths = []
    step = tf.FtrlTrainer.step

    def spy(self, enc, z, n):
        widths.append((enc.kind, enc.width))
        return step(self, enc, z, n)
    monkeypatch.setattr(tf.FtrlTrainer, "step", spy)
    base = _port_model(kind, mode, jax_sid, bs)
    base_widths, widths[:] = list(widths), []
    assert len(base_widths) == batches
    d = str(tmp_path)
    ck = dict(checkpoint_dir=d, checkpoint_every_batches=every)
    with scoped_fault_env(f"ftrl.batch:{kill}"):
        with pytest.raises(FaultInjected):
            _port_model(kind, mode, jax_sid, bs, **ck)
    assert _tags(d) == survivors
    widths.clear()
    resumed = _port_model(kind, mode, jax_sid, bs, **ck)
    _same_bits(resumed, base)
    assert widths == base_widths[survivors[-1]:]
    want = _jax_model(kind, mode, jax_sid, bs)
    rtol = FB_RTOL if kind in ("fb", "demote") else 1e-10
    np.testing.assert_allclose(resumed, want, rtol=rtol, atol=1e-14)
    # the end-of-stream snapshot: a restart of the finished drain resumes
    # at its end and trains nothing
    assert _tags(d)[-1] == batches
    widths.clear()
    _same_bits(_port_model(kind, mode, jax_sid, bs, **ck), base)
    assert widths == []


def test_ftrl_snapshot_meta(jax_sid, tmp_path):
    """The snapshot holds ``z`` and ``n`` and, in its meta, the layout
    (with the field-blocked geometry), the micro-batches done, the next
    emission time and the padded width."""
    d = str(tmp_path)
    _port_model("fb", "batch", jax_sid, 100, checkpoint_dir=d,
                checkpoint_every_batches=3)
    payload, meta = load_checkpoint(list_checkpoints(d)[0])
    assert set(payload) == {"z", "n"} and payload["z"].dtype == np.float64
    assert meta["layout"] == "fb" and meta["batches_done"] == 3
    assert (meta["fb_S"], meta["fb_num_fields"], meta["fb_field_size"]) \
        == (16, 4, 16)
    assert meta["coo_width"] == 8 and meta["next_emit"] == 1e9
    assert meta["signature"]["kind"] == "ftrl_state"
    assert meta["signature"]["update_mode"] == "batch"


@pytest.mark.parametrize("change", [{"alpha": 0.9}, {"l2": 1e-3},
                                    {"update_mode": "chained"}])
def test_ftrl_resume_refuses_other_hyperparameters(jax_sid, tmp_path,
                                                   change):
    d = str(tmp_path)
    ck = dict(checkpoint_dir=d, checkpoint_every_batches=4)
    _port_model("coo", "sample", jax_sid, 16, **ck)
    kw = dict(change)
    mode = kw.pop("update_mode", "sample")
    with pytest.raises(CheckpointError, match="different FTRL program"):
        _port_model("coo", mode, jax_sid, 16, **ck, **kw)


def test_ftrl_resume_refuses_another_ship_dtype(jax_sid, tmp_path):
    d = str(tmp_path)
    _port_model("coo", "batch", jax_sid, 16, checkpoint_dir=d,
                checkpoint_every_batches=4)
    op = tf.FtrlTrainStreamOp(
        _warm("coo", jax_sid)[1], device="cpu", ship_dtype=torch.float32,
        update_mode="batch", checkpoint_dir=d, checkpoint_every_batches=4,
        **_tables("coo")[2], **STREAM_HP).link_from(
        _port_source("coo", 16))
    with pytest.raises(CheckpointError, match="ships"):
        list(op.timed_batches())


def test_ftrl_resume_off_retrains(jax_sid, tmp_path):
    """``resume=False`` ignores the directory's snapshots and retrains
    from the warm start, writing over them."""
    d = str(tmp_path)
    ck = dict(checkpoint_dir=d, checkpoint_every_batches=4)
    base = _port_model("coo", "batch", jax_sid, 16, **ck)
    again = _port_model("coo", "batch", jax_sid, 16, resume=False, **ck)
    _same_bits(again, base)
    assert _tags(d) == [4, 8, 10]


# ---------------------------------------------------------------------------
# the checkpoint sink
# ---------------------------------------------------------------------------

def _sink_drain(d, table, batch_size, **kw):
    from alink_tpu_torch.operator.base import StreamOperator
    from alink_tpu_torch.operator.stream import CheckpointSinkStreamOp
    CheckpointSinkStreamOp(d, **kw).link_from(
        TMemS(table, batch_size=batch_size))
    StreamOperator.execute()


def test_sink_persist_reload_retention(tmp_path):
    from alink_tpu_torch.operator.stream import CheckpointSinkStreamOp
    d = str(tmp_path / "sink")
    table = TMTable({"x": np.arange(20.0),
                     "s": np.asarray([f"row{i}" for i in range(20)],
                                     object)})
    _sink_drain(d, table, 4, keep_last=2)
    assert len(list_checkpoints(d)) == 2
    got = CheckpointSinkStreamOp.load_latest(d)
    np.testing.assert_array_equal(got.col("x"), np.arange(16.0, 20.0))
    assert list(got.col("s")) == [f"row{i}" for i in range(16, 20)]
    assert CheckpointSinkStreamOp.load_latest(str(tmp_path / "none")) \
        is None


def test_sink_restart_continues_tag_sequence(tmp_path):
    from alink_tpu_torch.operator.stream import CheckpointSinkStreamOp
    d = str(tmp_path / "sink")
    _sink_drain(d, TMTable({"x": np.arange(8.0)}), 2, keep_last=3)
    _sink_drain(d, TMTable({"x": np.arange(100.0, 104.0)}), 2, keep_last=3)
    assert _tags(d) == [4, 5, 6]
    got = CheckpointSinkStreamOp.load_latest(d)
    np.testing.assert_array_equal(got.col("x"), [102.0, 103.0])


def test_sink_numeric_tables_as_arrays_and_every(tmp_path):
    """All-numeric tables persist as ``.npy`` columns (dtypes kept) that
    the JAX package's sink loads too; ``every=2`` keeps every other
    micro-batch."""
    from alink_tpu.operator.stream import CheckpointSinkStreamOp as JSink
    from alink_tpu_torch.common.checkpoint import validate_checkpoint
    from alink_tpu_torch.operator.stream import CheckpointSinkStreamOp
    d = str(tmp_path / "sink")
    table = TMTable({"a": np.arange(6.0), "b": np.arange(6)})
    _sink_drain(d, table, 2, every=2)
    assert _tags(d) == [1, 3]
    manifest = validate_checkpoint(latest_checkpoint(d))
    assert manifest["meta"]["mode"] == "arrays"
    assert len(manifest["arrays"]) == 2
    for got in (CheckpointSinkStreamOp.load_latest(d), JSink.load_latest(d)):
        np.testing.assert_array_equal(got.col("a"), [4.0, 5.0])
        assert got.col("b").dtype.kind == "i"
    with pytest.raises(ValueError, match=">= 1"):
        CheckpointSinkStreamOp(d, every=0)
