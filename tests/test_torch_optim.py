"""Slice 7 of the port: the L-BFGS stack on the CPU, against the JAX
package.

The same seeded inputs go through ``alink_tpu``'s objective and
``optimize`` (under a 1-device ``MLEnvironment``) and through the
port's, in float64. Tolerances:

* the log loss and its derivative: rtol 1e-15 (``logaddexp`` and the
  sigmoid are torch's, not XLA's);
* dense and padded-COO margins and the dense gradient: rtol 1e-13 (the
  sum orders are torch's and the sparse score kernel's, left to right);
  the padded-COO gradient and the field-blocked margins without values
  bitwise;
* field-blocked margins with values: within ``F u32 sum|terms|`` (XLA
  sums a row's fields in its own order; measured 4.8e-7, 0.48 of the
  bound);
* the field-blocked gradient: within ``2 cnt u32 sum|terms|`` per slot,
  the gap two float32 summation orders of ``cnt`` terms can have
  (measured at most 0.039 of it);
* ``optimize`` over 10 supersteps: dense and padded-COO rtol 1e-10 on
  the loss curve and the coefficients (atol 1e-12); field-blocked rtol
  1e-6 on the loss curve and atol 1e-4 max|coef| on the coefficients,
  the reference's float32 gradient carried through 10 steps (measured
  2.8e-7 and 5.2e-6 max|coef|);
* at ``epsilon=1e-6``, the same number of supersteps on the three
  layouts of ``dryrun_multichip``; field-blocked with per-field values
  stops one superstep later than the JAX package (float32 noise, Queue
  C of ``ROADMAP.md``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alink_tpu.common.mlenv import MLEnvironment as JEnv
from alink_tpu.operator.common.optim import objfunc as jo
from alink_tpu.operator.common.optim import optimizers as jopt
from alink_tpu.ops.fieldblock import FieldBlockMeta as JMeta
from alink_tpu_torch.common.mlenv import MLEnvironment as TEnv
from alink_tpu_torch.operator.common.optim import objfunc as to
from alink_tpu_torch.operator.common.optim import optimizers as topt
from alink_tpu_torch.ops.fieldblock import FieldBlockMeta as TMeta

U32 = 2.0 ** -24
N, D, F, S = 600, 12, 6, 32


@pytest.fixture(scope="module")
def jenv():
    return JEnv(parallelism=1, devices=jax.devices()[:1])


@pytest.fixture(scope="module")
def tenv():
    return TEnv(device="cpu")


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int64) if a.dtype == np.float64 else a.view(np.int32)


def _data(layout, seed=0, n=N, fb_val=False):
    """The inputs of ``__graft_entry__.dryrun_multichip``'s three linear
    legs, at a size that trains: dense X, the same X as padded-COO over
    all columns (an intercept column first), and a field-blocked design
    (field 0 the intercept), with labels from a seeded true model."""
    rng = np.random.RandomState(seed)
    if layout == "fieldblock":
        fb = rng.randint(0, S, (n, F)).astype(np.int32)
        fb[:, 0] = 0
        truth = rng.randn(F * S) * 0.5
        margin = truth[fb + np.arange(F) * S].sum(1)
        data = {"fb_idx": fb}
        if fb_val:
            val = rng.rand(n, F) + 0.5
            val[:, 0] = 1.0
            data["fb_val"] = val
        dim, meta = F * S, (F, S)
    else:
        X = rng.randn(n, D)
        X[:, 0] = 1.0
        margin = X @ (rng.randn(D) * 0.7)
        if layout == "dense":
            data = {"X": X}
        else:
            data = {"idx": np.tile(np.arange(D, dtype=np.int32), (n, 1)),
                    "val": X}
        dim, meta = D, None
    y = np.where(rng.rand(n) < 1.0 / (1.0 + np.exp(-margin)), 1.0, -1.0)
    data.update(y=y, w=np.ones(n))
    return data, dim, meta


def _objs(dim, meta, **kw):
    return (jo.UnaryLossObjFunc(jo.LogLossFunc(), dim,
                                fb_meta=JMeta(*meta) if meta else None, **kw),
            to.UnaryLossObjFunc(to.LogLossFunc(), dim,
                                fb_meta=TMeta(*meta) if meta else None, **kw))


def test_log_loss_and_derivative():
    rng = np.random.RandomState(1)
    eta = np.concatenate([rng.randn(500) * 8, [0.0, -0.0, 40.0, -40.0,
                                               700.0, -700.0]])
    y = np.where(rng.rand(eta.size) < 0.5, 1.0, -1.0)
    jl, tl = jo.LogLossFunc(), to.LogLossFunc()
    te, ty = torch.from_numpy(eta), torch.from_numpy(y)
    for j, t in ((jl.loss, tl.loss), (jl.derivative, tl.derivative)):
        np.testing.assert_allclose(t(te, ty).numpy(),
                                   np.asarray(j(jnp.asarray(eta),
                                                jnp.asarray(y))),
                                   rtol=1e-15, atol=1e-300)


def _as(data, lib):
    if lib == "jax":
        return {k: jnp.asarray(v) for k, v in data.items()}
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in data.items()}


@pytest.mark.parametrize("layout,fb_val", [("dense", False), ("coo", False),
                                           ("fieldblock", False),
                                           ("fieldblock", True)])
def test_matvec_and_rmatvec(layout, fb_val):
    data, dim, meta = _data(layout, seed=2, fb_val=fb_val)
    rng = np.random.RandomState(3)
    coef, c = rng.randn(dim) * 0.4, rng.randn(N)
    jm = JMeta(*meta) if meta else None
    tm = TMeta(*meta) if meta else None
    jd, td = _as(data, "jax"), _as(data, "torch")
    je = np.asarray(jo.matvec(jd, jnp.asarray(coef), jm))
    te = to.matvec(td, torch.from_numpy(coef), tm).numpy()
    jg = np.asarray(jo.rmatvec(jd, jnp.asarray(c), dim, jm))
    tg = to.rmatvec(td, torch.from_numpy(c), dim, tm).numpy()
    assert te.dtype == je.dtype and tg.dtype == jg.dtype
    if layout != "fieldblock":
        np.testing.assert_allclose(te, je, rtol=1e-13, atol=1e-14)
        if layout == "coo":
            np.testing.assert_array_equal(_bits(tg), _bits(jg))
        else:
            np.testing.assert_allclose(tg, jg, rtol=1e-13, atol=1e-13)
        return
    assert je.dtype == np.float32 and jg.dtype == np.float32
    keys = data["fb_idx"] + np.arange(F) * S
    val = data.get("fb_val", np.ones((N, F)))
    if fb_val:
        row_abs = np.abs(val * coef[keys]).sum(1)
        assert (np.abs(te - je) <= F * U32 * row_abs).all()
    else:
        np.testing.assert_array_equal(_bits(te), _bits(je))
    absterms = np.zeros(dim)
    np.add.at(absterms, keys.reshape(-1), np.abs(val * c[:, None]).reshape(-1))
    cnt = np.bincount(keys.reshape(-1), minlength=dim)
    assert (np.abs(tg - jg) <= 2 * cnt * U32 * absterms).all()


CASES = [("dense", "LBFGS"), ("coo", "LBFGS"), ("fieldblock", "LBFGS"),
         ("coo", "OWLQN"), ("coo", "GD")]


def _run(layout, method, jenv, tenv, max_iter, eps, fb_val=False):
    data, dim, meta = _data(layout, fb_val=fb_val)
    kw = dict(l2=1e-3, reg_free_head=S if meta else 1,
              l1=1e-3 if method == "OWLQN" else 0.0)
    jobj, tobj = _objs(dim, meta, **kw)
    jc, jl, js = jopt.optimize(jobj, data, jopt.OptimParams(
        method=method, max_iter=max_iter, epsilon=eps), jenv)
    tc, tl, ts = topt.optimize(tobj, data, topt.OptimParams(
        method=method, max_iter=max_iter, epsilon=eps), tenv)
    return np.asarray(jc), np.asarray(jl), js, tc, tl, ts


@pytest.mark.parametrize("layout,method", CASES)
def test_optimize_matches_ten_supersteps(layout, method, jenv, tenv):
    jc, jl, js, tc, tl, ts = _run(layout, method, jenv, tenv, 10, 0.0)
    assert js == ts == 10 and tl.dtype == np.float64
    assert np.isfinite(tl).all() and tl[-1] < tl[0]
    if layout == "fieldblock":
        np.testing.assert_allclose(tl, jl, rtol=1e-6)
        np.testing.assert_allclose(tc, jc, rtol=0,
                                   atol=1e-4 * np.abs(jc).max())
    else:
        np.testing.assert_allclose(tl, jl, rtol=1e-10, atol=1e-12)
        np.testing.assert_allclose(tc, jc, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("layout", ["dense", "coo", "fieldblock"])
def test_optimize_converges_in_the_same_supersteps(layout, jenv, tenv):
    _, jl, js, _, tl, ts = _run(layout, "LBFGS", jenv, tenv, 100, 1e-6)
    assert 1 < js < 100 and ts == js and len(tl) == ts


def test_fieldblock_values_stop_within_the_float32_noise(jenv, tenv):
    """With per-field values the stop step is a float32 coin: here the
    JAX package stops at superstep 25 (grad_norm 7.80e-7 < 1e-6) and the
    port at 26 (grad_norm 1.46e-6 at 25, 5.94e-7 at 26), as the gradient
    norm has reached the float32 gradient's noise (ROADMAP Queue C). The
    losses agree at rtol 1e-6 over the common supersteps."""
    _, jl, js, _, tl, ts = _run("fieldblock", "LBFGS", jenv, tenv, 100,
                                1e-6, fb_val=True)
    assert (js, ts) == (25, 26)
    np.testing.assert_allclose(tl[:js], jl, rtol=1e-6)


def test_probe_series_match_the_reference(jenv, tenv):
    """The optimizer's health probes (loss, grad_norm, nonfinite.grad,
    update_ratio): float32 series of the run's length, equal to the JAX
    package's ``probe_series`` within float32 rounding."""
    data, dim, meta = _data("coo")
    jobj, tobj = _objs(dim, meta, l2=1e-3)
    got = {}
    for name, opt, obj, env in (("jax", jopt, jobj, jenv),
                                ("torch", topt, tobj, tenv)):
        res = {}
        orig = opt.IterativeComQueue.exec

        def spy(self, _orig=orig, _res=res):
            r = _orig(self)
            _res["r"] = r
            return r
        opt.IterativeComQueue.exec = spy
        try:
            opt.optimize(obj, data, opt.OptimParams(max_iter=8, epsilon=0.0),
                         env)
        finally:
            opt.IterativeComQueue.exec = orig
        got[name] = res["r"].probes()
    assert sorted(got["torch"]) == sorted(got["jax"]) == [
        "grad_norm", "loss", "nonfinite.grad", "update_ratio"]
    for k, j in got["jax"].items():
        t = got["torch"][k]
        assert t.dtype == np.float32 and t.shape == j.shape == (8,)
        np.testing.assert_allclose(t, j, rtol=4 * U32, atol=0)


@pytest.mark.parametrize("vals", [[3.0, 1.0, 1.0, 2.0], [1.0, np.nan, 0.5],
                                  [np.inf, np.inf], [2.0, -np.inf, -np.inf],
                                  [np.nan, np.nan, 1.0]])
def test_argmin_keeps_jax_first_index_rule(vals):
    a = np.asarray(vals)
    assert int(topt._argmin_first(torch.from_numpy(a))) == \
        int(jnp.argmin(jnp.asarray(a)))


def test_left_out_methods_and_options_raise(tenv):
    data, dim, meta = _data("dense")
    _, tobj = _objs(dim, meta)
    # a resume request without a checkpoint directory is refused
    # (checkpoints are ported: tests/test_torch_recovery.py); a health
    # monitor is accepted with or without one (tests/test_torch_health.py)
    for kw in ({"health": object()},
               {"checkpoint_dir": "/x", "health": object()}):
        assert topt.OptimParams(**kw).health is kw["health"]
    with pytest.raises(ValueError, match="requires checkpoint_dir"):
        topt.optimize(tobj, data, topt.OptimParams(resume_from="/x"), tenv)
    with pytest.raises(ValueError):
        topt.optimize(tobj, data, topt.OptimParams(method="nope"), tenv)
