"""The port's tuning sweeps (``alink_tpu_torch/tuning``) on the CPU,
against their own serial fits and the JAX package's sweeps.

The counterpart of ``tests/test_sweep.py`` at its sizes (N = 192, D = 6,
8 supersteps). The JAX side runs under a 1-device ``MLEnvironment``;
both packages in float64. Contracts:

* each swept point is BITWISE the port's serial fit of that point
  (``optimize``, ``kmeans_train``, ``ftrl_staleness_step`` drains):
  coefficients, loss curve and step count;
* each swept point is within rtol 1e-10 (atol 1e-12) of the JAX
  package's sweep, dense and padded-COO, with the same step count
  (k-means rtol 1e-12, as ``test_torch_kmeans.py`` holds it). SGD is
  held to the JAX package at ``mini_batch_fraction`` 1.0; below it the
  masks come from ``ComContext.rng()``, so it is held by its
  properties;
* the plan's classification, groups and program count, ASHA's
  survivors and rung log equal the JAX package's;
* kill and resume reproduces the whole population, its pruning
  decisions and its rung log bitwise.

No counterpart: ``TestGeometry``'s HLO collective set and program-cache
key (``test_sweep_hlo_collective_set_matches_serial``,
``test_sweep_flag_folds_into_program_cache_key``): eager PyTorch
compiles no program (ROADMAP A10(b)); and
``test_survivors_stable_across_worker_counts``: the port runs one
worker.
"""

import warnings

import jax
import numpy as np
import pytest
import torch

from alink_tpu.common.mlenv import MLEnvironment as JEnv
from alink_tpu.operator.common.optim.objfunc import (
    LogLossFunc as JLog, SquareLossFunc as JSquare,
    UnaryLossObjFunc as JObj)
from alink_tpu.operator.common.optim.optimizers import (
    OptimParams as JParams)
from alink_tpu.tuning import (AshaConfig as JAsha, SweepPlan as JPlan,
                              classify_param as jclassify,
                              sweep_ftrl as jsweep_ftrl,
                              sweep_kmeans as jsweep_kmeans,
                              sweep_optimize as jsweep)
from alink_tpu_torch.common.faults import FaultInjected, scoped_fault_env
from alink_tpu_torch.common.metrics import MetricsRegistry, set_registry
from alink_tpu_torch.common.mlenv import MLEnvironment as TEnv
from alink_tpu_torch.operator.common.clustering.kmeans import kmeans_train
from alink_tpu_torch.operator.common.optim import objfunc as tobjf
from alink_tpu_torch.operator.common.optim.objfunc import (
    LogLossFunc, SquareLossFunc, UnaryLossObjFunc)
from alink_tpu_torch.operator.common.optim.optimizers import (OptimParams,
                                                              optimize)
from alink_tpu_torch.operator.stream.onlinelearning.ftrl import (
    ftrl_staleness_step)
from alink_tpu_torch.tuning import (CARRY_RESIDENT, TRACE_SHAPING,
                                    AshaConfig, SweepPlan, classify_param,
                                    sweep_ftrl, sweep_kmeans,
                                    sweep_optimize)
from alink_tpu_torch.tuning.sweep import _reset_fallback_warnings

N, D, ITERS = 192, 6, 8
RTOL, ATOL = 1e-10, 1e-12


@pytest.fixture(scope="module")
def jenv():
    return JEnv(parallelism=1, devices=jax.devices()[:1])


@pytest.fixture(scope="module")
def tenv():
    return TEnv(device="cpu")


@pytest.fixture
def fresh_registry():
    reg = MetricsRegistry()
    prev = set_registry(reg)
    try:
        yield reg
    finally:
        set_registry(prev)


def _fixture(seed=0, n=N, d=D, layout="dense"):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d)
    y = np.sign(X @ rng.randn(d) + 0.3 * rng.randn(n))
    if layout == "dense":
        return {"X": X, "y": y, "w": np.ones(n)}
    return {"idx": np.tile(np.arange(d, dtype=np.int32), (n, 1)),
            "val": X, "y": y, "w": np.ones(n)}


def _serial(data, pt, method, env, iters=ITERS, base_lr=1.0, base_l1=0.0,
            frac=0.1, loss=LogLossFunc, warm=None):
    obj = UnaryLossObjFunc(loss(), D, l1=pt.get("l1", base_l1),
                           l2=pt.get("l2", 0.0))
    p = OptimParams(method=method, max_iter=iters,
                    epsilon=pt.get("epsilon", 1e-6),
                    learning_rate=pt.get("learning_rate", base_lr),
                    mini_batch_fraction=pt.get("mini_batch_fraction", frac))
    coef, curve, steps = optimize(obj, data, p, env, warm_start=warm)
    return np.asarray(coef), np.asarray(curve), int(steps)


def _assert_serial(res, data, pts, method, env, **kw):
    for i, pt in enumerate(pts):
        coef, curve, steps = _serial(data, pt, method, env, **kw)
        assert np.array_equal(coef, res.values["coef"][i]), \
            f"{method} point {i}: sweep coef != serial (bitwise)"
        assert steps == int(res.steps[i])
        assert np.array_equal(curve, res.loss_curves[i])


METHODS = [("LBFGS", 1.0, 0.0), ("OWLQN", 1.0, 1e-3), ("GD", 1.0, 0.0),
           ("SGD", 0.1, 0.0), ("NEWTON", 1.0, 0.0)]


class TestBitwiseParity:
    @pytest.mark.parametrize("layout", ["dense", "coo"])
    @pytest.mark.parametrize("method,base_lr,base_l1", METHODS)
    def test_optimizer_points(self, method, base_lr, base_l1, layout, tenv,
                              jenv):
        """Each point bitwise its serial fit, and the sweep within rtol
        1e-10 of the JAX package's (SGD at the full mini-batch)."""
        data = _fixture(layout=layout)
        pts = [{"learning_rate": base_lr, "l2": 1e-4},
               {"learning_rate": base_lr * 0.5, "l2": 1e-2,
                "epsilon": 1e-4}]
        obj = UnaryLossObjFunc(LogLossFunc(), D, l1=base_l1)
        base = OptimParams(method=method, max_iter=ITERS, epsilon=1e-6,
                           learning_rate=base_lr, mini_batch_fraction=1.0)
        res = sweep_optimize(obj, data, base, pts, env=tenv)
        assert res.programs == 1
        _assert_serial(res, data, pts, method, tenv, base_lr=base_lr,
                       base_l1=base_l1, frac=1.0)
        jres = jsweep(JObj(JLog(), D, l1=base_l1), data,
                      JParams(method=method, max_iter=ITERS, epsilon=1e-6,
                              learning_rate=base_lr,
                              mini_batch_fraction=1.0), pts, env=jenv)
        np.testing.assert_allclose(res.values["coef"],
                                   np.asarray(jres.values["coef"]),
                                   rtol=RTOL, atol=ATOL)
        assert np.array_equal(res.steps, np.asarray(jres.steps))
        for a, b in zip(res.loss_curves, jres.loss_curves):
            np.testing.assert_allclose(a, np.asarray(b), rtol=RTOL,
                                       atol=ATOL)
        np.testing.assert_allclose(res.final_loss, jres.final_loss,
                                   rtol=RTOL)

    @pytest.mark.parametrize("dtype", [np.float32, np.float64])
    def test_sgd_below_full_batch(self, dtype, tenv):
        """Below ``mini_batch_fraction`` 1.0 each point draws its serial
        run's mask itself (``ComContext.rng()``, per seed, superstep and
        task): bitwise its serial fit, in float32 data too; the masked
        steps move the model and the loss stays finite."""
        data = {k: v.astype(dtype) for k, v in _fixture(11).items()}
        pts = [{"learning_rate": 0.1, "mini_batch_fraction": 0.45,
                "l2": 1e-3},
               {"learning_rate": 0.05, "mini_batch_fraction": 0.2}]
        obj = UnaryLossObjFunc(LogLossFunc(), D)
        base = OptimParams(method="SGD", max_iter=ITERS, epsilon=1e-6,
                           learning_rate=0.1)
        res = sweep_optimize(obj, data, base, pts, env=tenv)
        _assert_serial(res, data, pts, "SGD", tenv, base_lr=0.1)
        assert res.values["coef"].dtype == dtype
        assert np.isfinite(res.final_loss).all()
        assert (np.abs(res.values["coef"]) > 0).any(axis=1).all()
        assert not np.array_equal(res.values["coef"][0],
                                  res.values["coef"][1])

    def test_regression_loss_and_warm_start(self, tenv, jenv):
        data = _fixture(seed=5)
        data["y"] = np.asarray(data["X"] @ np.arange(1.0, D + 1.0)
                               + 0.1 * data["y"])
        w0 = np.linspace(-0.1, 0.1, D)
        pts = [{"l2": 0.5}, {"l2": 0.01}]
        res = sweep_optimize(UnaryLossObjFunc(SquareLossFunc(), D), data,
                             OptimParams(method="LBFGS", max_iter=ITERS),
                             pts, env=tenv, warm_starts=np.stack([w0, w0]))
        _assert_serial(res, data, pts, "LBFGS", tenv, loss=SquareLossFunc,
                       warm=w0)
        jres = jsweep(JObj(JSquare(), D), data,
                      JParams(method="LBFGS", max_iter=ITERS), pts,
                      env=jenv, warm_starts=np.stack([w0, w0]))
        np.testing.assert_allclose(res.values["coef"],
                                   np.asarray(jres.values["coef"]),
                                   rtol=RTOL, atol=ATOL)

    def test_groups_each_bitwise_and_one_plan_a_group(self, tenv, jenv,
                                                      monkeypatch):
        """A grid over two methods is two groups: each point bitwise its
        serial fit, the program count the JAX package's, and the design's
        plan built once a group (the serial fits build one a
        candidate). At epsilon 0 the l2 = 0.3 point has converged to its
        last ulps by superstep 7, where the line search's argmin breaks a
        tie by an ulp, in the serial fits of both packages alike (9.5e-8
        apart from there; ROADMAP Queue C, "L-BFGS"), so the points are
        held to the JAX package's sweep in the parametrized test above,
        not here."""
        data = _fixture(seed=7, layout="coo")
        calls = []
        real = tobjf.design_plan

        def counted(*a, **k):
            out = real(*a, **k)
            if out is not None:
                calls.append(1)
            return out
        monkeypatch.setattr(tobjf, "design_plan", counted)
        from alink_tpu_torch.operator.common.optim import optimizers
        monkeypatch.setattr(optimizers, "design_plan", counted)
        obj = UnaryLossObjFunc(LogLossFunc(), D)
        base = OptimParams(method="LBFGS", max_iter=ITERS, epsilon=0.0)
        pts = [{"l2": 0.1}, {"l2": 0.3}, {"l2": 0.2, "method": "GD"},
               {"l2": 0.4, "method": "GD"}, {"l2": 0.05}]
        res = sweep_optimize(obj, data, base, pts, env=tenv)
        assert res.programs == 2 and len(calls) == 2
        jres = jsweep(JObj(JLog(), D), data,
                      JParams(method="LBFGS", max_iter=ITERS, epsilon=0.0),
                      pts, env=jenv)
        assert jres.programs == res.programs
        assert np.array_equal(res.steps, np.asarray(jres.steps))
        calls.clear()
        for i, pt in enumerate(pts):
            coef, curve, steps = _serial(
                data, {"l2": pt["l2"], "epsilon": 0.0},
                pt.get("method", "LBFGS"), tenv)
            assert np.array_equal(coef, res.values["coef"][i])
            assert np.array_equal(curve, res.loss_curves[i])
            assert steps == int(res.steps[i])
        assert len(calls) == len(pts)

    def test_kmeans_points(self, tenv, jenv):
        rng = np.random.RandomState(1)
        X = np.concatenate([rng.randn(60, 4) + c for c in (0.0, 5.0)])
        pts = [{"seed": s, "tol": t} for s in (0, 3) for t in (1e-4, 1e-1)]
        res = sweep_kmeans(X, 2, pts, max_iter=10, init="RANDOM", env=tenv)
        assert res.programs == 1
        for i, pt in enumerate(pts):
            C, w, steps = kmeans_train(X, 2, max_iter=10, tol=pt["tol"],
                                       init="RANDOM", seed=pt["seed"],
                                       env=tenv)
            assert np.array_equal(C, res.values["centroids"][i])
            assert np.array_equal(w, res.values["cluster_weights"][i])
            assert steps == int(res.steps[i])
        jres = jsweep_kmeans(X, 2, pts, max_iter=10, init="RANDOM",
                             env=jenv)
        np.testing.assert_allclose(res.values["centroids"],
                                   np.asarray(jres.values["centroids"]),
                                   rtol=1e-12)
        np.testing.assert_allclose(
            res.values["cluster_weights"],
            np.asarray(jres.values["cluster_weights"]), rtol=1e-12)
        assert np.array_equal(res.steps, np.asarray(jres.steps))
        np.testing.assert_allclose(res.final_loss, jres.final_loss,
                                   rtol=1e-12)

    def test_kmeans_parity_health_off(self, tenv, monkeypatch):
        """The sweep's always-on inertia row leaves the centroids those of
        the probes-off serial trainer, and the loss lane is real."""
        monkeypatch.setenv("ALINK_TPU_HEALTH", "0")
        rng = np.random.RandomState(2)
        X = np.concatenate([rng.randn(48, 3) + c for c in (0.0, 5.0)])
        res = sweep_kmeans(X, 2, [{"seed": 0}, {"seed": 2}], max_iter=6,
                           init="RANDOM", env=tenv)
        for i, s in enumerate((0, 2)):
            C, _, _ = kmeans_train(X, 2, max_iter=6, init="RANDOM", seed=s,
                                   env=tenv)
            assert np.array_equal(C, res.values["centroids"][i])
        assert np.isfinite(res.final_loss).all()


class TestPlan:
    def test_classification_tables_are_the_jax_packages(self):
        from alink_tpu.tuning import plan as jp
        assert CARRY_RESIDENT == jp.CARRY_RESIDENT
        assert TRACE_SHAPING == jp.TRACE_SHAPING
        for trainer in CARRY_RESIDENT:
            for name in CARRY_RESIDENT[trainer] | TRACE_SHAPING[trainer]:
                assert classify_param(trainer, name) == \
                    jclassify(trainer, name)
        for bad in (("optimizer", "momentum"), ("gbdt", "learning_rate"),
                    ("ftrl", "time_interval")):
            with pytest.raises(KeyError):
                classify_param(*bad)

    @pytest.mark.parametrize("points", [
        [{"l2": 0.1}, {"l2": 0.2, "method": "SGD"}, {"l2": 0.3},
         {"method": "SGD", "l1": 1.0}],
        [{"l2": 0.1}, {"l2": 0.2, "method": "LBFGS"}],
        [{"max_iter": 3}, {"seed": 2}, {"max_iter": 3, "seed": 2}]])
    def test_groups_are_the_jax_packages(self, points):
        base = {"method": "LBFGS", "max_iter": 10, "seed": 0}
        got = SweepPlan("optimizer", points, base=base)
        want = JPlan("optimizer", points, base=base)
        assert got.groups() == want.groups()
        assert got.carry_axes() == want.carry_axes()
        assert got.trace_axes() == want.trace_axes()

    def test_asha_config_validation(self):
        for bad in ({"rung": 0}, {"rung": 2, "eta": 1},
                    {"rung": 2, "min_points": 0}):
            with pytest.raises(ValueError):
                AshaConfig(**bad)
        with pytest.raises(ValueError):
            SweepPlan("optimizer", [])

    def test_program_count_is_group_count(self, tenv, fresh_registry):
        """One queue a compile group: the engine counts one exec a group,
        whatever the population size or the rung schedule."""
        data = _fixture(seed=7)
        obj = UnaryLossObjFunc(LogLossFunc(), D)
        base = OptimParams(method="LBFGS", max_iter=ITERS, epsilon=0.0)
        for pts, want in (
                ([{"l2": v} for v in (0.0, 0.1)], 1),
                ([{"l2": 0.1}, {"l2": 0.3}, {"l2": 0.2, "method": "GD"},
                  {"l2": 0.4, "method": "GD"}], 2)):
            for asha in (None, AshaConfig(rung=2, eta=2),
                         AshaConfig(rung=3, eta=4)):
                before = fresh_registry.value(
                    "alink_comqueue_execs_total") or 0
                res = sweep_optimize(obj, data, base, pts, env=tenv,
                                     asha=asha)
                assert res.programs == want
                assert fresh_registry.value(
                    "alink_comqueue_execs_total") - before == want


def test_probe_channel_carries_population_series(tenv, monkeypatch):
    """Each superstep records ``sweep.best_loss`` (the lowest loss among
    the alive points) and ``sweep.alive`` (their count)."""
    from alink_tpu_torch.tuning import sweep as sw
    results = []
    real = sw._run_sweep_queue

    def keep(**kw):
        results.append(real(**kw))
        return results[-1]
    monkeypatch.setattr(sw, "_run_sweep_queue", keep)
    data = _fixture(seed=10)
    obj = UnaryLossObjFunc(LogLossFunc(), D)
    base = OptimParams(method="LBFGS", max_iter=ITERS, epsilon=0.0)
    r = sweep_optimize(obj, data, base, [{"l2": 0.0}, {"l2": 0.3}],
                       env=tenv, asha=AshaConfig(rung=4, eta=2))
    probes = results[0].probes()
    assert len(r.rungs) == 1 and r.survivors() == [r.best]
    np.testing.assert_array_equal(probes["sweep.alive"],
                                  [2, 2, 2, 2, 1, 1, 1, 1])
    best = np.minimum(r.loss_curves[0][:4], r.loss_curves[1][:4])
    np.testing.assert_array_equal(probes["sweep.best_loss"][:4],
                                  best.astype(np.float32))
    np.testing.assert_array_equal(probes["sweep.best_loss"][4:],
                                  r.loss_curves[r.best][4:]
                                  .astype(np.float32))


class TestAsha:
    def _pts(self, k=9):
        return [{"l2": 0.0}] + [{"l2": float(1e-3 * (3 ** i))}
                                for i in range(k - 1)]

    def _run(self, seed, env, asha, **kw):
        data = _fixture(seed=seed)
        obj = UnaryLossObjFunc(LogLossFunc(), D)
        base = OptimParams(method="LBFGS", max_iter=ITERS, epsilon=0.0)
        return data, sweep_optimize(obj, data, base, self._pts(), env=env,
                                    asha=asha, **kw)

    def _jax(self, seed, jenv, asha):
        return jsweep(JObj(JLog(), D), _fixture(seed=seed),
                      JParams(method="LBFGS", max_iter=ITERS, epsilon=0.0),
                      self._pts(), env=jenv,
                      asha=JAsha(rung=asha.rung, eta=asha.eta,
                                 min_points=asha.min_points))

    def test_deterministic_prunes_and_matches_the_jax_package(self, tenv,
                                                               jenv):
        asha = AshaConfig(rung=2, eta=3)
        data, r1 = self._run(2, tenv, asha)
        _, r2 = self._run(2, tenv, asha)
        assert r1.survivors() == r2.survivors() and r1.rungs == r2.rungs
        assert np.array_equal(r1.values["coef"], r2.values["coef"])
        assert len(r1.rungs) >= 2
        assert 0 < len(r1.survivors()) < len(self._pts())
        assert r1.pruned_at and r1.best == r2.best
        # the survivor ran to full depth and is bitwise its serial fit
        b = r1.best
        coef, _, steps = _serial(data, self._pts()[b], "LBFGS", tenv)
        assert np.array_equal(coef, r1.values["coef"][b])
        assert steps == int(r1.steps[b])
        jr = self._jax(2, jenv, asha)
        assert r1.survivors() == jr.survivors()
        assert r1.rungs == jr.rungs
        assert r1.best == jr.best
        assert np.array_equal(r1.steps, np.asarray(jr.steps))
        np.testing.assert_allclose(r1.values["coef"],
                                   np.asarray(jr.values["coef"]),
                                   rtol=RTOL, atol=ATOL)

    def test_never_prunes_below_min_points(self, tenv, jenv):
        asha = AshaConfig(rung=2, eta=3, min_points=3)
        _, r = self._run(4, tenv, asha)
        assert len(r.survivors()) == 3
        jr = self._jax(4, jenv, asha)
        assert r.survivors() == jr.survivors() and r.rungs == jr.rungs

    def test_pruned_points_keep_their_state(self, tenv):
        """A pruned point skips its steps: its coefficients and step count
        are its serial fit's at the rung that pruned it."""
        data, r = self._run(2, tenv, AshaConfig(rung=2, eta=3))
        for i, step in r.pruned_at.items():
            coef, curve, steps = _serial(data, self._pts()[i], "LBFGS",
                                         tenv, iters=step)
            assert steps == int(r.steps[i]) == step
            assert np.array_equal(coef, r.values["coef"][i])
            assert np.array_equal(curve, r.loss_curves[i])

    def test_metrics_count_pruned_points(self, tenv, fresh_registry):
        _, r = self._run(2, tenv, AshaConfig(rung=2, eta=3))
        assert fresh_registry.value("alink_sweep_pruned_points_total") == \
            len(r.pruned_at)

    @pytest.mark.parametrize("writer", ["async", "sync"])
    def test_checkpoint_kill_and_resume_bitwise(self, tenv, tmp_path,
                                                monkeypatch, writer):
        """The whole population — pruning decisions and the rung log
        included — resumes bitwise after a kill at a rung boundary: the
        snapshot holds the population and the log, and the hook
        re-derives the boundary's decision."""
        monkeypatch.setenv("ALINK_TPU_ASYNC_SNAPSHOT",
                           "1" if writer == "async" else "0")
        asha = AshaConfig(rung=2, eta=3)
        _, full = self._run(6, tenv, asha,
                            checkpoint_dir=str(tmp_path / "full"))
        _, plain = self._run(6, tenv, asha)
        with scoped_fault_env("comqueue.superstep:4"):
            with pytest.raises(FaultInjected):
                self._run(6, tenv, asha,
                          checkpoint_dir=str(tmp_path / "killed"))
        _, resumed = self._run(6, tenv, asha,
                               checkpoint_dir=str(tmp_path / "killed"),
                               resume_from=str(tmp_path / "killed"))
        for got in (full, resumed):
            assert np.array_equal(got.values["coef"], plain.values["coef"])
            assert np.array_equal(got.alive, plain.alive)
            assert np.array_equal(got.steps, plain.steps)
            for a, b in zip(got.loss_curves, plain.loss_curves):
                assert np.array_equal(a, b)
        assert resumed.rungs == full.rungs
        # once the population is down to min_points the hook is exhausted:
        # without a checkpoint it returns at once, with one the snapshot
        # cadence keeps logging empty decisions (as in the JAX package)
        n = len(plain.rungs)
        assert n >= 2 and full.rungs[:n] == plain.rungs
        assert all(not r["pruned"] for r in full.rungs[n:])

    def test_two_groups_kill_and_resume_bitwise(self, tenv, tmp_path):
        """A kill in the first of two groups (each checkpointed in its own
        subdirectory) resumes that group and runs the second afresh."""
        data = _fixture(seed=6, layout="coo")
        pts = self._pts(7) + [{"l1": 1e-3, "l2": 0.01, "method": "OWLQN"}]
        obj = UnaryLossObjFunc(LogLossFunc(), D)
        base = OptimParams(method="LBFGS", max_iter=ITERS, epsilon=0.0)
        asha = AshaConfig(rung=2, eta=2)

        def run(**kw):
            return sweep_optimize(obj, data, base, pts, env=tenv, asha=asha,
                                  **kw)
        plain = run()
        full = run(checkpoint_dir=str(tmp_path / "full"))
        with scoped_fault_env("comqueue.superstep:6"):
            with pytest.raises(FaultInjected):
                run(checkpoint_dir=str(tmp_path / "killed"))
        assert not (tmp_path / "killed" / "group1").exists()
        resumed = run(checkpoint_dir=str(tmp_path / "killed"),
                      resume_from=str(tmp_path / "killed"))
        assert resumed.programs == 2 and resumed.rungs == full.rungs
        assert [r for r in full.rungs if r["pruned"]] == \
            [r for r in plain.rungs if r["pruned"]]
        for got in (full, resumed):
            assert np.array_equal(got.values["coef"], plain.values["coef"])
            assert np.array_equal(got.alive, plain.alive)
            assert np.array_equal(got.steps, plain.steps)

    def test_kmeans_asha_and_resume(self, tenv, tmp_path):
        rng = np.random.RandomState(3)
        X = np.concatenate([rng.randn(50, 3) + c for c in (0.0, 4.0, 8.0)])
        pts = [{"seed": s, "tol": 0.0} for s in range(6)]
        asha = AshaConfig(rung=2, eta=2)
        plain = sweep_kmeans(X, 3, pts, max_iter=8, init="RANDOM",
                             env=tenv, asha=asha)
        with scoped_fault_env("comqueue.superstep:4"):
            with pytest.raises(FaultInjected):
                sweep_kmeans(X, 3, pts, max_iter=8, init="RANDOM", env=tenv,
                             asha=asha, checkpoint_dir=str(tmp_path))
        resumed = sweep_kmeans(X, 3, pts, max_iter=8, init="RANDOM",
                               env=tenv, asha=asha,
                               checkpoint_dir=str(tmp_path),
                               resume_from=str(tmp_path))
        assert np.array_equal(plain.values["centroids"],
                              resumed.values["centroids"])
        assert plain.rungs == resumed.rungs
        assert np.array_equal(plain.alive, resumed.alive)


class TestFtrlSweep:
    """FTRL hyperparameter lanes through the staleness step."""

    DIM, NNZ, B, W, NB = 256, 10, 48, 16, 2
    PTS = [{"alpha": 0.05, "l1": 1e-5}, {"alpha": 0.1, "l2": 1e-4},
           {"beta": 2.0}, {"alpha": 0.02, "beta": 0.5, "l1": 1e-4}]

    def _batches(self):
        out = []
        for s in range(self.NB):
            r = np.random.RandomState(s)
            idx = np.zeros((self.B, self.W), np.int32)
            val = np.zeros((self.B, self.W))
            for i in range(self.B):
                idx[i, :self.NNZ] = r.choice(self.DIM, self.NNZ,
                                             replace=False)
            val[:, :self.NNZ] = r.randn(self.B, self.NNZ)
            y = (r.rand(self.B) < 0.5).astype(np.float64)
            out.append((idx, val, y))
        return out

    def _drain(self, batches, pt, K, coef0):
        """The port's serial staleness drain with one point's
        hyperparameters and its warm start."""
        a, b = pt.get("alpha", 0.1), pt.get("beta", 1.0)
        l1, l2 = pt.get("l1", 0.0), pt.get("l2", 0.0)
        z = torch.from_numpy(-coef0 * (b / a + l2))
        n = torch.zeros(self.DIM, dtype=torch.float64)
        ms = []
        for idx, val, y in batches:
            z, n, m = ftrl_staleness_step(
                torch.from_numpy(idx), torch.from_numpy(val),
                torch.from_numpy(y), z, n, a, b, l1, l2, K)
            ms.append(m)
        return z.numpy(), n.numpy(), torch.cat(ms).numpy()

    def test_serial_parity_and_the_jax_package(self, tenv, jenv):
        batches = self._batches()
        coef0 = np.random.RandomState(9).randn(self.DIM) * 0.01
        res = sweep_ftrl(batches, self.DIM, self.PTS,
                         base={"staleness": 16}, coef0=coef0, env=tenv)
        assert res.programs == 1 and not res.fallback
        for i, pt in enumerate(self.PTS):
            z, n, m = self._drain(batches, pt, 16, coef0)
            assert np.array_equal(z.view(np.int64), res.z[i].view(np.int64))
            assert np.array_equal(n.view(np.int64), res.n[i].view(np.int64))
            assert np.array_equal(m.view(np.int64),
                                  res.margins[i].view(np.int64))
        jres = jsweep_ftrl(batches, self.DIM, self.PTS,
                           base={"staleness": 16}, coef0=coef0, env=jenv)
        for got, want in ((res.z, jres.z), (res.n, jres.n),
                          (res.margins, jres.margins)):
            np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL,
                                       atol=1e-14)
        np.testing.assert_allclose(res.pv_logloss, jres.pv_logloss,
                                   rtol=RTOL)
        assert res.best == jres.best

    def test_population_independence_bitwise(self, tenv):
        batches = self._batches()
        coef0 = np.random.RandomState(9).randn(self.DIM) * 0.01
        full = sweep_ftrl(batches, self.DIM, self.PTS,
                          base={"staleness": 16}, coef0=coef0, env=tenv)
        solo = sweep_ftrl(batches, self.DIM, [self.PTS[2]],
                          base={"staleness": 16}, coef0=coef0, env=tenv)
        assert np.array_equal(solo.z[0].view(np.int64),
                              full.z[2].view(np.int64))
        assert np.array_equal(solo.margins[0].view(np.int64),
                              full.margins[2].view(np.int64))

    def test_trace_axis_falls_back_recorded_and_identical(
            self, tenv, fresh_registry):
        _reset_fallback_warnings()
        batches = self._batches()
        pts = [{"alpha": 0.05, "staleness": 8},
               {"alpha": 0.1, "staleness": 16}]
        with pytest.warns(RuntimeWarning, match="trace-shaping-axis"):
            res = sweep_ftrl(batches, self.DIM, pts, env=tenv)
        assert res.fallback and res.programs == 2
        assert fresh_registry.value(
            "alink_sweep_fallback_total",
            {"estimator": "ftrl", "reason": "trace-shaping-axis"}) == 1
        for i, pt in enumerate(pts):
            z, _, m = self._drain(batches, pt, pt["staleness"],
                                  np.zeros(self.DIM))
            assert np.array_equal(z.view(np.int64), res.z[i].view(np.int64))
            assert np.array_equal(m.view(np.int64),
                                  res.margins[i].view(np.int64))
        _reset_fallback_warnings()

    def test_uniform_explicit_staleness_keeps_one_program(self, tenv):
        _reset_fallback_warnings()
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            res = sweep_ftrl(self._batches(), self.DIM,
                             [{"alpha": 0.05, "staleness": 16},
                              {"alpha": 0.1}],
                             base={"staleness": 16}, env=tenv)
        assert res.programs == 1 and not res.fallback

    def test_update_mode_axis_refused_loudly(self, tenv):
        with pytest.raises(ValueError, match="bounded-staleness"):
            sweep_ftrl(self._batches(), self.DIM,
                       [{"alpha": 0.05, "update_mode": "chained"}],
                       env=tenv)

    def test_winner_is_lowest_pv_logloss(self, tenv):
        res = sweep_ftrl(self._batches(), self.DIM, self.PTS,
                         base={"staleness": 16}, env=tenv)
        key = np.where(np.isfinite(res.pv_logloss), res.pv_logloss, np.inf)
        assert res.best == int(np.argmin(key))
        # a diverged lane's loss is NaN and ranks last
        res.pv_logloss[res.best] = np.nan
        assert res.best != int(np.argmin(key))


def test_flags_are_the_jax_packages(monkeypatch):
    from alink_tpu_torch.common.flags import FLAGS
    from alink_tpu_torch.tuning import sweep_enabled, sweep_eta, sweep_rung
    for name, default in (("ALINK_TPU_SWEEP", False),
                          ("ALINK_TPU_SWEEP_ETA", 3),
                          ("ALINK_TPU_SWEEP_RUNG", 0)):
        assert FLAGS.get(name).default == default
    assert (sweep_enabled(), sweep_eta(), sweep_rung()) == (False, 3, 0)
    monkeypatch.setenv("ALINK_TPU_SWEEP", "1")
    monkeypatch.setenv("ALINK_TPU_SWEEP_ETA", "1")
    monkeypatch.setenv("ALINK_TPU_SWEEP_RUNG", "4")
    assert (sweep_enabled(), sweep_eta(), sweep_rung()) == (True, 2, 4)
    from alink_tpu_torch.tuning.sweep import _resolve_asha
    assert _resolve_asha(True, 40) == AshaConfig(rung=4, eta=2)
    monkeypatch.delenv("ALINK_TPU_SWEEP_RUNG")
    assert _resolve_asha(True, 40) == AshaConfig(rung=10, eta=2)
    assert _resolve_asha(None, 40) is None
