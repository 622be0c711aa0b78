"""Training health in the port against the JAX package.

``alink_tpu_torch/common/health.py`` is a copy of the JAX package's
module; the port feeds it from its own engine (``IterativeComQueue.
set_health``: the probes of every snapshot boundary's host carry and of
the result) and from its FTRL drain (the progressive-validation scalars
queued on the device and read at snapshot and checkpoint boundaries,
the weight drift of every host snapshot). Each case drives the same
seeded inputs through both packages (the JAX side on a 1-device
``MLEnvironment`` under x64) and holds the port to the JAX package:

* each rule and ``HealthMonitor`` on the same series: equal alerts,
  equal ``report()`` apart from its timestamp, equal registry series;
* the four entry points with a monitor: equal alert sets, and series
  within the pinned tolerances — the engine's probe series are float32
  in both packages, so L-BFGS (its state within rtol 1e-10) and KMeans
  (1e-12) are held within one float32 rounding (``U32``) of the JAX
  package's; FTRL's batch-mode series are float64 host values, within
  1e-12 on the first micro-batch and 1e-10 over the stream;
* a NaN in the data raises ``HealthAlertError`` in both packages at the
  same boundary, after that boundary's snapshot is on disk, and the
  snapshot resumes;
* ``ALINK_TPU_HEALTH=0`` leaves no probe in the result and no
  ``health_probes`` in the snapshot signature, and a probed snapshot is
  not resumed by a probe-less run, nor the reverse;
* a monitor, or the switch off, changes no bit of a model;
* a report saved by either package loads in the other, and the JAX
  package's ``tools/health.py`` renders the port's.
"""

import importlib.util
import json
import os

import jax
import numpy as np
import pytest
import torch

import alink_tpu.common.health as jh
import alink_tpu.common.metrics as jmet
import alink_tpu_torch.common.health as th
import alink_tpu_torch.common.metrics as tmet
from alink_tpu.common.mlenv import MLEnvironment as JEnv
from alink_tpu.operator.common.clustering import kmeans as jk
from alink_tpu.operator.common.optim import objfunc as jo
from alink_tpu.operator.common.optim import optimizers as jopt
from alink_tpu_torch.common.checkpoint import (CheckpointError,
                                               list_checkpoints,
                                               read_manifest)
from alink_tpu_torch.common.mlenv import MLEnvironment as TEnv
from alink_tpu_torch.operator.common.clustering import kmeans as tk
from alink_tpu_torch.operator.common.optim import objfunc as to
from alink_tpu_torch.operator.common.optim import optimizers as topt

U32 = 2.0 ** -23        # one float32 rounding of a value in [1, 2)
N, D = 400, 8


@pytest.fixture(scope="module")
def jenv():
    return JEnv(parallelism=1, devices=jax.devices()[:1])


@pytest.fixture(scope="module")
def tenv():
    return TEnv(device="cpu")


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    """Fresh registries in both packages, the health switch at its
    default."""
    monkeypatch.delenv("ALINK_TPU_HEALTH", raising=False)
    saved = [(m, m.set_registry(m.MetricsRegistry())) for m in (jmet, tmet)]
    yield
    for m, reg in saved:
        m.set_registry(reg)


def _strip(doc):
    return {k: v for k, v in doc.items() if k != "created_unix"}


def _alerts(mon):
    return [a.to_dict() for a in mon.alerts]


def _dumps(v):
    """A JSON text of ``v`` in which NaN equals NaN."""
    return json.dumps(v, sort_keys=True, default=str)


def _same_series(a, b):
    """Two registry snapshots with equal names, labels and values (NaN
    gauges included)."""
    assert _dumps(a) == _dumps(b)


# -- the rule catalog and the monitor ----------------------------------------

SERIES = {
    "converging": {"loss": [5.0, 3.0, 2.0, 1.5, 1.2, 1.1, 1.05, 1.02]},
    "diverging": {"loss": [5.0, 3.0, 2.0, 1.5, 1.4, 2.6, 4.0, 9.0]},
    "plateau": {"loss": [3.0, 2.0] + [1.0] * 18},
    "nan_loss": {"loss": [3.0, 2.0, float("nan"), 1.0]},
    "nonfinite_count": {"nonfinite.grad": [0.0, 0.0, 3.0, 0.0]},
    "update_ratio": {"update_ratio": [0.5, 0.2, 12.0, 0.1]},
    "drift": {"ftrl.weight_drift": [0.1, 0.3, 1.7, 0.2]},
    "inertia_inf": {"inertia": [4.0, float("inf"), 2.0, 1.0, 0.5]},
}


def _monitor(ns, rules, **kw):
    return ns.HealthMonitor(rules=rules(ns), **kw)


RULES = {
    "default": lambda ns: ns.default_rules(),
    "divergence_tight": lambda ns: [ns.DivergenceRule(rel=0.1, grace=1)],
    "plateau_short": lambda ns: [ns.PlateauRule(window=3, rel_tol=1e-2)],
    "threshold": lambda ns: [ns.ThresholdRule("loss", 2.5)],
}


@pytest.mark.parametrize("rules", sorted(RULES))
@pytest.mark.parametrize("case", sorted(SERIES))
def test_rules_and_report_equal_the_jax_package(case, rules):
    """Bulk ingest of a series, then the points of a second run through
    ``record``: the same new alerts at each evaluation, the same
    ``report()`` (apart from its timestamp), the same registry."""
    out = []
    for ns in (jh, th):
        mon = _monitor(ns, RULES[rules], source="t")
        mon.ingest(SERIES[case])
        first = [a.to_dict() for a in mon.evaluate()]
        for name, vals in SERIES[case].items():
            for i, v in enumerate(vals):
                mon.record(name + ".rec", i + 1, v)
        second = [a.to_dict() for a in mon.evaluate()]
        out.append((first, second, _strip(mon.report()), mon.healthy,
                    mon.worst_severity()))
    assert _dumps(out[0]) == _dumps(out[1])
    _same_series(jmet.get_registry().snapshot(),
                 tmet.get_registry().snapshot())


def test_monitor_contract_equals_the_jax_package():
    """raise_on, severity validation, bounded retention, deduping of a
    continuing incident, and the sparkline."""
    for ns in (jh, th):
        with pytest.raises(ValueError, match="raise_on"):
            ns.HealthMonitor(raise_on=("fatal",))
        with pytest.raises(ValueError, match="max_points"):
            ns.HealthMonitor(max_points=4)
    got = []
    for ns in (jh, th):
        mon = ns.HealthMonitor(source="x", raise_on=("critical",),
                               max_points=8)
        for i in range(30):
            mon.record("loss", i + 1, 1.0 / (i + 1))
        mon.evaluate()
        mon.record("nonfinite.grad", 31, 2.0)
        with pytest.raises(ns.HealthAlertError) as ei:
            mon.evaluate()
        for i in range(32, 40):
            mon.record("nonfinite.grad", i, 2.0)
        assert mon.evaluate() == []         # a continuing incident
        got.append((_alerts(mon), [a.to_dict() for a in ei.value.alerts],
                    str(ei.value), mon.series("loss")[0].tolist(),
                    ns.sparkline([1.0, float("nan"), 3.0, 2.0] * 30, 20)))
    assert _dumps(got[0]) == _dumps(got[1])
    assert len(got[1][3]) <= 10        # retention trims in chunks


def test_reports_cross_load_and_render(tmp_path, capsys):
    """A report with non-finite values saved by the port loads in the JAX
    package (and the reverse), and ``tools/health.py`` renders the
    port's, exiting 1 on an unhealthy report as on the JAX package's."""
    docs = {}
    for name, ns in (("jax", jh), ("torch", th)):
        mon = ns.HealthMonitor(source="cross")
        mon.ingest({"loss": [3.0, 2.0, float("nan")],
                    "nonfinite.grad": [0.0, 0.0, 5.0]})
        mon.evaluate()
        docs[name] = mon.save_report(str(tmp_path / f"{name}.json"))
    back = {"t_by_j": jh.HealthMonitor.load_report(docs["torch"]),
            "j_by_t": th.HealthMonitor.load_report(docs["jax"])}
    for doc in back.values():
        assert np.isnan(doc["series"]["loss"]["values"][2])
        doc.pop("created_unix")
    assert _dumps(back["t_by_j"]) == _dumps(back["j_by_t"])
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "health_tool", os.path.join(root, "tools", "health.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    codes = [tool.main([docs[k]]) for k in ("jax", "torch")]
    out = capsys.readouterr().out
    assert codes == [1, 1]
    assert out.count("nonfinite") >= 2


# -- the engine: L-BFGS, KMeans and set_health ---------------------------------

def _lr_data(seed=0, nan_row=None):
    rng = np.random.RandomState(seed)
    X = rng.randn(N, D)
    X[:, 0] = 1.0
    margin = X @ (rng.randn(D) * 0.7)
    y = np.where(rng.rand(N) < 1.0 / (1.0 + np.exp(-margin)), 1.0, -1.0)
    if nan_row is not None:
        X[nan_row, 3] = np.nan
    return {"X": X, "y": y, "w": np.ones(N)}


def _lbfgs(pkg, env, data, steps=8, **kw):
    opt, obj = (jopt, jo) if pkg == "jax" else (topt, to)
    o = obj.UnaryLossObjFunc(obj.LogLossFunc(), D, l2=1e-3)
    return opt.optimize(o, data, opt.OptimParams(max_iter=steps,
                                                 epsilon=0.0, **kw), env)


def _series(mon):
    return {n: mon.series(n) for n in mon.series_names()}


def _alert_set(mon):
    return sorted((a.rule, a.severity, a.series, a.step) for a in mon.alerts)


def test_lbfgs_monitor_matches_the_jax_package(jenv, tenv):
    """``OptimParams(health=...)``: the same probe series (one float32
    rounding apart: the states agree within rtol 1e-10), the same
    alerts, and a model bitwise the run without a monitor."""
    data = _lr_data()
    mons = {"jax": jh.HealthMonitor(source="qn"),
            "torch": th.HealthMonitor(source="qn")}
    for pkg, env in (("jax", jenv), ("torch", tenv)):
        _lbfgs(pkg, env, data, health=mons[pkg])
    js, ts = _series(mons["jax"]), _series(mons["torch"])
    assert sorted(ts) == sorted(js) == [
        "grad_norm", "loss", "nonfinite.grad", "update_ratio"]
    for k in js:
        assert list(ts[k][0]) == list(js[k][0]) == list(range(1, 9))
        np.testing.assert_allclose(ts[k][1], js[k][1], rtol=U32, atol=0)
    assert _alert_set(mons["torch"]) == _alert_set(mons["jax"])
    bare = _lbfgs("torch", tenv, data)
    mon = th.HealthMonitor()
    withm = _lbfgs("torch", tenv, data, health=mon)
    for a, b in zip(bare, withm):
        assert np.array_equal(np.asarray(a), np.asarray(b))


def test_kmeans_monitor_matches_the_jax_package(jenv, tenv):
    """``kmeans_train(health=...)``: the Lloyd loop's inertia, movement
    and empty_clusters series one float32 rounding apart (centroids
    within rtol 1e-12), the same alerts, equal centroids."""
    rng = np.random.RandomState(3)
    X = np.concatenate([rng.randn(60, 3) + c for c in ((0, 0, 0),
                                                       (6, 6, 0),
                                                       (0, 6, 6))])
    mons = {"jax": jh.HealthMonitor(source="kmeans"),
            "torch": th.HealthMonitor(source="kmeans")}
    got = {}
    for pkg, mod, env in (("jax", jk, jenv), ("torch", tk, tenv)):
        got[pkg] = mod.kmeans_train(X, 3, init="RANDOM", max_iter=12,
                                    tol=0.0, env=env, health=mons[pkg])
    np.testing.assert_allclose(got["torch"][0], got["jax"][0], rtol=1e-12)
    js, ts = _series(mons["jax"]), _series(mons["torch"])
    assert sorted(ts) == sorted(js) == ["empty_clusters", "inertia",
                                        "movement"]
    for k in js:
        assert list(ts[k][0]) == list(js[k][0])
        np.testing.assert_allclose(ts[k][1], js[k][1], rtol=U32,
                                   atol=U32 * 1e-6)
    assert _alert_set(mons["torch"]) == _alert_set(mons["jax"])


def test_comqueue_set_health_matches_the_jax_package(jenv, tenv):
    """``IterativeComQueue.set_health`` on a queue of its own: a stage's
    probes (one of them non-finite from superstep 4) reach the monitor
    after a checkpointed run's boundaries and after the run, with the
    same series and alerts in both packages."""
    from alink_tpu.engine import IterativeComQueue as JQ
    from alink_tpu_torch.engine import IterativeComQueue as TQ
    import jax.numpy as jnp

    def jstage(ctx):
        s = ctx.step_no
        ctx.probe("loss", 10.0 / s)
        ctx.probe("ratio", jnp.where(s >= 4, jnp.inf, 0.5 * s))

    def tstage(ctx):
        s = ctx.step_no
        ctx.probe("loss", 10.0 / s)
        ctx.probe("ratio", float("inf") if s >= 4 else 0.5 * s)

    mons = {}
    for pkg, Q, stage, env in (("jax", JQ, jstage, jenv),
                               ("torch", TQ, tstage, tenv)):
        mons[pkg] = (jh if pkg == "jax" else th).HealthMonitor(source="q")
        q = Q(env=env, max_iter=6).add(stage)
        q.init_with_partitioned_data("x", np.zeros((4, 1)))
        q.set_health(mons[pkg]).exec()
    assert _series(mons["torch"]).keys() == _series(mons["jax"]).keys()
    for k, (steps, vals) in _series(mons["jax"]).items():
        tsteps, tvals = mons["torch"].series(k)
        assert list(tsteps) == list(steps)
        np.testing.assert_array_equal(tvals, vals)
    assert _alerts(mons["torch"]) == _alerts(mons["jax"])
    assert ("nonfinite", "critical", "ratio", 4) in _alert_set(mons["torch"])


def test_nan_run_raises_at_the_same_boundary_and_resumes(jenv, tenv,
                                                         tmp_path):
    """A NaN in the data poisons the loss from superstep 1. A checkpointed
    run with a ``raise_on=("critical",)`` monitor raises
    ``HealthAlertError`` at its first boundary (superstep 2) in both
    packages, naming the same alert, with that boundary's snapshot on
    disk; the port's snapshot then resumes, to the uninterrupted run's
    state bit for bit."""
    data = _lr_data(nan_row=17)
    tags = {}
    alerts = {}
    for pkg, ns, env in (("jax", jh, jenv), ("torch", th, tenv)):
        d = str(tmp_path / pkg)
        mon = ns.HealthMonitor(raise_on=("critical",), source="qn")
        with pytest.raises(ns.HealthAlertError) as ei:
            _lbfgs(pkg, env, data, steps=8, health=mon, checkpoint_dir=d,
                   checkpoint_every=2)
        alerts[pkg] = [a.to_dict() for a in ei.value.alerts]
        tags[pkg] = [os.path.basename(p) for p in list_checkpoints(d)]
    assert _dumps(alerts["torch"]) == _dumps(alerts["jax"])
    assert alerts["torch"][0]["step"] == 1
    assert tags["torch"] == tags["jax"] == ["ckpt-000000000002"]
    d = str(tmp_path / "torch")
    resumed = _lbfgs("torch", tenv, data, steps=8, checkpoint_dir=d,
                     resume_from=d)
    whole = _lbfgs("torch", tenv, data, steps=8)
    for a, b in zip(resumed, whole):
        assert np.array_equal(np.asarray(a), np.asarray(b), equal_nan=True)


def test_health_off_drops_probes_and_signature(tenv, tmp_path,
                                               monkeypatch):
    """``ALINK_TPU_HEALTH=0``: no probe in the result, no
    ``health_probes`` in the snapshot signature, the same model bit for
    bit; a probed snapshot is not resumed by a probe-less run, nor the
    reverse."""
    data = _lr_data()
    spy = {}
    orig = topt.IterativeComQueue.exec

    def keep(self):
        spy["r"] = orig(self)
        return spy["r"]
    monkeypatch.setattr(topt.IterativeComQueue, "exec", keep)
    on_dir, off_dir = str(tmp_path / "on"), str(tmp_path / "off")
    on = _lbfgs("torch", tenv, data, checkpoint_dir=on_dir)
    assert spy["r"].probe_names()
    sig_on = read_manifest(list_checkpoints(on_dir)[-1])["meta"]["signature"]
    monkeypatch.setenv("ALINK_TPU_HEALTH", "0")
    with pytest.warns(RuntimeWarning, match="ALINK_TPU_HEALTH"):
        off = _lbfgs("torch", tenv, data, checkpoint_dir=off_dir,
                     health=th.HealthMonitor())
    assert spy["r"].probe_names() == []
    sig_off = read_manifest(
        list_checkpoints(off_dir)[-1])["meta"]["signature"]
    assert sig_on.pop("health_probes") is True
    assert "health_probes" not in sig_off and sig_on == sig_off
    for a, b in zip(on, off):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    with pytest.raises(CheckpointError):
        _lbfgs("torch", tenv, data, checkpoint_dir=on_dir,
               resume_from=on_dir)
    monkeypatch.delenv("ALINK_TPU_HEALTH")
    with pytest.raises(CheckpointError):
        _lbfgs("torch", tenv, data, checkpoint_dir=off_dir,
               resume_from=off_dir)


def test_kmeans_centroids_bitwise_with_health_off(tenv, monkeypatch):
    """KMeans drops its inertia row with the switch off (as the JAX
    package does) and keeps its centroids and weights bit for bit."""
    rng = np.random.RandomState(5)
    X = rng.randn(150, 4)
    on = tk.kmeans_train(X, 4, init="RANDOM", env=tenv,
                         health=th.HealthMonitor())
    monkeypatch.setenv("ALINK_TPU_HEALTH", "0")
    off = tk.kmeans_train(X, 4, init="RANDOM", env=tenv)
    for a, b in zip(on, off):
        assert np.array_equal(np.asarray(a), np.asarray(b))


# -- FTRL ---------------------------------------------------------------------

FN, FD, FB = 320, 10, 40


@pytest.fixture(scope="module")
def ftrl_case():
    """Dense rows, an LR warm start the JAX package trains on one device
    and its table carried to the port."""
    from alink_tpu.common.mlenv import MLEnvironmentFactory
    from alink_tpu.common.mtable import MTable
    from alink_tpu.operator.batch.classification.linear import (
        LogisticRegressionTrainBatchOp)
    from alink_tpu.operator.batch.source.sources import MemSourceBatchOp
    from alink_tpu_torch.common.mtable import MTable as TMTable
    from alink_tpu_torch.model.interop import model_table_from_reference
    from alink_tpu_torch.operator.batch.source.sources import \
        MemSourceBatchOp as TMem
    sid = MLEnvironmentFactory.register(
        JEnv(parallelism=1, devices=jax.devices()[:1]))
    rng = np.random.RandomState(9)
    X = rng.randn(FN, FD)
    y = (X @ rng.randn(FD) + 0.3 * rng.randn(FN) > 0).astype(np.int64)
    cols = {f"f{j}": X[:, j] for j in range(FD)}
    cols["label"] = y
    spec = ", ".join([f"f{j} DOUBLE" for j in range(FD)] + ["label LONG"])
    jt = MTable(dict(cols), spec)
    warm = LogisticRegressionTrainBatchOp(
        feature_cols=[f"f{j}" for j in range(FD)], label_col="label",
        max_iter=3, ml_environment_id=sid).link_from(
        MemSourceBatchOp(jt.first_n(80), ml_environment_id=sid))
    wt = warm.get_output_table()
    twarm = TMem(model_table_from_reference(wt.to_rows(), wt.schema.types[2]))
    yield dict(sid=sid, jt=jt, tt=TMTable(dict(cols), spec), warm=warm,
               twarm=twarm)
    MLEnvironmentFactory.remove(sid)


def _ftrl(case, pkg, **kw):
    kw = dict(dict(feature_cols=[f"f{j}" for j in range(FD)],
                   label_col="label", alpha=0.2, update_mode="batch",
                   time_interval=2.0), **kw)
    if pkg == "jax":
        from alink_tpu.operator.stream.onlinelearning.ftrl import \
            FtrlTrainStreamOp
        from alink_tpu.operator.stream.source.sources import \
            MemSourceStreamOp
        sid = case["sid"]
        op = FtrlTrainStreamOp(case["warm"], ml_environment_id=sid, **kw)
        return op.link_from(MemSourceStreamOp(case["jt"], batch_size=FB,
                                              ml_environment_id=sid))
    from alink_tpu_torch.operator.stream.onlinelearning.ftrl import \
        FtrlTrainStreamOp
    from alink_tpu_torch.operator.stream.source.sources import \
        MemSourceStreamOp
    op = FtrlTrainStreamOp(case["twarm"], device="cpu",
                           ship_dtype=torch.float64, **kw)
    return op.link_from(MemSourceStreamOp(case["tt"], batch_size=FB))


def _coefs(op):
    out = []
    for _, mt in op.timed_batches():
        rows = [r for r in mt.to_rows() if r[0] and r[0] > 0]
        out.append(json.dumps([list(r) for r in rows], default=str))
    return out


def test_ftrl_batch_monitor_matches_the_jax_package(ftrl_case, tmp_path):
    """``FtrlTrainStreamOp(health=...)`` in batch mode on dense rows with
    a checkpoint every 3 micro-batches: the progressive-validation
    series (log loss within 1e-12 on the first micro-batch and 1e-10 over
    the stream, accuracy and non-finite counts exactly), the weight drift
    of every snapshot after the first within 1e-10, the same alerts; the
    snapshots with a monitor are the ones without, bit for bit."""
    mons = {"jax": jh.HealthMonitor(source="ftrl"),
            "torch": th.HealthMonitor(source="ftrl")}
    for pkg in ("jax", "torch"):
        op = _ftrl(ftrl_case, pkg, health=mons[pkg],
                   checkpoint_dir=str(tmp_path / pkg),
                   checkpoint_every_batches=3)
        for _ in op.timed_batches():
            pass
    js, ts = _series(mons["jax"]), _series(mons["torch"])
    assert sorted(ts) == sorted(js) == [
        "ftrl.pv_accuracy", "ftrl.pv_logloss", "ftrl.weight_drift",
        "nonfinite.margin"]
    for k in js:
        assert list(ts[k][0]) == list(js[k][0])
    ll_t, ll_j = ts["ftrl.pv_logloss"][1], js["ftrl.pv_logloss"][1]
    assert len(ll_j) == FN // FB
    np.testing.assert_allclose(ll_t[0], ll_j[0], rtol=1e-12)
    np.testing.assert_allclose(ll_t, ll_j, rtol=1e-10)
    for k in ("ftrl.pv_accuracy", "nonfinite.margin"):
        np.testing.assert_array_equal(ts[k][1], js[k][1])
    np.testing.assert_allclose(ts["ftrl.weight_drift"][1],
                               js["ftrl.weight_drift"][1], rtol=1e-10)
    assert _alert_set(mons["torch"]) == _alert_set(mons["jax"])
    bare = _coefs(_ftrl(ftrl_case, "torch"))
    assert _coefs(_ftrl(ftrl_case, "torch",
                        health=th.HealthMonitor())) == bare


def test_ftrl_nan_raises_after_the_checkpoint(ftrl_case, tmp_path):
    """A NaN feature in micro-batch 2: with ``raise_on=("critical",)``
    both packages raise ``HealthAlertError`` at the first boundary that
    reads the queued scalars (the checkpoint after micro-batch 2), for
    the same alert, with that checkpoint published."""
    from alink_tpu.common.mtable import MTable
    from alink_tpu_torch.common.mtable import MTable as TMTable
    cols = {k: np.array(ftrl_case["jt"].col(k))
            for k in ftrl_case["jt"].schema.names}
    cols["f2"] = cols["f2"].copy()
    cols["f2"][FB + 5] = np.nan
    spec = ftrl_case["jt"].schema.to_spec()
    case = dict(ftrl_case, jt=MTable(dict(cols), spec),
                tt=TMTable(dict(cols), spec))
    got = {}
    for pkg, ns in (("jax", jh), ("torch", th)):
        d = str(tmp_path / pkg)
        mon = ns.HealthMonitor(raise_on=("critical",), source="ftrl")
        op = _ftrl(case, pkg, health=mon, checkpoint_dir=d,
                   checkpoint_every_batches=2, time_interval=100.0)
        with pytest.raises(ns.HealthAlertError) as ei:
            for _ in op.timed_batches():
                pass
        got[pkg] = ([a.to_dict() for a in ei.value.alerts],
                    [os.path.basename(p) for p in list_checkpoints(d)])
    assert _dumps(got["torch"]) == _dumps(got["jax"])
    assert got["torch"][1] == ["ckpt-000000000002"]
    assert {a["series"] for a in got["torch"][0]} >= {"nonfinite.margin"}


def test_probed_snapshots_read_both_ways(jenv, tenv, tmp_path):
    """Engine snapshots with probes in the carry: each package's validate
    and load in the other's checkpoint store, both signatures carry
    ``health_probes``, and the probe series of the same superstep agree
    (one float32 rounding apart) read through either package."""
    import alink_tpu.common.checkpoint as jck
    import alink_tpu_torch.common.checkpoint as tck
    data = _lr_data()
    for pkg, env in (("jax", jenv), ("torch", tenv)):
        _lbfgs(pkg, env, data, steps=6, checkpoint_dir=str(tmp_path / pkg),
               checkpoint_every=3)
    probes = {}
    for pkg in ("jax", "torch"):
        for reader in (jck, tck):
            path = reader.latest_checkpoint(str(tmp_path / pkg))
            assert reader.validate_checkpoint(path)["tag"] == 6
            payload, meta = reader.load_checkpoint(path)
            assert meta["signature"]["health_probes"] is True
            got = {k[len("__probe_"):]: np.asarray(v).reshape(-1)[:6]
                   for k, v in payload.items() if k.startswith("__probe_")}
            assert sorted(got) == ["grad_norm", "loss", "nonfinite.grad",
                                   "update_ratio"]
            probes.setdefault(pkg, got)
            for k, v in got.items():
                np.testing.assert_array_equal(v, probes[pkg][k])
    for k, v in probes["jax"].items():
        assert probes["torch"][k].dtype == v.dtype == np.float32
        np.testing.assert_allclose(probes["torch"][k], v, rtol=U32, atol=0)
