"""The supervised online-learning DAG of the port on the CPU, against the
JAX package.

The fixture is the JAX package's own (``tests/test_online.py``: 768
dense rows of 16 features, 128-row micro-batches, ``time_interval=2.0``,
a checkpoint every 2 micro-batches). The warm start is trained by the
JAX package on one device and carried to the port, so both DAGs start
from the same weights; the port runs on the CPU in float64
(``device="cpu", dtype=torch.float64``), the JAX package on a 1-device
environment under x64. Held:

* a deterministic run gives the JAX package's windows (count, rows,
  batch ranges, event times), swaps and scored rows, each window's AUC
  within 1e-9 and log loss within rtol 1e-9, every served score within
  FTRL's stream tolerance (rtol 1e-10) and every label equal;
* two port runs write byte-identical journals; the full DAG killed and
  restarted from its artifacts, the in-process restart from a
  checkpoint, and an ingest crash resumed at its offset all write the
  golden run's journals byte for byte;
* a corrupt snapshot is skipped while the last good model serves; the
  SLO verdicts are typed and recorded live; the journals' torn tails
  are truncated and a corruption in the middle of a file refused; a
  crash of the scoring leg stops the trainer;
* the model-table files and the flags read like the JAX package's,
  both ways;
* with the fault variable unset, the E2E flags do not change a served
  response byte.

Every wait has its own timeout (the pacer's, the futures').
"""

import json
import os
import threading
import time
import warnings

import jax
import numpy as np
import pytest
import torch

from alink_tpu_torch.common.faults import (FAULT_ENV, reset_faults,
                                           scoped_fault_env)
from alink_tpu_torch.common.mtable import MTable as TMTable
from alink_tpu_torch.common.vector import DenseVector as TDense
from alink_tpu_torch.model.interop import model_table_from_reference
from alink_tpu_torch.online import (DagReport, OnlineDag, RESTART_POLICIES,
                                    SloContract, load_model_table,
                                    save_model_table)
from alink_tpu_torch.online import dag as tdag
from alink_tpu_torch.online import slo as tslo
from alink_tpu_torch.operator.batch.source.sources import \
    MemSourceBatchOp as TMemB
from alink_tpu_torch.operator.stream.source.sources import \
    MemSourceStreamOp as TMemS

N_ROWS, DIM, BATCH = 768, 16, 128          # 6 micro-batches
INTERVAL = 2.0                             # emissions at t=2,4 + final


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for k in (FAULT_ENV, "ALINK_TPU_E2E_DAG", "ALINK_TPU_E2E_SLO_P99_MS",
              "ALINK_TPU_E2E_SLO_AUC", "ALINK_TPU_E2E_PACING",
              "ALINK_TPU_E2E_DEADLINE_MS", "ALINK_TPU_E2E_MAX_RESTARTS",
              "ALINK_TPU_ADMIN_PORT"):
        monkeypatch.delenv(k, raising=False)
    reset_faults()
    yield
    reset_faults()


@pytest.fixture(scope="module")
def base():
    """The reference test's rows in both packages, the JAX package's warm
    start (3 L-BFGS iterations on the first 256 rows, one device) and its
    table carried to the port. The JAX package's default environment is
    the 1-device one while the module runs."""
    from alink_tpu.common.mlenv import MLEnvironment, MLEnvironmentFactory
    from alink_tpu.common.mtable import MTable
    from alink_tpu.common.vector import DenseVector
    from alink_tpu.operator.batch.classification.linear import (
        LogisticRegressionTrainBatchOp)
    from alink_tpu.operator.batch.source.sources import MemSourceBatchOp
    prev = MLEnvironmentFactory.get_default()
    MLEnvironmentFactory.set_default(
        MLEnvironment(parallelism=1, devices=jax.devices()[:1]))
    rng = np.random.RandomState(11)
    X = rng.randn(N_ROWS, DIM)
    y = (X @ rng.randn(DIM) + 0.25 * rng.randn(N_ROWS) > 0).astype(np.int64)
    jv = np.empty(N_ROWS, object)
    jv[:] = [DenseVector(X[i]) for i in range(N_ROWS)]
    jtbl = MTable({"vec": jv, "label": y}, "vec VECTOR, label LONG")
    jwarm = LogisticRegressionTrainBatchOp(
        vector_col="vec", label_col="label", max_iter=3).link_from(
        MemSourceBatchOp(jtbl.first_n(256)))
    wt = jwarm.get_output_table()
    twarm = TMemB(model_table_from_reference(wt.to_rows(),
                                             wt.schema.types[2]))
    tv = np.empty(N_ROWS, object)
    tv[:] = [TDense(X[i]) for i in range(N_ROWS)]
    ttbl = TMTable({"vec": tv, "label": y}, "vec VECTOR, label LONG")
    yield dict(jtbl=jtbl, jwarm=jwarm, ttbl=ttbl, twarm=twarm)
    MLEnvironmentFactory.set_default(prev)


def mkdag(base, art, **kw):
    kw.setdefault("time_interval", INTERVAL)
    kw.setdefault("checkpoint_every", 2)
    tbl = base["ttbl"]
    return OnlineDag(
        source_fn=lambda: TMemS(tbl, batch_size=BATCH),
        warm_model=base["twarm"], artifacts_dir=art, label_col="label",
        vector_col="vec", name="t_online", device="cpu",
        dtype=torch.float64, **kw)


def _read(path):
    with open(path) as f:
        return f.read()


def _eval_files(art):
    return (_read(os.path.join(art, "eval", "windows.jsonl")),
            _read(os.path.join(art, "eval", "scores.jsonl")))


def _run(dag):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return dag.run()


@pytest.fixture(scope="module")
def golden(base, tmp_path_factory):
    """One uninterrupted port run: every fault scenario's journals are
    held against it."""
    art = str(tmp_path_factory.mktemp("dag_golden"))
    rep = _run(mkdag(base, art))
    assert rep.failed is None
    return art, rep


@pytest.fixture(scope="module")
def jax_golden(base, tmp_path_factory):
    """The JAX package's ``OnlineDag`` on the same rows and warm start."""
    from alink_tpu.online import OnlineDag as JDag
    from alink_tpu.operator.stream.source.sources import MemSourceStreamOp
    art = str(tmp_path_factory.mktemp("dag_jax"))
    tbl = base["jtbl"]
    rep = _run(JDag(
        source_fn=lambda: MemSourceStreamOp(tbl, batch_size=BATCH),
        warm_model=base["jwarm"], artifacts_dir=art, label_col="label",
        vector_col="vec", name="t_online", time_interval=INTERVAL,
        checkpoint_every=2))
    assert rep.failed is None
    return art, rep


def _scores(art):
    return [json.loads(ln) for ln in
            _read(os.path.join(art, "eval", "scores.jsonl")).splitlines()]


# -- the clean run against the JAX package -------------------------------------

def test_deterministic_run_matches_the_jax_package(golden, jax_golden):
    """Windows, rows, swaps and AUCs of the JAX package's DAG; scores
    within FTRL's stream tolerance, labels equal."""
    art, rep = golden
    jart, jrep = jax_golden
    assert rep.failed is None and not rep.restarts
    assert rep.scored_rows == jrep.scored_rows == N_ROWS
    assert rep.batches_scored == jrep.batches_scored == N_ROWS // BATCH
    assert rep.swaps == jrep.swaps >= 3
    assert len(rep.windows) == len(jrep.windows) >= 3
    for w, jw in zip(rep.windows, jrep.windows):
        for k in ("w", "end_t", "first_seq", "last_seq", "n"):
            assert w[k] == jw[k], k
        assert abs(w["auc"] - jw["auc"]) <= 1e-9
        np.testing.assert_allclose(w["logloss"], jw["logloss"], rtol=1e-9)
    assert abs(rep.final_window_auc - jrep.final_window_auc) <= 1e-9
    assert rep.final_window_auc > 0.9 and rep.auc_note is None
    assert rep.silent_drops == jrep.silent_drops == 0
    assert rep.typed_rejections == 0
    ts, js = _scores(art), _scores(jart)
    assert [(s["seq"], s["t"]) for s in ts] == [(s["seq"], s["t"])
                                                for s in js]
    for s, j in zip(ts, js):
        assert s["y"] == j["y"]
        np.testing.assert_allclose(s["p"], j["p"], rtol=1e-10, atol=0)
    windows, scores = _eval_files(art)
    assert len(windows.strip().splitlines()) == len(rep.windows)
    assert len(scores.strip().splitlines()) == rep.batches_scored
    got = load_model_table(os.path.join(art, "serving", "last_good.json"))
    assert got is not None and got[1].num_rows > 0


def test_deterministic_pacing_is_repeatable(base, golden, tmp_path):
    """Two clean runs write byte-identical journals."""
    g_art, _ = golden
    art = str(tmp_path / "repeat")
    rep = _run(mkdag(base, art))
    assert rep.failed is None
    assert _eval_files(art) == _eval_files(g_art)


# -- kills and restarts ---------------------------------------------------------

def test_full_dag_kill_and_resume_bitwise(base, golden, tmp_path):
    """Kill mid-drain, restart the DAG from the artifacts on disk: the
    journals continue bitwise where they left off and the last model is
    the golden run's."""
    g_art, _ = golden
    art = str(tmp_path / "killed")
    with scoped_fault_env("ftrl.batch:4-4"):
        r1 = _run(mkdag(base, art, max_restarts=0))
    assert r1.failed is not None
    assert r1.restarts[0]["site"] == "ftrl.batch"
    assert r1.restarts[0]["policy"] == RESTART_POLICIES["train"]
    r2 = _run(mkdag(base, art))
    assert r2.failed is None
    assert _eval_files(art) == _eval_files(g_art)
    m_g = json.load(open(os.path.join(g_art, "serving", "last_good.json")))
    m_k = json.load(open(os.path.join(art, "serving", "last_good.json")))
    assert m_k["rows"] == m_g["rows"]


def test_supervised_in_process_restart_from_checkpoint(base, golden,
                                                       tmp_path):
    """The train stage's supervisor catches a kill, restarts from the
    last checkpoint with a measured recovery, and the journals are the
    golden run's."""
    g_art, _ = golden
    art = str(tmp_path / "supervised")
    seen = []

    def on_event(stage, exc):
        seen.append((stage, type(exc).__name__))
        os.environ.pop(FAULT_ENV, None)   # the replay must not re-kill

    with scoped_fault_env("ftrl.batch:4-4"):
        rep = _run(mkdag(base, art, on_stage_event=on_event))
    assert rep.failed is None
    assert seen == [("train", "FaultInjected")]
    assert rep.restart_count("train") == 1
    rec = rep.restarts[0]
    assert rec["policy"] == "restart-from-last-checkpoint"
    assert rec["recovery_s"] is not None and rec["recovery_s"] > 0
    assert _eval_files(art) == _eval_files(g_art)


def test_ingest_resume_at_offset(base, golden, tmp_path):
    """An ingest crash redelivers from its offset (the auto-indexed
    ``ingest.batch`` site clears on redelivery), typed resume-at-offset."""
    g_art, _ = golden
    art = str(tmp_path / "ingest")
    with scoped_fault_env("ingest.batch:3-3"):
        rep = _run(mkdag(base, art))
    assert rep.failed is None
    assert rep.restart_count("ingest") == 1
    rec = [r for r in rep.restarts if r["stage"] == "ingest"][0]
    assert rec["policy"] == "resume-at-offset"
    assert rec["offset"] == 2
    assert rec["recovery_s"] is not None
    assert _eval_files(art) == _eval_files(g_art)


def test_corrupt_snapshot_skipped_last_good_serves(base, golden, tmp_path):
    """A poisoned snapshot is skipped once, the last good model serves,
    no window is dropped."""
    _, g_rep = golden
    art = str(tmp_path / "corrupt")
    with scoped_fault_env("feeder.snapshot:1-1:corrupt"):
        rep = _run(mkdag(base, art))
    assert rep.failed is None
    assert rep.feeder_skipped == 1
    assert rep.swaps == g_rep.swaps - 1
    assert len(rep.windows) == len(g_rep.windows)
    assert rep.silent_drops == 0
    assert rep.final_window_auc > 0.8


# -- SLO ----------------------------------------------------------------------

def _verdicts(mod):
    slo = mod.SloContract(serve_p99_s=0.010, swap_staleness_s=0.5,
                          final_window_auc=0.75, name="slo_t")
    v = slo.observe_p99(0.200, window=2)
    none = slo.observe_p99(0.001, window=3)
    v2 = slo.observe_swap(0.9, version=4)
    final = slo.final(p99_s=0.2, max_staleness_s=0.9, final_auc=0.93)
    return ([x.to_dict() for x in slo.breaches], none,
            [x.to_dict() for x in final], v.to_dict(), v2.to_dict(),
            mod.SloContract().final(1.0, 1.0, 0.5),
            slo.clause_states().keys())


def test_contract_typed_verdicts_equal_the_jax_package():
    from alink_tpu.online import slo as jslo
    got, want = _verdicts(tslo), _verdicts(jslo)
    assert got[:6] == want[:6] and list(got[6]) == list(want[6])
    by = {x["slo"]: x for x in got[2]}
    assert not by["serve_p99"]["ok"] and not by["swap_staleness"]["ok"]
    assert by["final_window_auc"]["ok"]
    assert got[5] == []


def test_burn_rate_equals_the_jax_package():
    """The burn-rate monitor on a scripted clock: the same rates, alert
    transitions, readiness and state in both packages."""
    from alink_tpu.online import slo as jslo
    out = []
    for mod in (jslo, tslo):
        now = [0.0]
        burn = mod.SloBurnRate(fast_s=10.0, slow_s=60.0, name="b",
                               clock=lambda: now[0])
        rates = []
        for t, obs in ((0, 0.5), (2, 3.0), (4, 3.0), (30, 0.2), (75, 0.1)):
            now[0] = float(t)
            rates.append(burn.record("serve_p99", obs, 1.0))
        rates.append(burn.record("window_auc", 0.5, 0.75, floor=True))
        state = burn.state()
        for a in state["alerts"]:
            a.pop("unix")
        out.append((rates, burn.readiness(), state))
    assert out[0] == out[1]


def test_live_breach_recorded_on_run(base, tmp_path):
    """A deliberately tight p99 bound breaches live (typed, in
    ``report.breaches``); the generous clauses stay ok."""
    slo = SloContract(serve_p99_s=1e-6, swap_staleness_s=30.0,
                      final_window_auc=0.6)
    rep = _run(mkdag(base, str(tmp_path / "slo_run"), slo=slo))
    assert rep.failed is None
    assert any(b.slo == "serve_p99" for b in rep.breaches)
    by = {v.slo: v for v in rep.slo}
    assert not by["serve_p99"].ok
    assert by["swap_staleness"].ok and by["final_window_auc"].ok


def test_auc_note_is_self_explaining(base, tmp_path):
    dag = mkdag(base, str(tmp_path / "note"))
    dag._pos_label = "1"
    rep = DagReport()
    rep.windows = [{"auc": 0.52, "logloss": 0.7},
                   {"auc": 0.61, "logloss": 0.68}]
    rep.final_window_auc = 0.61
    note = dag._auc_note(rep)
    assert "0.61" in note and "0.52" in note and "rising" in note
    rep.windows = [{"auc": 0.50, "logloss": 0.7},
                   {"auc": 0.505, "logloss": 0.7}]
    rep.final_window_auc = 0.505
    assert "chance" in dag._auc_note(rep)
    rep.windows = [{"auc": 0.9, "logloss": 0.3}]
    rep.final_window_auc = 0.9
    assert dag._auc_note(rep) is None


FLAG_CASES = [
    ("ALINK_TPU_E2E_SLO_P99_MS", ["250", "0", "-3", ""]),
    ("ALINK_TPU_E2E_SLO_STALENESS_MS", ["1500", "0"]),
    ("ALINK_TPU_E2E_SLO_AUC", ["0.8", "1.7", "0"]),
    ("ALINK_TPU_E2E_DEADLINE_MS", ["100", "0"]),
    ("ALINK_TPU_E2E_BURN_FAST_S", ["30", "0.2", "junk"]),
    ("ALINK_TPU_E2E_BURN_SLOW_S", ["900", "junk"]),
    ("ALINK_TPU_E2E_MAX_RESTARTS", ["5", "-3"]),
    ("ALINK_TPU_E2E_PACING", ["throughput", "free", "weird", ""]),
    ("ALINK_TPU_E2E_DAG", ["1", "off", "no"]),
    ("ALINK_TPU_HEALTH", ["0", "false", "yes"]),
]


@pytest.mark.parametrize("name,raws", FLAG_CASES)
def test_flags_parse_like_the_jax_package(monkeypatch, name, raws):
    """Every E2E flag and the health switch: declared, with the JAX
    package's default, and each raw value parsed to the JAX package's
    value through the accessors the DAG reads."""
    from alink_tpu.common.flags import FLAGS as JF
    from alink_tpu.common.flags import flag_value as jval
    from alink_tpu_torch.common.flags import FLAGS as TF
    from alink_tpu_torch.common.flags import flag_value as tval
    assert name in TF and TF.get(name).default == JF.get(name).default
    assert TF.get(name).description == JF.get(name).description
    assert tval(name) == jval(name)
    for raw in raws:
        monkeypatch.setenv(name, raw)
        assert tval(name) == jval(name), raw
    from alink_tpu.online import dag as jdag
    from alink_tpu.online import slo as jslo
    for tf, jf in ((tslo.slo_p99_s, jslo.slo_p99_s),
                   (tslo.e2e_dag_enabled, jslo.e2e_dag_enabled),
                   (tdag.e2e_pacing, jdag.e2e_pacing),
                   (tdag.e2e_max_restarts, jdag.e2e_max_restarts)):
        assert tf() == jf()


# -- artifacts ----------------------------------------------------------------

def test_model_table_files_read_both_ways(base, tmp_path):
    """``save_model_table`` / ``load_model_table``: a file written by
    either package loads in the other with the same version and rows,
    and the port's loaded table answers as its source table."""
    from alink_tpu.online import load_model_table as jload
    from alink_tpu.online import save_model_table as jsave
    jt = base["jwarm"].get_output_table()
    tt = base["twarm"].get_output_table()
    jsave(str(tmp_path / "j.json"), 7, jt)
    save_model_table(str(tmp_path / "t.json"), 7, tt)
    for path in ("j.json", "t.json"):
        for load, want in ((load_model_table, tt), (jload, jt)):
            ver, got = load(str(tmp_path / path))
            assert ver == 7 and got.num_rows == want.num_rows
            assert got.schema.names == want.schema.names
            for c in want.schema.names:
                assert [str(v) for v in got.col(c)] == \
                    [str(v) for v in want.col(c)]
    assert _read(str(tmp_path / "j.json")) == _read(str(tmp_path / "t.json"))


def test_corrupt_last_good_warns_not_crashes(tmp_path):
    path = str(tmp_path / "bad.json")
    with open(path, "w") as f:
        f.write("{not json")
    with pytest.warns(RuntimeWarning, match="unreadable"):
        assert load_model_table(path) is None


class TestJournalDurability:
    """A kill mid-append leaves a torn final line; restart truncates it
    and resumes. A corruption in the middle of a file refuses."""

    def _log(self, tmp_path, sub="a"):
        d = tmp_path / sub
        d.mkdir(exist_ok=True)
        return tdag._EvalWindowLog(str(d / "scores.jsonl"),
                                   str(d / "windows.jsonl"), window_s=2.0)

    def _batches(self):
        rng = np.random.RandomState(5)
        for seq in range(1, 4):
            y = (rng.rand(8) > 0.5).astype(np.float64)
            yield seq, seq * 1.0, y, rng.rand(8)

    def test_torn_scores_tail_truncated_and_resumed(self, tmp_path):
        log = self._log(tmp_path)
        for seq, t, y, p in self._batches():
            log.add_batch(seq, t, y, p)
        log.close()
        sp = str(tmp_path / "a" / "scores.jsonl")
        whole = _read(sp)
        with open(sp, "a") as f:
            f.write('{"seq": 4, "t": 4.0, "y": [1.0, 0')
        re_log = self._log(tmp_path)
        assert re_log.resume_seq == 3
        assert _read(sp) == whole
        re_log.close()

    def test_torn_windows_tail_not_counted_and_regenerated(self, tmp_path):
        log = self._log(tmp_path, "b")
        for seq, t, y, p in self._batches():
            log.add_batch(seq, t, y, p)
        log.close()
        wp = str(tmp_path / "b" / "windows.jsonl")
        gold = _read(wp)
        lines = gold.splitlines(keepends=True)
        with open(wp, "w") as f:
            f.writelines(lines[:-1])
            f.write(lines[-1][: len(lines[-1]) // 2])
        self._log(tmp_path, "b").close()
        assert _read(wp) == gold

    def test_mid_file_corruption_refuses_loudly(self, tmp_path):
        log = self._log(tmp_path, "c")
        for seq, t, y, p in self._batches():
            log.add_batch(seq, t, y, p)
        log.close()
        sp = str(tmp_path / "c" / "scores.jsonl")
        lines = _read(sp).splitlines(keepends=True)
        with open(sp, "w") as f:
            f.write(lines[0])
            f.write(lines[1][:10] + "\n")
            f.write(lines[2])
        with pytest.raises(ValueError, match="mid-file"):
            self._log(tmp_path, "c")

    def test_journals_equal_the_jax_package(self, tmp_path):
        """The same batches through the JAX package's journal write the
        same bytes."""
        from alink_tpu.online.dag import _EvalWindowLog as JLog
        for sub, cls in (("t", tdag._EvalWindowLog), ("j", JLog)):
            d = tmp_path / sub
            d.mkdir()
            log = cls(str(d / "scores.jsonl"), str(d / "windows.jsonl"),
                      window_s=2.0)
            for seq, t, y, p in self._batches():
                log.add_batch(seq, t, y, p)
            log.flush_final()
            log.close()
        for f in ("scores.jsonl", "windows.jsonl"):
            assert _read(str(tmp_path / "t" / f)) == \
                _read(str(tmp_path / "j" / f))


def test_scoring_leg_crash_stops_trainer(base, tmp_path):
    """A failure of the scoring leg (a watchdog abort out of the window
    close) aborts the pacer, so the train thread ends too."""

    class Watchdog:
        def record(self, *a):
            pass

        def evaluate(self):
            raise RuntimeError("watchdog abort")

    dag = mkdag(base, str(tmp_path / "wd"), health=Watchdog())
    with pytest.raises(RuntimeError, match="watchdog abort"):
        _run(dag)
    assert dag._pacer.aborted is not None

    def train_alive():
        return any(th.name == "alink-e2e-t_online-train" and th.is_alive()
                   for th in threading.enumerate())
    deadline = time.monotonic() + 15.0
    while train_alive() and time.monotonic() < deadline:
        time.sleep(0.05)
    assert not train_alive()


def test_throughput_hook_observes_abort():
    pacer = tdag._Pacer(deterministic=False)
    pacer.hook("pre", 1, 0.0)
    pacer.hook("post", 1, 0.0)
    pacer.abort("serve", RuntimeError("scoring leg died"))
    with pytest.raises(tdag.DagFailed):
        pacer.hook("pre", 2, 1.0)


def test_health_monitor_on_the_dag_and_admin_documents(base, tmp_path):
    """A ``HealthMonitor`` on the DAG sees the trainer's series and each
    window's AUC and log loss; the readiness source and the ``/statusz``
    document have the JAX package's keys."""
    from alink_tpu.online.dag import OnlineDag as JDag
    from alink_tpu_torch.common.health import HealthMonitor
    mon = HealthMonitor(rules=[])
    dag = mkdag(base, str(tmp_path / "mon"), health=mon)
    rep = _run(dag)
    assert rep.failed is None
    names = mon.series_names()
    for k in ("e2e.window_auc", "e2e.window_logloss", "ftrl.pv_logloss",
              "ftrl.weight_drift"):
        assert k in names
    assert len(mon.series("e2e.window_auc")[0]) == len(rep.windows)
    ready = dag._readiness()
    assert ready["ready"] and ready["swaps"] == rep.swaps
    doc = dag._statusz_doc()
    assert sorted(doc) == ["burn", "program_cache", "restarts",
                           "slo_clauses", "staleness", "swaps"]
    assert len(doc["swaps"]) == rep.swaps
    assert JDag._readiness.__doc__ and JDag._statusz_doc.__doc__


def test_pace_hook_default_is_inert(base):
    from alink_tpu_torch.operator.stream.onlinelearning.ftrl import \
        FtrlTrainStreamOp
    calls = []
    op = FtrlTrainStreamOp(base["twarm"], vector_col="vec",
                           label_col="label", time_interval=INTERVAL,
                           device="cpu").link_from(
        TMemS(base["ttbl"], batch_size=BATCH))
    assert op._batch_hook is None
    op.set_batch_hook(lambda ph, b, t: calls.append((ph, b)))
    for _ in op.timed_batches():
        pass
    n = N_ROWS // BATCH
    assert calls == [(ph, b) for b in range(1, n + 1)
                     for ph in ("pre", "post")]


class TestFlagOffByteIdentity:
    def test_served_response_bytes(self, base, monkeypatch):
        """With the fault variable unset, the E2E flag family (on or off)
        does not change a served response: the server answers the bytes
        of the predictor's own ``predict_table`` rows, which are the JAX
        package's labels and details."""
        from alink_tpu.common.params import Params as JParams
        from alink_tpu.operator.common.linear.mapper import \
            LinearModelMapper as JMapper
        from alink_tpu_torch.common.params import Params
        from alink_tpu_torch.operator.common.linear.mapper import \
            LinearModelMapper
        from alink_tpu_torch.serving import CompiledPredictor, PredictServer
        pp = {"prediction_col": "pred", "prediction_detail_col": "detail",
              "vector_col": "vec"}
        tt = base["twarm"].get_output_table()
        req = base["ttbl"].select(["vec"])
        mapper = LinearModelMapper(tt.schema, req.schema, Params(pp))
        mapper.load_model(tt)
        pred = CompiledPredictor(mapper, buckets=(4,), device="cpu",
                                 ship_dtype=torch.float64, name="e2e_b")

        def responses():
            srv = PredictServer(pred, name="e2e_bytes")
            try:
                return [repr(tuple(srv.submit(req.row(i)).result(30)))
                        for i in range(8)]
            finally:
                srv.close()

        want = [repr(tuple(r)) for r in
                pred.predict_table(req.first_n(8)).to_rows()]
        jt = base["jwarm"].get_output_table()
        jreq = base["jtbl"].select(["vec"])
        jm = JMapper(jt.schema, jreq.schema, JParams(pp))
        jm.load_model(jt)
        jrows = jm.map_table(jreq.first_n(8)).to_rows()
        got = [tuple(r) for r in pred.predict_table(req.first_n(8)).to_rows()]
        assert [r[1] for r in got] == [r[1] for r in jrows]
        assert responses() == want
        for k, v in {"ALINK_TPU_E2E_DAG": "1",
                     "ALINK_TPU_E2E_SLO_P99_MS": "5",
                     "ALINK_TPU_E2E_SLO_AUC": "0.9",
                     "ALINK_TPU_E2E_PACING": "throughput",
                     "ALINK_TPU_E2E_DEADLINE_MS": "100"}.items():
            monkeypatch.setenv(k, v)
        assert responses() == want
