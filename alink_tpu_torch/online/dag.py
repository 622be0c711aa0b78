"""OnlineDag — the whole online-learning loop as ONE supervised,
fault-tolerant program (the reference's ``FTRLExample.java`` DAG
upgraded to serving-tier traffic).

Counterpart: ``alink_tpu/online/dag.py``. One :class:`OnlineDag` wires
the port's stages into a single runtime with per-stage restart policy
and end-to-end SLO enforcement::

    ingest (resumable, replayable source)
      ├─> scoring/eval leg: rows served through PredictServer
      │     (deadlines + circuit breaker armed) -> windowed stream
      │     eval (AUC/logloss per window, durable journal) -> SLO +
      │     health/drift alerts
      └─> train leg: FtrlTrainStreamOp (checkpointed) -> model-snapshot
            stream -> supervised feeder -> hot swap into serving

The serving stage is the port's ``CompiledPredictor`` (its dense
kernel, B4, for dense rows) behind a ``PredictServer``; the trainer is
the port's ``FtrlTrainStreamOp`` with ``resume=True``. Both run on
``device`` (the card unless ``device="cpu"``) in ``dtype`` (the ship
dtype: float32 on the card, float64 for parity with the JAX package),
on the default stream: a swap's weights are copied to the card before
the flip publishes them (``serving/predictor.py``).

Restart policies (typed, per stage — the DAG supervisor is the
in-process stand-in for the cluster manager that would restart a dead
task, which is WHY it may catch :class:`~alink_tpu_torch.common.faults.
FaultInjected` that generic handlers must not):

* **trainer — restart-from-last-checkpoint.** A crashed drain rebuilds
  the trainer with ``resume=True``; the FTRL checkpoint machinery
  restores (z, n) bitwise and SKIPS the committed replay prefix
  pre-encode, so a micro-batch is never silently dropped or
  double-applied.
* **feeders / serving — respawn-with-last-good-model.** The serving
  tier keeps answering from the last successfully swapped model while
  the train leg restarts; crashed serving loops quarantine their
  in-flight batch with a typed error and respawn (request quarantine —
  never silence).
* **ingest — resume-at-offset.** The scoring leg's source iterator
  rebuilds the replayable source and fast-skips the already-delivered
  prefix; a batch whose delivery crashed is REDELIVERED (at-least-once
  into the idempotent eval journal, exactly-once into the windows).

**Deterministic pacing** (default): the scoring leg scores micro-batch
``k+1`` only after the trainer committed batch ``k``, and the trainer
holds batch ``k+1`` until batch ``k+1`` was scored (the FTRL
``set_batch_hook`` gate). Every score is then produced by the model
from the last emission boundary at or before ``k`` — a pure function
of the stream — so eval windows (and their score digests) are
BITWISE-resumable across kills and restarts. ``pacing="throughput"``
frees both legs for steady-state QPS measurement.

Artifacts (all under ``artifacts_dir``): ``ckpt/`` (trainer
checkpoints), ``eval/windows.jsonl`` (the durable window journal —
each closed window with AUC/logloss and a sha256 digest of its raw
scores), ``eval/scores.jsonl`` (the per-batch prediction log),
``serving/last_good.json`` (the last successfully swapped model table,
restored into serving at DAG restart; the JAX package's format, so
either package reads the other's).

Left out: the compile-plane ledger registrations of the serving and
trainer stages and ``common/plan.py::dag_stage_plan`` (the JAX
package's ``compileledger``), which wait for a program cache (ROADMAP
A10(b)); the ``/statusz`` document's ``program_cache`` is the
predictor's bucket counters.
"""

from __future__ import annotations

import hashlib
import json
import math
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..common.adminz import acquire_admin, release_admin
from ..common.device import resolve_device
from ..common.faults import FaultInjected, maybe_crash
from ..common.flags import flag_value
from ..common.metrics import get_registry, metrics_enabled
from ..common.mtable import MTable
from ..common.tracing import trace_instant
from ..common.types import TableSchema
from .slo import (SloBurnRate, SloContract, SloVerdict,
                  SwapStalenessTracker, e2e_dag_enabled, e2e_deadline_s)

__all__ = ["OnlineDag", "DagReport", "DagFailed", "RESTART_POLICIES",
           "e2e_max_restarts", "e2e_pacing"]

#: the typed per-stage restart policies
RESTART_POLICIES = {
    "train": "restart-from-last-checkpoint",
    "feed": "respawn-with-last-good-model",
    "serve": "respawn-with-last-good-model",
    "ingest": "resume-at-offset",
}

#: the quality anchor a final window must clear or explain
AUC_ANCHOR = 0.75


def e2e_max_restarts() -> int:
    """``ALINK_TPU_E2E_MAX_RESTARTS``: per-stage restart budget."""
    return int(flag_value("ALINK_TPU_E2E_MAX_RESTARTS"))


def e2e_pacing() -> str:
    """``ALINK_TPU_E2E_PACING``: deterministic | throughput."""
    return str(flag_value("ALINK_TPU_E2E_PACING"))


class DagFailed(RuntimeError):
    """A stage exhausted its restart budget (or hit a non-restartable
    error); carries the stage name and the last cause."""

    def __init__(self, stage: str, cause: BaseException):
        super().__init__(f"online DAG stage {stage!r} failed "
                         f"({type(cause).__name__}: {cause})")
        self.stage = stage
        self.cause = cause


class _Pacer:
    """The deterministic-interleave gate between the scoring and train
    legs, plus the committed-batch watermark both modes use for restart
    recovery timing. All waits are condition-variable based with an
    abort channel so a dead stage can never hang its peer."""

    def __init__(self, deterministic: bool, timeout_s: float = 600.0):
        self.deterministic = deterministic
        self.timeout_s = timeout_s
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self.scored = 0          # scoring-leg watermark (batch seq)
        self.committed = 0       # trainer watermark (batches committed)
        self.train_done = False
        self._abort: Optional[DagFailed] = None
        self._pending_recovery: List[Tuple[int, float, dict]] = []

    # -- the trainer-side hook (FtrlTrainStreamOp.set_batch_hook) --------
    def hook(self, phase: str, batch: int, t: float) -> None:
        with self._cond:
            # BOTH pacing modes: a dead scoring leg must stop the
            # trainer too — in throughput mode nothing below blocks, so
            # without this check the drain would keep training (and
            # mutating the already-returned report + last-good
            # artifact) after run() gave up
            if self._abort is not None:
                raise self._abort
        if phase == "pre":
            # a resumed trainer's first pre-batch call implies every
            # earlier batch is committed (restored from the checkpoint)
            # — jump the watermark BEFORE blocking, or a scoring leg
            # replaying its own skip-prefix deadlocks against us
            with self._cond:
                if batch - 1 > self.committed:
                    self.committed = batch - 1
                    self._cond.notify_all()
            if self.deterministic:
                self._wait(lambda: self.scored >= batch,
                           f"scoring leg to reach batch {batch}")
            return
        with self._cond:
            if batch > self.committed:
                self.committed = batch
                now = time.perf_counter()
                for c0, t_crash, rec in list(self._pending_recovery):
                    if self.committed > c0:
                        rec["recovery_s"] = round(now - t_crash, 4)
                        self._pending_recovery.remove((c0, t_crash, rec))
            self._cond.notify_all()

    # -- the scoring-leg side --------------------------------------------
    def on_scored(self, seq: int) -> None:
        with self._cond:
            if seq > self.scored:
                self.scored = seq
            self._cond.notify_all()

    def wait_committed(self, seq: int) -> None:
        if not self.deterministic:
            # throughput mode never blocks, but a dead train stage must
            # still stop the scoring leg — a journal written past the
            # crash would not be a bitwise prefix of the golden run
            with self._cond:
                if self._abort is not None:
                    raise self._abort
            return
        self._wait(lambda: self.committed >= seq or self.train_done,
                   f"trainer to commit batch {seq}")

    # -- supervision ------------------------------------------------------
    def training_done(self) -> None:
        with self._cond:
            self.train_done = True
            self._cond.notify_all()

    def abort(self, stage: str, cause: BaseException) -> None:
        with self._cond:
            first = self._abort is None
            if first:
                self._abort = DagFailed(stage, cause)
            self.train_done = True
            self._cond.notify_all()
        if first:
            # the FIRST stage abort is the incident (later aborts are
            # the shutdown cascade it causes): capture a post-mortem
            # bundle while the rings still hold the failing stage's
            # evidence (debounced, off without
            # ALINK_TPU_POSTMORTEM_DIR)
            from ..common import postmortem
            postmortem.maybe_bundle(
                "stage_abort",
                f"online DAG stage {stage!r} aborted "
                f"({type(cause).__name__}: {cause})",
                extra={"stage": stage,
                       "cause": type(cause).__name__})

    @property
    def aborted(self) -> Optional[DagFailed]:
        return self._abort

    def note_recovery(self, rec: dict) -> None:
        """Fill ``rec["recovery_s"]`` when the NEXT batch beyond the
        crash-time watermark commits (crash -> productive again)."""
        with self._cond:
            self._pending_recovery.append(
                (self.committed, time.perf_counter(), rec))

    def _wait(self, pred: Callable[[], bool], what: str) -> None:
        deadline = time.monotonic() + self.timeout_s
        with self._cond:
            while True:
                # abort wins even when the predicate holds: train_done
                # is set on abort too (to wake waiters), and a scoring
                # leg that kept going past a dead trainer would journal
                # scores the golden run produces with a NEWER model
                if self._abort is not None:
                    raise self._abort
                if pred():
                    return
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError(
                        f"online DAG pacing wait timed out ({what}; "
                        f"{self.timeout_s}s)")
                self._cond.wait(min(remaining, 0.5))


# ---------------------------------------------------------------------------
# durable artifacts: model table persist + eval window journal
# ---------------------------------------------------------------------------

def _json_safe(v: Any) -> Any:
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (np.floating,)):
        return float(v)
    if isinstance(v, np.bool_):
        return bool(v)
    return v


def save_model_table(path: str, version: int, table: MTable) -> None:
    """Atomically persist a model table (the serving tier's last-good
    artifact): write-tmp-then-rename + dir fsync, the checkpoint
    store's durability discipline."""
    doc = {"format": "alink_tpu_last_good_v1", "version": int(version),
           "names": list(table.schema.names),
           "types": [str(t) for t in table.schema.types],
           "rows": [[_json_safe(v) for v in table.row(i)]
                    for i in range(table.num_rows)]}
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    dfd = os.open(os.path.dirname(path) or ".", os.O_RDONLY)
    try:
        os.fsync(dfd)
    finally:
        os.close(dfd)


def load_model_table(path: str) -> Optional[Tuple[int, MTable]]:
    """The persisted last-good model, or ``None`` when absent/corrupt
    (a torn artifact must not block a restart — the warm-start model
    still serves; the corruption is surfaced as a warning)."""
    if not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            doc = json.load(f)
        table = MTable([tuple(r) for r in doc["rows"]],
                       TableSchema(doc["names"], doc["types"]))
        return int(doc["version"]), table
    except (ValueError, KeyError, TypeError) as e:
        import warnings
        warnings.warn(f"online DAG: last-good model artifact {path} is "
                      f"unreadable ({type(e).__name__}: {e}); serving "
                      f"restarts from the warm-start model",
                      RuntimeWarning)
        return None


def _journal_records(path: str) -> List[dict]:
    """Parse a JSONL journal tolerating a TORN FINAL line — the one
    tear the fsync-per-line append contract allows (a kill/power loss
    mid-write). The torn tail is truncated off so the append handle
    continues a valid journal, and a complete final record missing its
    newline gets one appended (the next record must not concatenate
    onto it). An unparsable NON-final line is real corruption, not a
    torn tail, and refuses loudly."""
    if not os.path.exists(path):
        return []
    with open(path, "rb") as f:
        data = f.read()
    recs: List[dict] = []
    offset = good_end = 0
    for line in data.splitlines(keepends=True):
        end = offset + len(line)
        s = line.strip()
        if s:
            try:
                recs.append(json.loads(s))
            except ValueError:
                if end < len(data):
                    raise ValueError(
                        f"corrupt journal line at byte {offset} of "
                        f"{path} (mid-file — not a torn tail; the "
                        f"artifact needs manual repair)")
                with open(path, "r+b") as tf:
                    tf.truncate(good_end)
                    tf.flush()
                    os.fsync(tf.fileno())
                return recs
        good_end = end
        offset = end
    if data and not data.endswith(b"\n"):
        with open(path, "ab") as af:
            af.write(b"\n")
            af.flush()
            os.fsync(af.fileno())
    return recs


def _window_auc(y: np.ndarray, p: np.ndarray) -> Optional[float]:
    """Rank-statistic AUC with tie-averaged ranks (the evaluation
    tier's formulation); ``None`` for a single-class window."""
    pos = y > 0.5
    n_pos, n_neg = int(pos.sum()), int((~pos).sum())
    if n_pos == 0 or n_neg == 0:
        return None
    order = np.argsort(p, kind="mergesort")
    ranks = np.empty(len(p), np.float64)
    sp = p[order]
    i = 0
    while i < len(sp):
        j = i
        while j + 1 < len(sp) and sp[j + 1] == sp[i]:
            j += 1
        ranks[order[i:j + 1]] = 0.5 * (i + j) + 1.0
        i = j + 1
    return float((ranks[pos].sum() - n_pos * (n_pos + 1) / 2.0)
                 / (n_pos * n_neg))


def _window_logloss(y: np.ndarray, p: np.ndarray) -> float:
    pc = np.clip(p, 1e-15, 1.0 - 1e-15)
    return float(-np.mean(y * np.log(pc) + (1.0 - y) * np.log(1.0 - pc)))


class _EvalWindowLog:
    """Windowed stream eval over a durable per-batch prediction log.

    Two artifacts side by side:

    * ``scores.jsonl`` — ONE line per scored micro-batch: seq, event
      time, and the raw (label, score) float64 values (json floats
      round-trip float64 exactly). This is the classic serving-tier
      prediction log, and it is what makes eval windows
      bitwise-RESUMABLE: the trainer's checkpoint cadence is batch-
      count-based while windows close on event time, so a per-window
      journal could lag the checkpoint and lose the scores needed to
      re-derive a partial window. The per-batch log always covers the
      scoring watermark, which deterministic pacing keeps AHEAD of the
      trainer's committed watermark.
    * ``windows.jsonl`` — one line per CLOSED event-time window
      (``window_end = (floor(t/interval)+1)*interval``, empty windows
      never fire — the stream-eval operators' contract) carrying
      AUC/logloss, the covered batch range, and a sha256 digest over
      the window's raw score bytes: the bitwise-continuation evidence
      the kill-and-resume tests pin.

    On restart the scores log is re-folded through the same window
    machinery (pure function), closed windows are re-derived in memory
    (NOT re-appended — the windows file continues where it left off),
    and scoring resumes at the first unlogged batch."""

    def __init__(self, scores_path: str, windows_path: str,
                 window_s: float, dag: str = "online"):
        self.scores_path = scores_path
        self.windows_path = windows_path
        self.window_s = float(window_s)
        self.dag = dag
        self.windows: List[dict] = []
        self.resume_seq = 0
        self._y: List[float] = []
        self._p: List[float] = []
        self._first_seq: Optional[int] = None
        self._last_seq = 0
        self._window_end: Optional[float] = None
        os.makedirs(os.path.dirname(scores_path), exist_ok=True)
        self._windows_on_disk = len(_journal_records(windows_path))
        for rec in _journal_records(scores_path):
            self._fold(int(rec["seq"]), float(rec["t"]),
                       np.asarray(rec["y"], np.float64),
                       np.asarray(rec["p"], np.float64),
                       replay=True)
        self.resume_seq = self._last_seq
        self._sf = open(scores_path, "a")
        self._wf = open(windows_path, "a")
        if len(self.windows) > self._windows_on_disk:
            # a crash landed between a batch's scores-log fsync and its
            # window close: the re-derivation regenerates the missing
            # window line(s) — the scores log is the source of truth
            for w in self.windows[self._windows_on_disk:]:
                self._wf.write(json.dumps(w, sort_keys=True) + "\n")
            self._wf.flush()
            os.fsync(self._wf.fileno())
            self._windows_on_disk = len(self.windows)

    def add_batch(self, seq: int, t: float, y: np.ndarray,
                  p: np.ndarray) -> List[dict]:
        """Durably log one scored batch, then fold it; returns any
        windows the fold closed (already journaled)."""
        self._sf.write(json.dumps(
            {"seq": int(seq), "t": float(t),
             "y": [float(v) for v in y],
             "p": [float(v) for v in p]}) + "\n")
        self._sf.flush()
        os.fsync(self._sf.fileno())
        return self._fold(seq, t, y, p)

    def _fold(self, seq: int, t: float, y: np.ndarray, p: np.ndarray,
              replay: bool = False) -> List[dict]:
        closed: List[dict] = []
        if self._window_end is None:
            self._window_end = (math.floor(t / self.window_s) + 1) \
                * self.window_s
        while t >= self._window_end:
            w = self._close(self._window_end, replay=replay)
            if w is not None:
                closed.append(w)
            self._window_end += self.window_s
        if self._first_seq is None:
            self._first_seq = seq
        self._y.extend(float(v) for v in y)
        self._p.extend(float(v) for v in p)
        self._last_seq = seq
        return closed

    def flush_final(self) -> Optional[dict]:
        """End-of-stream: close the trailing partial window (the eval
        stream op's final emission)."""
        if not self._y:
            return None
        return self._close(self._window_end
                           if self._window_end is not None
                           else self.window_s)

    def _close(self, end_t: float, replay: bool = False
               ) -> Optional[dict]:
        if not self._y:
            return None
        y = np.asarray(self._y, np.float64)
        p = np.asarray(self._p, np.float64)
        digest = hashlib.sha256(y.tobytes() + p.tobytes()).hexdigest()
        w = {"w": len(self.windows) + 1, "end_t": float(end_t),
             "first_seq": int(self._first_seq or 0),
             "last_seq": int(self._last_seq), "n": int(len(y)),
             "auc": _window_auc(y, p),
             "logloss": round(_window_logloss(y, p), 12),
             "digest": digest}
        self.windows.append(w)
        self._y, self._p, self._first_seq = [], [], None
        if replay:
            return w          # re-derived from the scores log: already
                              # on disk (or lost with its partial tail
                              # — re-derivation regenerates it below)
        if len(self.windows) > self._windows_on_disk:
            self._wf.write(json.dumps(w, sort_keys=True) + "\n")
            self._wf.flush()
            os.fsync(self._wf.fileno())
            self._windows_on_disk = len(self.windows)
        trace_instant("e2e.window", cat="e2e",
                      args={"w": w["w"], "n": w["n"], "auc": w["auc"]})
        if metrics_enabled():
            reg = get_registry()
            reg.inc("alink_e2e_windows_total", 1, {"dag": self.dag})
            if w["auc"] is not None:
                reg.set_gauge("alink_e2e_window_auc", w["auc"],
                              {"dag": self.dag})
        return w

    def close(self) -> None:
        self._sf.close()
        self._wf.close()


class _ResumableIngest:
    """The ingest stage: iterate a REPLAYABLE source with the
    resume-at-offset restart policy — on a crashed delivery the source
    rebuilds and the already-delivered prefix is fast-skipped (no
    re-scoring), the crashed batch is redelivered. The fault site
    ``ingest.batch`` is auto-indexed, so bounded kill windows clear
    across redeliveries."""

    def __init__(self, source_fn: Callable[[], Any], max_restarts: int,
                 report: "DagReport",
                 on_stage_event: Optional[Callable] = None):
        self.source_fn = source_fn
        self.max_restarts = max_restarts
        self.report = report
        self.on_stage_event = on_stage_event

    def batches(self):
        delivered = 0
        attempts = 0
        pending_rec: Optional[Tuple[float, dict]] = None
        while True:
            src = self.source_fn()
            try:
                seq = 0
                for t, mt in src.timed_batches():
                    if mt.num_rows == 0:
                        continue        # the trainer's raw_batches skips
                    seq += 1            # these too — keep seq aligned
                    if seq <= delivered:
                        continue        # resume-at-offset fast skip
                    maybe_crash("ingest.batch")
                    delivered = seq
                    if pending_rec is not None:
                        t_crash, rec = pending_rec
                        rec["recovery_s"] = round(
                            time.perf_counter() - t_crash, 4)
                        pending_rec = None
                    yield (seq, t, mt)
                return
            except GeneratorExit:
                raise
            except Exception as e:       # incl. FaultInjected: the
                attempts += 1            # supervisor IS the restart
                rec = {"stage": "ingest",
                       "policy": RESTART_POLICIES["ingest"],
                       "error": type(e).__name__,
                       "site": getattr(e, "site", None),
                       "offset": delivered, "recovery_s": None}
                self.report.restarts.append(rec)
                trace_instant("e2e.restart", cat="e2e", args=dict(rec))
                if metrics_enabled():
                    get_registry().inc("alink_e2e_restarts_total", 1,
                                       {"stage": "ingest"})
                if self.on_stage_event is not None:
                    try:
                        self.on_stage_event("ingest", e)
                    except BaseException:
                        pass   # a raising observer must not turn a
                        # supervised restart into an unhandled crash
                if attempts > self.max_restarts:
                    raise DagFailed("ingest", e)
                pending_rec = (time.perf_counter(), rec)


class _EmissionTap:
    """Wraps the trainer's snapshot stream so the DAG can timestamp
    each emission (the swap-staleness clock starts when the snapshot
    leaves the trainer, not when the feeder gets around to it)."""

    def __init__(self, op, tracker: SwapStalenessTracker):
        self.op = op
        self.tracker = tracker

    def timed_batches(self):
        for t, mt in self.op.timed_batches():
            self.tracker.mark_emitted()
            yield (t, mt)


@dataclass
class DagReport:
    """The whole-run verdict: eval windows, SLO verdicts (typed),
    restart records per stage, and the serving-tier counters."""
    windows: List[dict] = field(default_factory=list)
    final_window_auc: Optional[float] = None
    auc_note: Optional[str] = None
    slo: List[SloVerdict] = field(default_factory=list)
    breaches: List[SloVerdict] = field(default_factory=list)
    restarts: List[dict] = field(default_factory=list)
    swaps: int = 0
    swap_staleness_max_s: Optional[float] = None
    swap_staleness_mean_s: Optional[float] = None
    scored_rows: int = 0
    batches_scored: int = 0
    eval_retries: int = 0
    shed_requests: int = 0
    typed_rejections: int = 0
    silent_drops: int = 0
    feeder_skipped: int = 0
    feeder_retried: int = 0
    server_stats: Dict[str, Any] = field(default_factory=dict)
    wall_s: float = 0.0
    qps: float = 0.0
    p99_s: Optional[float] = None
    failed: Optional[str] = None

    def restart_count(self, stage: Optional[str] = None) -> int:
        return sum(1 for r in self.restarts
                   if stage is None or r["stage"] == stage)

    def slo_ok(self) -> bool:
        return all(v.ok for v in self.slo)

    def to_dict(self) -> dict:
        d = dict(self.__dict__)
        d["slo"] = [v.to_dict() for v in self.slo]
        d["breaches"] = [v.to_dict() for v in self.breaches]
        return d


class OnlineDag:
    """The supervised online-learning DAG (see module docstring).

    ``source_fn`` must build a fresh, REPLAYABLE stream of identical
    timed micro-batches each call (the reference's replayed-source
    resume assumption) carrying the feature column(s)/vector AND the
    label column; ``warm_model`` is the batch-trained initial linear
    model every FTRL run warm-starts from. ``device`` (default: the
    card) and ``dtype`` (the ship dtype of the trainer's state and of
    the served weights) are the port's.
    """

    def __init__(self, source_fn: Callable[[], Any], warm_model,
                 artifacts_dir: str, label_col: str,
                 vector_col: Optional[str] = None,
                 feature_cols: Optional[List[str]] = None,
                 alpha: float = 0.1, beta: float = 1.0,
                 l1: float = 0.0, l2: float = 0.0,
                 update_mode: str = "batch", staleness: int = 32,
                 time_interval: float = 1.0,
                 checkpoint_every: int = 4, checkpoint_keep: int = 3,
                 window_s: Optional[float] = None,
                 pacing: Optional[str] = None,
                 slo: Optional[SloContract] = None,
                 health=None,
                 deadline_s: Optional[float] = None,
                 max_restarts: Optional[int] = None,
                 buckets=None, min_fill=None,
                 request_timeout_s: float = 60.0,
                 score_retry_limit: int = 120,
                 name: str = "online",
                 on_stage_event: Optional[Callable] = None,
                 device=None, dtype: torch.dtype = torch.float32):
        if vector_col is None and not feature_cols:
            raise ValueError("OnlineDag needs vector_col or feature_cols")
        # resolved once: the card unless the caller asks for the CPU
        self.device = resolve_device(device)
        self.dtype = dtype
        self.source_fn = source_fn
        self.warm_model = warm_model
        self.artifacts_dir = artifacts_dir
        self.label_col = label_col
        self.vector_col = vector_col
        self.feature_cols = list(feature_cols) if feature_cols else None
        self.alpha, self.beta, self.l1, self.l2 = alpha, beta, l1, l2
        self.update_mode = update_mode
        self.staleness = staleness
        self.time_interval = float(time_interval)
        self.checkpoint_every = int(checkpoint_every)
        self.checkpoint_keep = int(checkpoint_keep)
        self.window_s = float(window_s) if window_s else self.time_interval
        self.pacing = pacing or e2e_pacing()
        armed_defaults = e2e_dag_enabled()
        self.slo = slo if slo is not None else (
            SloContract.from_flags(name) if armed_defaults
            else SloContract(name=name))
        self.health = health
        self.deadline_s = deadline_s if deadline_s is not None else (
            e2e_deadline_s() if armed_defaults else None)
        self.max_restarts = (e2e_max_restarts() if max_restarts is None
                             else int(max_restarts))
        self.buckets = buckets
        self.min_fill = min_fill
        self.request_timeout_s = float(request_timeout_s)
        self.score_retry_limit = int(score_retry_limit)
        self.name = name
        self.on_stage_event = on_stage_event

        self.ckpt_dir = os.path.join(artifacts_dir, "ckpt")
        self.eval_path = os.path.join(artifacts_dir, "eval",
                                      "windows.jsonl")
        self.scores_path = os.path.join(artifacts_dir, "eval",
                                        "scores.jsonl")
        self.last_good_path = os.path.join(artifacts_dir, "serving",
                                           "last_good.json")
        os.makedirs(self.ckpt_dir, exist_ok=True)
        os.makedirs(os.path.dirname(self.last_good_path), exist_ok=True)
        # a stage-abort post-mortem bundle must name the restart point:
        # point the bundle context at this DAG's durable
        # artifacts (checkpoints + last-good serving model)
        from ..common import postmortem
        postmortem.set_context("checkpoint", self.ckpt_dir)
        postmortem.set_context("last_good_model", self.last_good_path)

        # resolved at run()
        self.server = None
        self.predictor = None
        self.report = DagReport()
        self._versions: List[Tuple[int, MTable]] = []   # active-model set
        self._pacer: Optional[_Pacer] = None
        self._tracker: Optional[SwapStalenessTracker] = None
        self._live_feeder = None
        self._warm_table = None
        self._pos_label: Optional[str] = None
        # live operations plane: the DAG registers its
        # readiness + status on the shared admin endpoint for run()'s
        # duration; _swap_log is the /statusz "last N model swaps" ring
        self._admin = None
        self._burn: Optional[SloBurnRate] = None
        self._swap_log: List[dict] = []

    # -- stage builders ----------------------------------------------------
    def _build_serving(self):
        from ..common.params import Params
        from ..operator.common.linear.mapper import LinearModelMapper
        from ..serving.predictor import CompiledPredictor
        from ..serving.server import PredictServer
        warm_table = self.warm_model.get_output_table()
        self._warm_table = warm_table
        probe = self.source_fn()
        src_schema = probe.get_schema()
        feat_names = [self.vector_col] if self.vector_col \
            else self.feature_cols
        idx = [src_schema.names.index(c) for c in feat_names]
        data_schema = TableSchema([src_schema.names[i] for i in idx],
                                  [src_schema.types[i] for i in idx])
        pp = {"prediction_col": "pred", "prediction_detail_col": "detail"}
        if self.vector_col:
            pp["vector_col"] = self.vector_col
        else:
            pp["feature_cols"] = self.feature_cols
        mapper = LinearModelMapper(warm_table.schema, data_schema,
                                   Params(pp))
        # restore serving from the persisted last-good model when one
        # exists (respawn-with-last-good-model across DAG restarts);
        # the warm-start model otherwise
        restored = load_model_table(self.last_good_path)
        serve_table = restored[1] if restored is not None else warm_table
        mapper.load_model(serve_table)
        self.predictor = CompiledPredictor(mapper, buckets=self.buckets,
                                           device=self.device,
                                           ship_dtype=self.dtype,
                                           name=self.name)
        self.server = PredictServer(self.predictor, name=self.name,
                                    min_fill=self.min_fill)
        self._versions.append((self.predictor.model_version, serve_table))
        self._feat_idx = idx
        self._label_idx = src_schema.names.index(self.label_col)

    def _build_trainer(self):
        from ..operator.stream.onlinelearning.ftrl import FtrlTrainStreamOp
        kw = dict(label_col=self.label_col, alpha=self.alpha,
                  beta=self.beta, l1=self.l1, l2=self.l2,
                  update_mode=self.update_mode, staleness=self.staleness,
                  time_interval=self.time_interval,
                  checkpoint_dir=self.ckpt_dir,
                  checkpoint_every_batches=self.checkpoint_every,
                  checkpoint_keep=self.checkpoint_keep, resume=True)
        if self.vector_col:
            kw["vector_col"] = self.vector_col
        else:
            kw["feature_cols"] = self.feature_cols
        if self.health is not None:
            kw["health"] = self.health
        op = FtrlTrainStreamOp(self.warm_model, device=self.device,
                               ship_dtype=self.dtype, **kw).link_from(
            self.source_fn())
        op.set_batch_hook(self._pacer.hook)
        return op

    def _on_swap(self, version: int, model_table: MTable) -> None:
        staleness_s = self._tracker.mark_installed(version)
        self._versions.append((version, model_table))
        self.report.swaps += 1
        self._swap_log.append({"version": int(version),
                               "unix": time.time(),
                               "staleness_s": staleness_s})
        del self._swap_log[:-32]
        save_model_table(self.last_good_path, version, model_table)

    def _build_feeder(self, op):
        from ..serving.server import ModelStreamFeeder
        return ModelStreamFeeder(self.server,
                                 _EmissionTap(op, self._tracker),
                                 on_swap=self._on_swap)

    # -- the supervised train+feed stage ----------------------------------
    def _train_stage(self) -> None:
        attempts = 0
        while True:
            feeder = None
            try:
                op = self._build_trainer()
                feeder = self._build_feeder(op)
                self._live_feeder = feeder
                feeder.run()
                self.report.feeder_skipped += feeder.skipped
                self.report.feeder_retried += feeder.retried
                self._pacer.training_done()
                return
            except BaseException as e:
                if feeder is not None:
                    self.report.feeder_skipped += feeder.skipped
                    self.report.feeder_retried += feeder.retried
                if isinstance(e, DagFailed):
                    # the OTHER side already failed (the scoring leg's abort
                    # surfacing through the pacing hook) — not a
                    # trainer crash, nothing to restart
                    self._pacer.abort(e.stage, e.cause)
                    return
                site = getattr(e, "site", None)
                policy = (RESTART_POLICIES["feed"]
                          if site in ("feeder.snapshot", "serve.swap")
                          else RESTART_POLICIES["train"])
                rec = {"stage": "train", "policy": policy,
                       "error": type(e).__name__, "site": site,
                       "at_batch": self._pacer.committed,
                       "recovery_s": None}
                self.report.restarts.append(rec)
                trace_instant("e2e.restart", cat="e2e", args=dict(rec))
                if metrics_enabled():
                    get_registry().inc("alink_e2e_restarts_total", 1,
                                       {"stage": "train"})
                if self.on_stage_event is not None:
                    try:
                        self.on_stage_event("train", e)
                    except BaseException:
                        pass
                attempts += 1
                if not isinstance(e, Exception):
                    self._pacer.abort("train", e)   # interrupt: abort,
                    raise                           # never restart
                if attempts > self.max_restarts:
                    self._pacer.abort("train", e)
                    return
                self._pacer.note_recovery(rec)

    # -- the scoring/eval leg ---------------------------------------------
    def _request_rows(self, mt: MTable) -> List[Tuple]:
        cols = [mt.col(mt.schema.names[i]) for i in self._feat_idx]
        return [tuple(c[i] for c in cols) for i in range(mt.num_rows)]

    def _score_rows(self, rows: List[Tuple]) -> List[Tuple]:
        """Serve every row, retrying typed rejections (eval traffic is
        the ground truth — a shed/failed row is retried, never dropped;
        storms clear deterministically so the retry loop terminates).
        A future that resolves to NEITHER a result nor a typed error is
        a silent drop and fails the DAG loudly."""
        out: List[Optional[Tuple]] = [None] * len(rows)
        pending = list(range(len(rows)))
        attempt = 0
        while pending:
            futs = [(i, self.server.submit(rows[i],
                                           deadline_s=self.deadline_s))
                    for i in pending]
            failed: List[int] = []
            for i, f in futs:
                try:
                    out[i] = tuple(f.result(self.request_timeout_s))
                except TimeoutError:
                    self.report.silent_drops += 1
                    raise DagFailed("serve", RuntimeError(
                        "SILENT drop: a scoring future resolved to "
                        "neither a result nor a typed rejection"))
                except Exception:
                    self.report.typed_rejections += 1
                    failed.append(i)
            if failed:
                attempt += 1
                self.report.eval_retries += len(failed)
                if attempt > self.score_retry_limit:
                    raise DagFailed("serve", RuntimeError(
                        f"{len(failed)} eval rows still rejected after "
                        f"{attempt} retry rounds"))
                time.sleep(min(0.1, 0.005 * attempt))
            pending = failed
        return out  # type: ignore[return-value]

    # -- run ---------------------------------------------------------------
    def run(self, max_batches: Optional[int] = None) -> DagReport:
        """Execute the DAG to end of stream; returns the
        :class:`DagReport` (``report.failed`` set — and the report
        still rendered — when a stage exhausted its restart budget)."""
        t_run0 = time.perf_counter()
        self.report = DagReport()
        self._versions = []
        self._swap_log = []
        self._pacer = _Pacer(self.pacing == "deterministic")
        self._tracker = SwapStalenessTracker(self.slo, self.name)
        self._burn = SloBurnRate(self.slo, name=self.name)
        self._build_serving()
        # live operations plane: while armed, this run is
        # inspectable — /healthz|/readyz fold in the DAG's supervisor
        # state and the burn monitor (a critical fast-window burn reads
        # unready), /statusz shows swaps/clauses/restarts live
        self._admin = acquire_admin(self.name)
        if self._admin is not None:
            self._admin.add_source(f"dag:{self.name}", self._readiness)
            self._admin.add_source(f"slo:{self.name}",
                                   self._burn.readiness)
            self._admin.add_status(f"dag:{self.name}", self._statusz_doc)
        # positive label: the trainer's convention (label_values[0])
        self._pos_label = self._positive_label()
        eval_log = _EvalWindowLog(self.scores_path, self.eval_path,
                                  self.window_s, self.name)
        ingest = _ResumableIngest(self.source_fn, self.max_restarts,
                                  self.report, self.on_stage_event)
        det_idx: Optional[int] = None
        train_th = threading.Thread(target=self._train_stage,
                                    daemon=True,
                                    name=f"alink-e2e-{self.name}-train")
        train_th.start()
        t_score = 0.0
        try:
            for seq, t, mt in ingest.batches():
                if max_batches is not None and seq > max_batches:
                    break
                if seq <= eval_log.resume_seq:
                    # journaled pre-crash: replay-prefix skip on the
                    # EVAL side (the train side has its own)
                    self._pacer.on_scored(seq)
                    self._pacer.wait_committed(seq)
                    continue
                t0 = time.perf_counter()
                rows = self._request_rows(mt)
                if det_idx is None:
                    det_idx = list(
                        self.predictor.output_schema.names).index("detail")
                resp = self._score_rows(rows)
                t_score += time.perf_counter() - t0
                pos = self._pos_label
                p = np.asarray(
                    [float(json.loads(r[det_idx]).get(pos, 0.0))
                     for r in resp], np.float64)
                labels = mt.col(self.label_col)
                y = np.asarray([1.0 if str(v) == pos else 0.0
                                for v in labels], np.float64)
                self.report.scored_rows += len(rows)
                self.report.batches_scored += 1
                if metrics_enabled():
                    get_registry().inc("alink_e2e_scored_rows_total",
                                       len(rows), {"dag": self.name})
                for w in eval_log.add_batch(seq, t, y, p):
                    self._on_window_closed(w)
                self._pacer.on_scored(seq)
                self._pacer.wait_committed(seq)
            # stream ended: let the trainer finish its drain
            self._pacer.on_scored(10 ** 12)
            train_th.join(timeout=self._pacer.timeout_s)
            w = eval_log.flush_final()
            if w is not None:
                self._on_window_closed(w)
        except DagFailed as e:
            self.report.failed = str(e)
            self._pacer.abort(e.stage, e.cause)
        except BaseException as e:
            # any OTHER scoring-leg failure (a health watchdog abort
            # propagating out of _on_window_closed, a bug) must still
            # stop the trainer before the finally unblocks its gate —
            # an un-aborted train thread would keep training and
            # hot-swapping into the just-closed server after this
            # raises
            self._pacer.abort("serve", e)
            raise
        finally:
            self._pacer.on_scored(10 ** 12)   # never strand the hook
            train_th.join(timeout=10.0)
            stats = self.server.stats() if self.server else {}
            self.server.close()
            eval_log.close()
            if self._admin is not None:
                self._admin.remove_source(f"dag:{self.name}")
                self._admin.remove_source(f"slo:{self.name}")
                self._admin.remove_status(f"dag:{self.name}")
                self._admin = None
                release_admin()
        if self._pacer.aborted is not None and self.report.failed is None:
            self.report.failed = str(self._pacer.aborted)
        # -- the report --------------------------------------------------
        rep = self.report
        rep.windows = eval_log.windows
        aucs = [w["auc"] for w in rep.windows if w["auc"] is not None]
        rep.final_window_auc = aucs[-1] if aucs else None
        rep.auc_note = self._auc_note(rep)
        rep.swap_staleness_max_s = self._tracker.max_s
        rep.swap_staleness_mean_s = self._tracker.mean_s
        rep.server_stats = stats
        rep.shed_requests = int(stats.get("shed", 0))
        rep.p99_s = stats.get("p99_s")
        rep.breaches = list(self.slo.breaches)
        rep.slo = self.slo.final(rep.p99_s, rep.swap_staleness_max_s,
                                 rep.final_window_auc)
        rep.wall_s = time.perf_counter() - t_run0
        rep.qps = (rep.scored_rows / t_score) if t_score > 0 else 0.0
        return rep

    # -- helpers -----------------------------------------------------------
    def _positive_label(self) -> str:
        from ..operator.common.linear.base import LinearModelDataConverter
        data = LinearModelDataConverter.load_table(self._warm_table)
        return str(data.label_values[0])

    # -- admin-plane sources ------------------------------------------------
    def _readiness(self) -> dict:
        """ReadinessSource: the DAG is ready while no stage aborted;
        stage restart counts and feeder liveness ride as detail."""
        pacer = self._pacer
        aborted = pacer.aborted if pacer is not None else None
        restarts: Dict[str, int] = {}
        for rec in self.report.restarts:
            stage = rec.get("stage", "?")
            restarts[stage] = restarts.get(stage, 0) + 1
        doc = {"ready": aborted is None, "healthy": aborted is None,
               "stage_restarts": restarts,
               "committed_batches": (pacer.committed
                                     if pacer is not None else 0),
               "swaps": self.report.swaps}
        feeder = self._live_feeder
        if feeder is not None:
            doc["feeder"] = {
                "versions": getattr(feeder, "versions", None),
                "skipped": getattr(feeder, "skipped", 0),
                "retried": getattr(feeder, "retried", 0),
            }
        if aborted is not None:
            doc["aborted"] = str(aborted)
        return doc

    def _statusz_doc(self) -> dict:
        """/statusz section: swap history, staleness, live SLO clause +
        burn states, program-cache sizes, restart log."""
        doc: Dict[str, Any] = {
            "swaps": list(self._swap_log),
            "staleness": {
                "max_s": self._tracker.max_s if self._tracker else None,
                "mean_s": (self._tracker.mean_s
                           if self._tracker else None),
            },
            "slo_clauses": self.slo.clause_states(),
            "restarts": [dict(r) for r in self.report.restarts],
        }
        if self._burn is not None:
            doc["burn"] = self._burn.state()
        if self.predictor is not None:
            doc["program_cache"] = self.predictor.cache_stats()
        return doc

    def _on_window_closed(self, w: dict) -> None:
        stats = self.server.stats()
        self.slo.observe_p99(stats.get("p99_s"), w["w"])
        self.slo.observe_auc(w["auc"], w["w"])
        if self.health is not None:
            # drift/health alerting over the eval trajectory (the
            # monitor's own rules decide; a raise_on watchdog abort
            # propagates out of the scoring leg)
            if w["auc"] is not None:
                self.health.record("e2e.window_auc", w["w"], w["auc"])
            self.health.record("e2e.window_logloss", w["w"],
                               w["logloss"])
            self.health.evaluate()

    def _auc_note(self, rep: DagReport) -> Optional[str]:
        """The quality anchor: a final-window AUC below the
        0.75 anchor must carry a self-explaining convergence note
        (window trajectory + why), never a bare chance-level number."""
        floor = self.slo.final_window_auc or AUC_ANCHOR
        auc = rep.final_window_auc
        if auc is not None and auc >= floor:
            return None
        traj = [round(w["auc"], 4) for w in rep.windows
                if w["auc"] is not None]
        if not traj:
            return ("no two-class eval window closed — the drain is "
                    "shorter than one eval window or the label stream "
                    "is single-class; lengthen the stream or shrink "
                    "window_s")
        rising = len(traj) >= 2 and traj[-1] > traj[0] + 0.01
        why = ("AUC still rising across windows: the drain ended before "
               "convergence — lengthen the stream, warm-start on more "
               "rows, or raise time_interval so more batches fold into "
               "each emitted model"
               if rising else
               "AUC flat near chance: the model is not learning this "
               "stream — check feature hashing width (vector_size), "
               "label parsing (positive label "
               f"{self._pos_label!r}), and the warm start")
        return (f"final-window AUC {auc if auc is not None else 'n/a'} "
                f"is below the {floor} anchor; window trajectory "
                f"{traj}; {why}")
