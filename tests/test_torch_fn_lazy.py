"""Slice 25 of the port: the function operators (``operator/batch/utils/
fn_ops.py`` and their stream twins in ``operator/stream/utils``), lazy
evaluation (``common/lazy.py``, the lazy hooks of ``operator/base.py``
and ``Trainer.enable_lazy_print_*``) and the ``BatchOperator``
conveniences, on the CPU against the JAX package.

Host code, held exactly: the same tables and the same printed text. The
lazy callbacks fire once, at ``execute()``, with the values an eager
``collect()`` gives; a host op's ``lazy_print`` needs no card (CUDA
reported absent), as the port keeps the manager off the session.
"""

import contextlib
import io

import numpy as np
import pytest
import torch

from alink_tpu.common.mtable import MTable as JT
from alink_tpu.operator.base import TableSourceBatchOp as JSrc
from alink_tpu.operator.batch.utils import fn_ops as jfn
from alink_tpu.operator.stream import utils as jsu
from alink_tpu.operator.stream.source.sources import \
    MemSourceStreamOp as JMemS
from alink_tpu_torch.common.lazy import (LazyEvaluation, LazyObjectsManager,
                                         lazy_objects_manager)
from alink_tpu_torch.common.mtable import MTable as TT
from alink_tpu_torch.operator.base import TableSourceBatchOp as TSrc
from alink_tpu_torch.operator.batch.utils import fn_ops as tfn
from alink_tpu_torch.operator.stream import utils as tsu
from alink_tpu_torch.operator.stream.source.sources import \
    MemSourceStreamOp as TMemS

SCHEMA = "id LONG, x DOUBLE, s STRING"


def _rows(n=20, seed=0):
    rng = np.random.RandomState(seed)
    return [(i, float(np.round(rng.randn(), 4)), "w" * (i % 4))
            for i in range(n)]


def _cell(v):
    if isinstance(v, (float, np.floating)):
        return ("f", np.float64(v).tobytes())
    return ("o", str(v))


def same(got, want):
    assert got.col_names == want.col_names
    assert list(got.schema.types) == list(want.schema.types)
    assert [tuple(map(_cell, r)) for r in got.to_rows()] == \
        [tuple(map(_cell, r)) for r in want.to_rows()]


def _printed(fn):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn()
    return buf.getvalue()


CASES = [
    ("UDFBatchOp", dict(selected_cols=["x", "id"], output_col="y"),
     lambda x, i: x * 2 + i),
    ("UDFBatchOp", dict(selected_cols=["s"], output_col="s",
                        result_type="LONG", reserved_cols=["id"]), len),
    ("UDTFBatchOp", dict(selected_cols=["s"], output_cols=["ch", "pos"],
                         result_types=["STRING", "LONG"]),
     lambda s: [(c, k) for k, c in enumerate(s)]),
    ("UDTFBatchOp", dict(selected_cols=["id"], output_cols=["d"]),
     lambda i: [i / 2] if i % 3 else []),
    ("FlatMapBatchOp", dict(schema_str="id LONG, twice DOUBLE"),
     lambda r: [(r[0], r[1] * 2)] * (r[0] % 3))]


@pytest.mark.parametrize("k", range(len(CASES)))
def test_fn_ops_match(k):
    name, kw, fn = CASES[k]
    rows = _rows()
    got = getattr(tfn, name)(func=fn, **kw).link_from(TSrc(TT(rows, SCHEMA)))
    want = getattr(jfn, name)(**kw).set_func(fn).link_from(
        JSrc(JT(rows, SCHEMA)))
    same(got.get_output_table(), want.get_output_table())


def test_fn_ops_need_a_function_and_print_passes_through():
    with pytest.raises(ValueError, match="set_func"):
        tfn.UDFBatchOp(selected_cols=["x"], output_col="y").link_from(
            TSrc(TT(_rows(), SCHEMA)))
    t, j = TT(_rows(5), SCHEMA), JT(_rows(5), SCHEMA)
    a = _printed(lambda: tfn.PrintBatchOp().link_from(TSrc(t)))
    b = _printed(lambda: jfn.PrintBatchOp().link_from(JSrc(j)))
    assert a == b and "w" in a
    same(tfn.DataSetWrapperBatchOp(t).get_output_table(), j)


@pytest.mark.parametrize("k", [0, 2, 4])
def test_fn_stream_twins_match(k):
    name, kw, fn = CASES[k]
    sname = name.replace("BatchOp", "StreamOp")
    rows = _rows(33, 2)
    got = getattr(tsu, sname)(func=fn, **kw).link_from(
        TMemS(rows, SCHEMA, batch_size=8))
    want = getattr(jsu, sname)(func=fn, **kw).link_from(
        JMemS(rows, SCHEMA, batch_size=8))
    g, w = list(got.timed_batches()), list(want.timed_batches())
    assert [t for t, _ in g] == [t for t, _ in w] and len(g) >= 3
    for (_, a), (_, b) in zip(g, w):
        same(a, b)
    ps = tsu.PrintStreamOp().link_from(TMemS(rows, SCHEMA, batch_size=8))
    pj = jsu.PrintStreamOp().link_from(JMemS(rows, SCHEMA, batch_size=8))
    assert _printed(lambda: list(ps.timed_batches())) == \
        _printed(lambda: list(pj.timed_batches()))


def test_lazy_evaluation_replays_to_late_subscribers():
    lazy = LazyEvaluation()
    seen = []
    lazy.add_callback(seen.append)
    with pytest.raises(RuntimeError, match="execute"):
        lazy.value
    lazy.add_value(5)
    assert seen == []
    lazy.fire()
    lazy.fire()
    assert seen == [5]
    lazy.add_callback(seen.append)
    assert seen == [5, 5] and lazy.value == 5
    m = LazyObjectsManager()
    assert m.gen_lazy("k") is m.gen_lazy("k")
    assert lazy_objects_manager() is lazy_objects_manager()


def test_lazy_hooks_fire_once_at_execute_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rows = _rows(25, 3)
    t, j = TSrc(TT(rows, SCHEMA)), JSrc(JT(rows, SCHEMA))
    got, want = [], []
    out_t = _printed(lambda: (
        t.lazy_print(5, "head").lazy_collect(got.append)
        .lazy_collect_mtable(got.append).lazy_print_statistics("stats")))
    out_j = _printed(lambda: (
        j.lazy_print(5, "head").lazy_collect(want.append)
        .lazy_collect_mtable(want.append).lazy_print_statistics("stats")))
    assert out_t == out_j == "" and got == []
    printed_t = _printed(t.execute)
    printed_j = _printed(j.execute)
    assert printed_t == printed_j and "head" in printed_t
    assert "stats" in printed_t
    assert got[0] == t.collect() and got[1] is t.collect_mtable()
    assert [tuple(map(_cell, r)) for r in got[0]] == \
        [tuple(map(_cell, r)) for r in want[0]]
    assert _printed(t.execute) == ""          # once
    assert len(got) == 2


def test_conveniences_match():
    rows = _rows(30, 4)
    t, j = TSrc(TT(rows, SCHEMA)), JSrc(JT(rows, SCHEMA))
    assert _printed(lambda: t.print(4, "t")) == \
        _printed(lambda: j.print(4, "t"))
    same(t.first_n(3).get_output_table(), j.first_n(3).get_output_table())
    a, b = t.collect_statistics(), j.collect_statistics()
    assert a.to_display_string() == b.to_display_string()
    for op in (t, j):
        tr, te = op.split(0.6, seed=3)
        assert tr.get_output_table().num_rows + \
            te.get_output_table().num_rows == 30
    ta, tb = t.split(0.6, seed=3)
    ja, jb = j.split(0.6, seed=3)
    same(ta.get_output_table(), ja.get_output_table())
    same(tb.get_output_table(), jb.get_output_table())
    same(t.sample(0.5).get_output_table(), j.sample(0.5).get_output_table())
    same(t.link(tfn.UDFBatchOp(selected_cols=["x"], output_col="y",
                               func=abs)).get_output_table(),
         j.link(jfn.UDFBatchOp(selected_cols=["x"], output_col="y")
                .set_func(abs)).get_output_table())
    assert t.from_table(t.get_output_table()).get_output_table() is \
        t.get_output_table()
    assert t.get_col_names() == ["id", "x", "s"]


def test_trainer_lazy_info_fires_once_at_execute():
    """``enable_lazy_print_train_info`` / ``_model_info`` on a port
    ``LogisticRegression`` print the same tables at ``execute()`` as the
    train op's side output and model summary, once."""
    from alink_tpu_torch.operator.batch.source import MemSourceBatchOp
    from alink_tpu_torch.pipeline.classification import LogisticRegression
    rng = np.random.RandomState(0)
    x = rng.randn(60)
    tab = TT({"x": x, "y": (x + 0.3 * rng.randn(60) > 0).astype(int)},
             "x DOUBLE, y LONG")
    est = LogisticRegression(feature_cols=["x"], label_col="y",
                             prediction_col="p", max_iter=4, device="cpu")
    est.enable_lazy_print_train_info("TI").enable_lazy_print_model_info("MI")
    src = MemSourceBatchOp(tab)
    assert _printed(lambda: est.fit(src)) == ""
    op = est._last_train_op
    text = _printed(src.execute)
    assert text.index("TI") < text.index("MI")
    assert op.get_train_info().to_display_string() in text
    assert op.get_model_info().to_display_string() in text
    assert _printed(src.execute) == ""
    clone = est.clone()
    assert "__lazy_train_info" in clone.params._m
