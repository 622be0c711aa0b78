"""Slice 24 of the port: the sampling, split, id and cast ops on the CPU
against the JAX package.

Their draws come from ``np.random.RandomState(seed)`` on the host in
both packages, made the same way, so the tolerance is 0: the same rows
in the same order, the same cells (``SampleBatchOp`` with and without
replacement, ``SampleWithSizeBatchOp`` both ways, ``WeightSampleBatchOp``,
``SplitBatchOp`` and its side output, ``ShuffleBatchOp``,
``FirstNBatchOp``, ``AppendIdBatchOp``, ``NumericalTypeCastBatchOp`` to
each numeric type). None of these ops takes a device.
"""

import inspect

import jax
import numpy as np
import pytest

from alink_tpu.common.mlenv import MLEnvironment as JEnv
from alink_tpu.common.mlenv import MLEnvironmentFactory as JFactory
from alink_tpu.operator.batch import dataproc as jdp
from alink_tpu.operator.batch.source import MemSourceBatchOp as JMem
from alink_tpu_torch.operator.batch import dataproc as tdp
from alink_tpu_torch.operator.batch.source import MemSourceBatchOp as TMem

SCHEMA = "i LONG, x DOUBLE, w DOUBLE, s STRING, k INT"


@pytest.fixture(autouse=True)
def jax_default_1dev():
    prev = JFactory.get_default()
    JFactory.set_default(JEnv(parallelism=1, devices=jax.devices()[:1]))
    yield
    JFactory.set_default(prev)


def _rows(n=500, seed=0):
    rng = np.random.RandomState(seed)
    return [(i, float(rng.randn()), float(rng.rand() * 3 + 0.01),
             f"s{rng.randint(0, 9)}", int(rng.randint(-5, 5)))
            for i in range(n)]


def _same(t, j):
    assert t.col_names == j.col_names
    assert t.schema.types == j.schema.types
    assert repr(t.to_rows()) == repr(j.to_rows())
    for c in t.col_names:
        assert np.asarray(t.col(c)).dtype == np.asarray(j.col(c)).dtype, c


CASES = [
    ("SampleBatchOp", dict(ratio=0.3, seed=1)),
    ("SampleBatchOp", dict(ratio=0.3, seed=1, with_replacement=True)),
    ("SampleBatchOp", dict(ratio=1.0, seed=7)),
    ("SampleWithSizeBatchOp", dict(size=77, seed=2)),
    ("SampleWithSizeBatchOp", dict(size=77, seed=2, with_replacement=True)),
    ("WeightSampleBatchOp", dict(weight_col="w", ratio=0.2, seed=3)),
    ("SplitBatchOp", dict(fraction=0.75, seed=4)),
    ("SplitBatchOp", dict(fraction=0.0, seed=4)),
    ("ShuffleBatchOp", dict(seed=5)),
    ("FirstNBatchOp", dict(size=12)),
    ("AppendIdBatchOp", dict()),
    ("AppendIdBatchOp", dict(id_col="rid")),
    ("NumericalTypeCastBatchOp", dict(target_type="DOUBLE")),
    ("NumericalTypeCastBatchOp", dict(selected_cols=["x"], target_type="INT")),
    ("NumericalTypeCastBatchOp", dict(selected_cols=["i", "k"],
                                      target_type="FLOAT")),
    ("NumericalTypeCastBatchOp", dict(selected_cols=["x"], target_type="LONG")),
]


@pytest.mark.parametrize("name,kw", CASES,
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(CASES)])
def test_op_equals_the_jax_package(name, kw):
    rows = _rows()
    t = getattr(tdp, name)(**kw).link_from(TMem(rows, SCHEMA))
    j = getattr(jdp, name)(**kw).link_from(JMem(rows, SCHEMA))
    _same(t.get_output_table(), j.get_output_table())
    if name == "SplitBatchOp":
        _same(t.get_side_output(0).get_output_table(),
              j.get_side_output(0).get_output_table())
        left = t.get_output_table().num_rows
        assert left == int(round(kw["fraction"] * len(rows)))
        assert left + t.get_side_output(0).get_output_table().num_rows \
            == len(rows)


def test_sample_counts_and_draws_follow_the_seed():
    rows = _rows(200)
    s = tdp.SampleBatchOp(ratio=0.3, seed=1).link_from(TMem(rows, SCHEMA))
    mask = np.random.RandomState(1).rand(200) < 0.3
    assert list(s.get_output_table().col("i")) == list(np.flatnonzero(mask))
    ws = tdp.WeightSampleBatchOp(weight_col="w", ratio=0.2, seed=3) \
        .link_from(TMem(rows, SCHEMA))
    assert ws.get_output_table().num_rows == 40
    ids = tdp.AppendIdBatchOp().link_from(TMem(rows, SCHEMA))
    assert list(ids.get_output_table().col("append_id")) == list(range(200))


def test_the_ops_take_no_device():
    for name in ("SampleBatchOp", "SampleWithSizeBatchOp",
                 "WeightSampleBatchOp", "SplitBatchOp", "FirstNBatchOp",
                 "AppendIdBatchOp", "ShuffleBatchOp",
                 "NumericalTypeCastBatchOp"):
        cls = getattr(tdp, name)
        assert "device" not in inspect.signature(cls.__init__).parameters
