"""Slice 23 of the port: the multilayer perceptron on the CPU against the
JAX package.

The JAX side runs under x64 on a 1-device default session, the port with
``device="cpu"`` and ``dtype=torch.float64``. The port's gradient comes
from ``torch.autograd``, the JAX package's from ``jax.value_and_grad``:
they sum in other orders, so the gates are tolerances, not bits.

* ``MlpObjFunc`` at a seeded point: the loss, the gradient and the line
  search's 11 losses within rtol 1e-12 (the gradient within 1e-12 of its
  largest entry);
* ``MultilayerPerceptronTrainBatchOp`` at ``epsilon=0``: the loss curve
  over 10 supersteps and the coefficients after 5 within rtol 1e-10
  (past a few supersteps L-BFGS's line search can break a tie by an ulp,
  ROADMAP Queue C "L-BFGS"), the standardization and the start bitwise
  (host numpy, copied);
* ``MultilayerPerceptronPredictBatchOp``: labels equal, the detail
  probabilities within rtol 1e-10;
* each package's table loads in the other and predicts the same labels;
* the pipeline's ``MultilayerPerceptronClassifier`` fits and transforms
  as the ops do.
"""

import json

import jax
import numpy as np
import pytest
import torch

from alink_tpu.common.mlenv import MLEnvironment as JEnv
from alink_tpu.common.mlenv import MLEnvironmentFactory as JFactory
from alink_tpu.common.mtable import MTable as JMTable
from alink_tpu.operator.batch.classification import mlpc_ops as jm
from alink_tpu.operator.batch.source import MemSourceBatchOp as JMem
from alink_tpu.operator.common.ann import mlp as jmlp
from alink_tpu_torch.model.interop import simple_model_table_from_reference
from alink_tpu_torch.operator.batch.classification import mlpc_ops as tm
from alink_tpu_torch.operator.batch.source import MemSourceBatchOp as TMem
from alink_tpu_torch.operator.common.ann import mlp as tmlp
from alink_tpu_torch.pipeline import MultilayerPerceptronClassifier

CURVE_RTOL = 1e-10
FEATS = ["a", "b", "c"]
SCHEMA = "a DOUBLE, b DOUBLE, c DOUBLE, label STRING"
OUT = dict(prediction_col="pred", prediction_detail_col="detail")


@pytest.fixture
def jax_default_1dev():
    """The JAX ops train on the default session: make it 1-device for
    the test, and put the 8-device one back after."""
    prev = JFactory.get_default()
    JFactory.set_default(JEnv(parallelism=1, devices=jax.devices()[:1]))
    yield
    JFactory.set_default(prev)


def _rows(n=300, seed=0):
    """Rings in the first two columns (not linearly separable), a noise
    column on another scale, three classes."""
    rng = np.random.RandomState(seed)
    cls = rng.randint(0, 3, n)
    r = np.asarray([0.5, 1.5, 2.5])[cls] + 0.1 * rng.randn(n)
    th = rng.rand(n) * 2 * np.pi
    X = np.stack([r * np.cos(th), r * np.sin(th),
                  50.0 + 10.0 * rng.randn(n)], 1)
    return [(float(x[0]), float(x[1]), float(x[2]), f"c{c}")
            for x, c in zip(X, cls)]


def _train(steps, rows, **extra):
    kw = dict(feature_cols=FEATS, label_col="label", layers=[6, 3],
              max_iter=steps, epsilon=0.0, seed=3, **extra)
    top = tm.MultilayerPerceptronTrainBatchOp(
        device="cpu", dtype=torch.float64, **kw).link_from(TMem(rows, SCHEMA))
    jop = jm.MultilayerPerceptronTrainBatchOp(**kw).link_from(
        JMem(rows, SCHEMA))
    return top, jop


def _curve(op):
    return np.asarray(op.get_side_output(0).get_output_table().col("loss"))


def _model(conv, op):
    return conv.load_model(op.get_output_table())


def test_objective_matches_the_jax_package():
    rng = np.random.RandomState(1)
    sizes = [5, 7, 4]
    X = rng.randn(64, 5)
    y = rng.randint(0, 4, 64).astype(np.float64)
    w = rng.rand(64) + 0.5
    coef = rng.randn(tmlp.stack_sizes(sizes)) * 0.4
    direction = rng.randn(coef.size) * 0.1
    steps = np.concatenate([[0.0], 2.0 ** (1 - np.arange(10))])
    tobj, jobj = tmlp.MlpObjFunc(sizes, l2=0.01), jmlp.MlpObjFunc(sizes,
                                                                  l2=0.01)
    assert tobj.dim == jobj.dim == tmlp.stack_sizes(sizes) == 5 * 7 + 7 + 7 * 4 + 4
    t = {k: torch.from_numpy(v) for k, v in (("X", X), ("y", y), ("w", w))}
    tg, tl, tw = tobj.calc_grad_shard(t, torch.from_numpy(coef))
    jg, jl, jw = jobj.calc_grad_shard({"X": X, "y": y, "w": w}, coef)
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-12)
    np.testing.assert_allclose(tw.item(), float(jw), rtol=1e-12)
    jg = np.asarray(jg)
    assert np.abs(tg.numpy() - jg).max() <= 1e-12 * np.abs(jg).max()
    tls = tobj.line_losses_shard(t, torch.from_numpy(coef),
                                 torch.from_numpy(direction),
                                 torch.from_numpy(steps))
    jls = jobj.line_losses_shard({"X": X, "y": y, "w": w}, coef, direction,
                                 steps)
    np.testing.assert_allclose(tls.numpy(), np.asarray(jls), rtol=1e-12)
    assert not tls.requires_grad


def test_training_matches_the_jax_package(jax_default_1dev):
    rows = _rows()
    top, jop = _train(10, rows)
    tc, jc = _curve(top), _curve(jop)
    assert len(tc) == len(jc) == 10 and tc[-1] < tc[0]
    np.testing.assert_allclose(tc, jc, rtol=CURVE_RTOL)
    top5, jop5 = _train(5, rows)
    a, b = _model(tm.MlpModelConverter(), top5), _model(jm.MlpModelConverter(),
                                                        jop5)
    assert a["layer_sizes"] == b["layer_sizes"] == [3, 6, 3]
    np.testing.assert_array_equal(a["mean"], b["mean"])
    np.testing.assert_array_equal(a["std"], b["std"])
    np.testing.assert_allclose(a["coef"], b["coef"], rtol=CURVE_RTOL,
                               atol=CURVE_RTOL * np.abs(b["coef"]).max())


def test_predictions_and_tables_across(jax_default_1dev):
    rows = _rows()
    top, jop = _train(40, rows)
    held = _rows(120, seed=9)
    tout = tm.MultilayerPerceptronPredictBatchOp(device="cpu", **OUT) \
        .link_from(top, TMem(held, SCHEMA)).get_output_table()
    jout = jm.MultilayerPerceptronPredictBatchOp(**OUT).link_from(
        jop, JMem(held, SCHEMA)).get_output_table()
    acc = np.mean([p == r[3] for p, r in zip(tout.col("pred"), held)])
    assert acc > 0.6
    # the JAX package's table in the port, the port's in the JAX package
    into_port = simple_model_table_from_reference(
        jop.get_output_table().to_rows())
    into_jax = JMTable(top.get_output_table().to_rows(),
                       "model_id LONG, model_info STRING")
    a = tm.MultilayerPerceptronPredictBatchOp(device="cpu", **OUT).link_from(
        TMem(into_port), TMem(held, SCHEMA)).get_output_table()
    b = jm.MultilayerPerceptronPredictBatchOp(**OUT).link_from(
        JMem(into_jax), JMem(held, SCHEMA)).get_output_table()
    for x, y in ((a, jout), (b, tout)):
        assert list(x.col("pred")) == list(y.col("pred"))
        for u, v in zip(x.col("detail"), y.col("detail")):
            du, dv = json.loads(u), json.loads(v)
            np.testing.assert_allclose([du[k] for k in dv],
                                       [dv[k] for k in dv], rtol=1e-10,
                                       atol=1e-300)


def test_pipeline_stage_fits_and_transforms():
    rows = _rows()
    kw = dict(feature_cols=FEATS, label_col="label", layers=[6, 3],
              max_iter=20, seed=3)
    model = MultilayerPerceptronClassifier(
        device="cpu", dtype=torch.float64, prediction_col="pred", **kw).fit(
        TMem(rows, SCHEMA))
    got = model.transform(TMem(rows, SCHEMA)).get_output_table()
    op = tm.MultilayerPerceptronTrainBatchOp(
        device="cpu", dtype=torch.float64, **kw).link_from(TMem(rows, SCHEMA))
    want = tm.MultilayerPerceptronPredictBatchOp(
        device="cpu", prediction_col="pred").link_from(
        op, TMem(rows, SCHEMA)).get_output_table()
    assert got.to_rows() == want.to_rows()


def test_float32_training_is_float32_and_repeats():
    rows = _rows()
    kw = dict(feature_cols=FEATS, label_col="label", layers=[6, 3],
              max_iter=8, seed=3)
    a, b = (tm.MultilayerPerceptronTrainBatchOp(device="cpu", **kw)
            .link_from(TMem(rows, SCHEMA)) for _ in range(2))
    assert _curve(a).tolist() == _curve(b).tolist()
    assert a.get_output_table().to_rows() == b.get_output_table().to_rows()
    ma = _model(tm.MlpModelConverter(), a)
    assert np.array_equal(ma["coef"], ma["coef"].astype(np.float32))
