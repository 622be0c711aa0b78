"""The port's BSP engine at one worker against the JAX package's.

``alink_tpu_torch.engine.IterativeComQueue`` runs its stages eagerly on
one device; the JAX package's traces them into one ``while_loop``
program. Each case runs the same stages, written once in ``jnp`` and
once in ``torch``, on both engines: the JAX side under an explicit
1-device ``MLEnvironment`` (the tier-1 process runs an 8-device mesh),
the port on the CPU. The data are small integers, so every sum is exact
and the results are compared bit for bit, along with the number of
supersteps run.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alink_tpu.common.mlenv import MLEnvironment as JEnv
from alink_tpu.engine import AllReduce as JAllReduce
from alink_tpu.engine import IterativeComQueue as JQueue
from alink_tpu.engine.comqueue import freeze_config as jfreeze
from alink_tpu_torch.common.mlenv import (MLEnvironment, MLEnvironmentFactory,
                                          use_local_env)
from alink_tpu_torch.engine import AllReduce, IterativeComQueue
from alink_tpu_torch.engine.comqueue import freeze_config
from alink_tpu_torch.engine.communication import (manifest_pmax,
                                                  manifest_pmin,
                                                  manifest_psum)

RNG = np.random.RandomState(3)
X = RNG.randint(-5, 6, (24, 3)).astype(np.float64)
W = RNG.randint(-2, 3, (3,)).astype(np.float64)


@pytest.fixture(scope="module")
def jenv():
    return JEnv(parallelism=1, devices=jax.devices()[:1])


@pytest.fixture(scope="module")
def tenv():
    return MLEnvironment(device="cpu")


def _both(jenv, tenv, build_j, build_t):
    """Run the two queues; returns their ComQueueResults."""
    return build_j(JQueue(env=jenv, max_iter=6)).exec(), \
        build_t(IterativeComQueue(env=tenv, max_iter=6)).exec()


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype
    assert np.array_equal(a, b)


def test_sum_over_steps_and_init_pass(jenv, tenv):
    """The init pass is superstep 1 and does real work; every later
    superstep adds step_no * sum(X) to the accumulator."""
    def j_stage(ctx):
        if ctx.is_init_step:
            ctx.put_obj("acc", jnp.zeros((), jnp.float64))
            ctx.put_obj("inits", jnp.zeros((), jnp.int32))
            ctx.put_obj("inits", ctx.get_obj("inits") + 1)
        ctx.put_obj("acc", ctx.get_obj("acc")
                    + ctx.get_obj("X").sum() * ctx.step_no)

    def t_stage(ctx):
        if ctx.is_init_step:
            ctx.put_obj("acc", torch.zeros((), dtype=torch.float64))
            ctx.put_obj("inits", torch.zeros((), dtype=torch.int32))
            ctx.put_obj("inits", ctx.get_obj("inits") + 1)
        ctx.put_obj("acc", ctx.get_obj("acc")
                    + ctx.get_obj("X").sum() * ctx.step_no)

    rj, rt = _both(jenv, tenv,
                   lambda q: q.init_with_partitioned_data("X", X).add(j_stage),
                   lambda q: q.init_with_partitioned_data("X", X).add(t_stage))
    _same(rj.get("acc"), rt.get("acc"))
    _same(rj.get("inits"), rt.get("inits"))
    assert int(rt.get("inits")) == 1
    assert rj.step_count == rt.step_count == 6
    assert sorted(rj.keys()) == sorted(rt.keys()) == ["acc", "inits"]
    _same(rj.shards("acc"), rt.shards("acc"))


@pytest.mark.parametrize("limit", [0.0, 40.0, 1e9])
def test_stop_criterion(jenv, tenv, limit):
    """The criterion runs after every superstep, the init pass included,
    and the loop stops at the first superstep where it holds."""
    s = float(np.abs(X).sum())

    def j_stage(ctx):
        if ctx.is_init_step:
            ctx.put_obj("acc", jnp.zeros((), jnp.float64))
        ctx.put_obj("acc", ctx.get_obj("acc") + jnp.abs(ctx.get_obj("X")).sum())

    def t_stage(ctx):
        if ctx.is_init_step:
            ctx.put_obj("acc", torch.zeros((), dtype=torch.float64))
        ctx.put_obj("acc", ctx.get_obj("acc") + ctx.get_obj("X").abs().sum())

    stop_at = limit * s / 40.0
    rj, rt = _both(
        jenv, tenv,
        lambda q: q.init_with_partitioned_data("X", X).add(j_stage)
        .set_compare_criterion(lambda c: c.get_obj("acc") >= stop_at),
        lambda q: q.init_with_partitioned_data("X", X).add(t_stage)
        .set_compare_criterion(lambda c: c.get_obj("acc") >= stop_at))
    assert rj.step_count == rt.step_count
    _same(rj.get("acc"), rt.get("acc"))
    if limit == 0.0:
        assert rt.step_count == 1


def test_broadcast_data_and_all_reduce_stage(jenv, tenv):
    """Broadcast data are read as they are; an all-reduce inside the
    stage keeps the one worker's values."""
    def j_stage(ctx):
        if ctx.is_init_step:
            ctx.put_obj("y", jnp.zeros(X.shape[0]))
        y = ctx.get_obj("y") + ctx.get_obj("X") @ ctx.get_obj("w")
        ctx.put_obj("y", ctx.all_reduce_sum(y))
        ctx.put_obj("n", ctx.all_reduce_sum(
            jnp.asarray(ctx.get_obj("__total_X"), jnp.float64)))

    def t_stage(ctx):
        if ctx.is_init_step:
            ctx.put_obj("y", torch.zeros(X.shape[0], dtype=torch.float64))
        y = ctx.get_obj("y") + ctx.get_obj("X") @ ctx.get_obj("w")
        ctx.put_obj("y", ctx.all_reduce_sum(y))
        ctx.put_obj("n", ctx.all_reduce_sum(torch.tensor(
            float(ctx.get_obj("__total_X")), dtype=torch.float64)))

    rj, rt = _both(
        jenv, tenv,
        lambda q: q.init_with_partitioned_data("X", X)
        .init_with_broadcast_data("w", W).add(j_stage),
        lambda q: q.init_with_partitioned_data("X", X)
        .init_with_broadcast_data("w", W).add(t_stage))
    _same(rj.get("y"), rt.get("y"))
    _same(rj.get("n"), rt.get("n"))
    assert float(rt.get("n")) == X.shape[0]


def test_close_with(jenv, tenv):
    def j_stage(ctx):
        ctx.put_obj("last", jnp.asarray(ctx.step_no, jnp.int32))

    def t_stage(ctx):
        ctx.put_obj("last", torch.tensor(ctx.step_no, dtype=torch.int32))

    got_j = JQueue(env=jenv, max_iter=4).add(j_stage).close_with(
        lambda r: ("closed", int(r.get("last")))).exec()
    got_t = IterativeComQueue(env=tenv, max_iter=4).add(t_stage).close_with(
        lambda r: ("closed", int(r.get("last")))).exec()
    assert got_j == got_t == ("closed", 4)


def test_collectives_are_identities_at_one_worker(tenv):
    x = torch.arange(6.0).reshape(2, 3)
    for fn in (manifest_psum, manifest_pmax, manifest_pmin):
        assert fn(x, "d", name="t") is x
    with pytest.raises(NotImplementedError):
        manifest_psum(x, "d", num_workers=2)

    def stage(ctx):
        ctx.put_obj("v", ctx.all_reduce_sum(x))
    res = IterativeComQueue(env=tenv, max_iter=1).add(stage).exec()
    _same(res.get("v"), x.numpy())


def test_freeze_config_matches_jax():
    from dataclasses import dataclass

    @dataclass
    class P:
        a: int = 3
        b: float = 0.5
    cfg = {"k": [1, 2.5, "s"], "arr": np.arange(4), "big": np.zeros(300),
           "p": P(), 1: None}
    assert freeze_config(cfg) == jfreeze(cfg)


def test_rng_is_seeded_by_queue_step_and_task(tenv):
    """Same seed, same draws; another step or seed, other draws."""
    def stage(ctx):
        ctx.put_obj(f"u{ctx.step_no}", torch.rand(5, generator=ctx.rng()))

    def run(seed):
        return IterativeComQueue(env=tenv, max_iter=2, seed=seed).add(
            stage).exec()
    a, b, c = run(1), run(1), run(2)
    _same(a.get("u1"), b.get("u1"))
    _same(a.get("u2"), b.get("u2"))
    assert not np.array_equal(a.get("u1"), a.get("u2"))
    assert not np.array_equal(a.get("u1"), c.get("u1"))


def test_left_out_features_raise(tenv, monkeypatch):
    """More than one worker is not ported; a resume request without a
    checkpoint directory is refused (checkpoints and boundary hooks are
    ported: tests/test_torch_recovery.py; the health monitor attaches:
    tests/test_torch_health.py)."""
    q = IterativeComQueue(env=tenv)
    assert q.set_health(None) is q
    with pytest.raises(NotImplementedError):
        MLEnvironment(parallelism=2, device="cpu")
    with pytest.raises(ValueError, match="requires checkpoint_dir"):
        IterativeComQueue(env=tenv, resume_from="x")
    assert q.set_program_key(("any", 1)) is q   # names the program only


def test_default_env_is_the_card(monkeypatch):
    """Without a device the session resolves ``cuda``, and raises where
    there is none; ``use_local_env(device="cpu")`` runs on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    MLEnvironmentFactory.reset()
    try:
        with pytest.raises(RuntimeError, match="CUDA"):
            IterativeComQueue(max_iter=1).add(lambda c: None).exec()
        env = use_local_env(device="cpu")
        assert MLEnvironmentFactory.get_default() is env
        assert env.num_workers == 1 and env.device == torch.device("cpu")
        res = IterativeComQueue(max_iter=2).add(
            lambda c: c.put_obj("s", torch.tensor(c.step_no))).exec()
        assert int(res.get("s")) == 2
    finally:
        MLEnvironmentFactory.reset()


def test_all_reduce_and_probe_series_of_the_engine(jenv, tenv):
    """``AllReduce`` (sum, max, min, mean) is the identity at one worker,
    as the JAX package's at one device; a probe series is float32, NaN
    before its first write, trimmed to the run."""
    def stages(lib):
        def stage(ctx):
            v = (jnp if lib == "jax" else torch).arange(4.0) * ctx.step_no
            for k in ("s", "mx", "mn", "avg"):
                ctx.put_obj(k, v)
            ctx.probe("step", v[1])
            ctx.probe_nonfinite("v", v / (v - 2.0 * ctx.step_no))
        return stage
    out = {}
    for lib, Q, A, env in (("jax", JQueue, JAllReduce, jenv),
                           ("torch", IterativeComQueue, AllReduce, tenv)):
        q = (Q(env=env, max_iter=3).add(stages(lib)).add(A("s"))
             .add(A("mx", op="max")).add(A("mn", op="min"))
             .add(A("avg", mean=True)))
        r = q.exec()
        out[lib] = r
    for k in ("s", "mx", "mn", "avg"):
        np.testing.assert_array_equal(np.asarray(out["torch"].get(k)),
                                      np.asarray(out["jax"].get(k))[:4])
    for name in ("step", "nonfinite.v"):
        j = out["jax"].probe_series(name)
        t = out["torch"].probe_series(name)
        np.testing.assert_array_equal(t, j)
        assert t.dtype == np.float32
    full = out["torch"].probe_series("step", trim=False)
    assert full.shape == (3,)
    with pytest.raises(ValueError):
        AllReduce()
    with pytest.raises(ValueError):
        AllReduce("x", op="prod")
    with pytest.raises(ValueError):
        AllReduce("x", op="max", mean=True)


def test_probe_nan_prefill_and_init_pass_rule(tenv):
    """A series is NaN past the supersteps that wrote it; a probe first
    recorded after the init pass raises, as in the JAX package."""
    def stage(ctx):
        if ctx.step_no == 2:
            ctx.probe("late", 1.0)
    with pytest.raises(KeyError):
        IterativeComQueue(env=tenv, max_iter=3).add(stage).exec()
    r = IterativeComQueue(env=tenv, max_iter=5).add(
        lambda c: c.probe("x", float(c.step_no))).set_compare_criterion(
        lambda c: c.step_no == 3).exec()
    full = r.probe_series("x", trim=False)
    np.testing.assert_array_equal(full[:3], [1.0, 2.0, 3.0])
    assert np.isnan(full[3:]).all() and r.probe_series("x").shape == (3,)
