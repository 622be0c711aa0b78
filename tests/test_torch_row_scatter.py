"""Slice 18 of the port: the ordered row scatter-add ("P3") on the CPU.

``kernels/rows.py::scatter_rows`` adds wide rows into a state in order:
Word2Vec's ``.at[].add`` of its embedding rows, FM's sparse gradient and
LDA's ``segment_sum``. Its plain version, which the CPU path runs and
``chip_smoke.py`` holds the CUDA kernel to on the card, must give the
JAX package's bits: bitwise against ``jnp.ndarray.at[].add`` and
``jax.ops.segment_sum`` on duplicate-heavy keys, float32 and float64, at
C in {1, 3, 12, 100} columns; and against a Python loop of the contract.
The plain version is ``index_add_``, ordered on the CPU: it is also held
bitwise to ``kernels/ftrl.py::scatter_add_rows_plain``'s rounds, which
keep the order on any device. The wrapper's CPU path is the plain
version, it keeps the bits of rows no key names, the kernel's order
(runs of the stably sorted keys, each in position order) gives the plain
version's bits, and the launch sizing helpers are checked here (the
kernel itself runs only on the card).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alink_tpu_torch.kernels import rows as kr
from alink_tpu_torch.kernels.ftrl import scatter_add_rows_plain
from alink_tpu_torch.kernels.linear import run_plan_plain


def _bits(a):
    a = np.ascontiguousarray(a)
    return a.view(np.int64 if a.dtype == np.float64 else np.int32)


def _case(dtype, C, S=37, M=500, seed=0):
    rng = np.random.default_rng(seed + C)
    # duplicate-heavy keys: a hot key, a Zipf tail, and rows no key names
    keys = (rng.zipf(1.5, M) % (S - 3)).astype(np.int32)
    keys[::7] = 5
    state = rng.standard_normal((S, C)).astype(dtype)
    state[-1] = -0.0
    terms = (rng.standard_normal((M, C)) * 10.0 ** rng.integers(
        -3, 4, (M, 1))).astype(dtype)
    return keys, state, terms


@pytest.mark.parametrize("C", [1, 3, 12, 100])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_plain_bitwise_vs_jax_at_add(dtype, C):
    keys, state, terms = _case(dtype, C)
    want = np.asarray(jnp.asarray(state).at[jnp.asarray(keys)].add(
        jnp.asarray(terms)))
    got = kr.scatter_rows_plain(torch.from_numpy(state.copy()),
                                torch.from_numpy(keys),
                                torch.from_numpy(terms)).numpy()
    assert got.dtype == want.dtype
    assert np.array_equal(_bits(got), _bits(want))
    assert _bits(got[-1]).tolist() == _bits(state[-1]).tolist()


@pytest.mark.parametrize("C", [1, 3, 12, 100])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_plain_bitwise_vs_jax_segment_sum(dtype, C):
    keys, state, terms = _case(dtype, C, seed=1)
    S = state.shape[0]
    want = np.asarray(jax.ops.segment_sum(jnp.asarray(terms),
                                          jnp.asarray(keys),
                                          num_segments=S))
    got = kr.scatter_rows_plain(torch.zeros((S, C), dtype=torch.from_numpy(
        terms).dtype), torch.from_numpy(keys), torch.from_numpy(terms))
    assert np.array_equal(_bits(got.numpy()), _bits(want))


def test_plain_is_the_contract_loop():
    keys, state, terms = _case(np.float32, 3, S=9, M=60)
    want = state.copy()
    for m in range(keys.shape[0]):
        for c in range(3):
            want[keys[m], c] = np.float32(want[keys[m], c] + terms[m, c])
    got = kr.scatter_rows(torch.from_numpy(state.copy()),
                          torch.from_numpy(keys), torch.from_numpy(terms))
    assert np.array_equal(_bits(got.numpy()), _bits(want))


@pytest.mark.parametrize("C", [1, 12, 100])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_plain_bitwise_vs_ordered_rounds(dtype, C):
    """``index_add_`` on the CPU adds in position order: bitwise to the
    device-independent rounds at a size the CPU splits over threads."""
    rng = np.random.default_rng(C)
    S, M = 300, 50_000
    keys = torch.from_numpy((rng.zipf(1.3, M) % S).astype(np.int32))
    state = torch.from_numpy(rng.standard_normal((S, C)).astype(dtype))
    terms = torch.from_numpy((rng.standard_normal((M, C)) * 10.0 ** rng
                              .integers(-3, 4, (M, 1))).astype(dtype))
    got = kr.scatter_rows_plain(state.clone(), keys, terms)
    want = scatter_add_rows_plain(state.clone(), keys, terms)
    assert torch.equal(got, want)


def test_columns_are_independent_chains():
    """C columns in one call are bitwise the C one-column scatters (FM's
    gradient sends gw, sq_c and gV through one call)."""
    keys, state, terms = _case(np.float64, 12, seed=2)
    whole = kr.scatter_rows(torch.from_numpy(state.copy()),
                            torch.from_numpy(keys), torch.from_numpy(terms))
    for c in range(12):
        one = kr.scatter_rows(torch.from_numpy(state[:, c:c + 1].copy()),
                              torch.from_numpy(keys),
                              torch.from_numpy(terms[:, c:c + 1].copy()))
        assert np.array_equal(_bits(one.numpy()[:, 0]),
                              _bits(whole.numpy()[:, c]))


def test_cpu_path_in_place_and_bad_keys():
    keys, state, terms = _case(np.float64, 3)
    st = torch.from_numpy(state.copy())
    assert kr.scatter_rows(st, torch.from_numpy(keys),
                           torch.from_numpy(terms)) is st
    assert kr.row_plan(torch.from_numpy(keys), state.shape[0]) is None
    bad = keys.copy()
    bad[3] = state.shape[0]
    with pytest.raises(IndexError):
        kr.scatter_rows(st, torch.from_numpy(bad), torch.from_numpy(terms))
    assert kr.launch_counts() == {"row_scatter": 0}


@pytest.mark.parametrize("M,S", [(1, 7), (256, 30_000), (3840, 29_999),
                                 (20_000, 500)])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_plan_walk_is_the_plain_version(dtype, M, S):
    """The kernel's order, emulated on the host: the run plan of the keys
    (``run_plan_plain``, what the card's plan is held to; the one block
    sorts the keys just as stably), its runs in the plan's order, each
    run's terms added to its stored row in position order, one rounded
    add a column, gives the plain version's bits, at Word2Vec's batch
    sizes (256 centre rows, 256 x 15 path rows, the one-block path on the
    card) and above :data:`SMALL_MAX` (the plan's path)."""
    rng = np.random.default_rng(M)
    keys = (rng.zipf(1.3, M) % S).astype(np.int32)
    state = rng.standard_normal((S, 4)).astype(dtype)
    terms = rng.standard_normal((M, 4)).astype(dtype)
    plan = run_plan_plain(torch.from_numpy(keys), S)
    perm, starts, order, slots = (t.numpy() for t in plan[:4])
    walked = state.copy()
    for r in order[:int(plan.counts[0])]:
        acc = walked[slots[r]].copy()
        for j in range(starts[r], starts[r + 1]):
            acc = acc + terms[perm[j]]
        walked[slots[r]] = acc
    want = kr.scatter_rows_plain(torch.from_numpy(state.copy()),
                                 torch.from_numpy(keys),
                                 torch.from_numpy(terms)).numpy()
    assert np.array_equal(_bits(walked), _bits(want))


@pytest.mark.parametrize("size,passes", [(1, 1), (2, 1), (256, 1), (257, 2),
                                         (30000, 2), (65537, 3),
                                         (1 << 24, 3), ((1 << 24) + 1, 4)])
def test_sort_passes(size, passes):
    assert kr.sort_passes(size) == passes


@pytest.mark.parametrize("sms,M,blocks", [(132, 1, 1), (132, 8, 1),
                                          (132, 9, 2), (132, 256, 32),
                                          (132, 3840, 480),
                                          (132, 8000, 1000),
                                          (132, 4_000_000, 1056)])
def test_walk_blocks(sms, M, blocks):
    assert kr.walk_blocks(sms, M) == blocks
