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
kernel itself runs only on the card). The small path's order is
emulated on the host block by block (each block's keys k % G, its
positions in order, its runs by local key k / G) and held to the plain
version, at Word2Vec's real key layout too: 256 Huffman paths padded
with inner node 0, whose plain scatter is held to the JAX package's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alink_tpu.operator.common.nlp.word2vec import \
    build_huffman as jax_build_huffman
from alink_tpu_torch.kernels import rows as kr
from alink_tpu_torch.kernels.ftrl import scatter_add_rows_plain
from alink_tpu_torch.kernels.linear import run_plan_plain
from alink_tpu_torch.operator.common.nlp.word2vec import build_huffman


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


@pytest.mark.parametrize("sms,M,blocks", [(132, 1, 1), (132, 8, 1),
                                          (132, 9, 2), (132, 256, 32),
                                          (132, 3840, 480),
                                          (132, 8000, 1000),
                                          (132, 4_000_000, 1056)])
def test_walk_blocks(sms, M, blocks):
    assert kr.walk_blocks(sms, M) == blocks


@pytest.mark.parametrize("sms,M,S,ncg,blocks", [(132, 1, 7, 1, 1),
                                                (132, 16, 30_000, 1, 30),
                                                (132, 256, 4541, 4, 64),
                                                (132, 3840, 4540, 4, 132),
                                                (132, 3840, 4540, 1, 132),
                                                (132, 11_264, 65_536, 1, 132),
                                                (132, 100, 1 << 20, 1, 1024),
                                                (132, 100, 1 << 20, 2, 2048),
                                                (16, 3840, 4540, 4, 20),
                                                (132, 3840, 4540, 157, 785)])
def test_small_blocks(sms, M, S, ncg, blocks):
    """``ncg`` blocks a key set, the sets as many as the SMs hold, at
    least 16 positions a set, no set past 1,024 keys."""
    got = kr.small_blocks(sms, M, S, ncg)
    assert got == blocks and got % ncg == 0
    assert -(-S // (got // ncg)) <= 1024     # csrc/row_scatter.cu kMaxLocalKeys


@pytest.mark.parametrize("C,split", [(1, (2, 1, 1)), (4, (2, 1, 4)),
                                     (5, (2, 1, 5)), (8, (2, 1, 8)),
                                     (9, (2, 1, 9)), (12, (2, 1, 12)),
                                     (16, (2, 1, 16)), (17, (1, 1, 17)),
                                     (20, (1, 1, 20)), (32, (1, 1, 32)),
                                     (33, (1, 2, 17)), (65, (1, 3, 22)),
                                     (100, (1, 4, 25))])
def test_lane_split(C, split):
    assert kr.lane_split(C) == split


@pytest.mark.parametrize("M,S,small", [(3840, 4540, True),
                                       (3840, 1 << 18, True),
                                       (3840, (1 << 18) + 1, False),
                                       (11_264, 4540, True),
                                       (11_265, 4540, False)])
def test_one_launch_bounds(M, S, small):
    """The one launch takes at most SMALL_MAX keys over at most
    SMALL_MAX_ROWS rows; the plan's path takes the rest."""
    assert kr._small(M, S) is small


def test_lane_split_is_what_the_kernel_takes():
    """csrc/row_scatter.cu::valid_split: q in {1, 2}, a group's
    columns fit its 32 / q lanes, and the ncg groups cover C with no
    empty group."""
    for C in range(1, 400):
        q, ncg, cw = kr.lane_split(C)
        assert q in (1, 2) and 1 <= cw <= 32 // q
        assert ncg * cw >= C > (ncg - 1) * cw


def _small_path_walk(state, keys, terms, G, threads=256):
    """The small path's order on the host, key set by key set (each set's
    blocks sort alike and walk one column group each): set b sorts its
    positions (keys k with k % G == b) by local key k // G with the
    kernel's counting sort over each warp's chunk of positions (each
    warp's counts; a key's run starts at the sum of the counts of the
    keys before it, a warp's cursor after the earlier warps' counts of
    it; each warp places its chunk in order), then walks each run from
    its stored row, one rounded add a column a position."""
    S, M = state.shape[0], keys.shape[0]
    R = -(-S // G)
    warps = threads // 32
    chunk = -(-M // threads) * 32
    out = state.copy()
    seen = np.zeros(M, bool)
    for b in range(G):
        counts = np.zeros((warps, R), np.int64)
        own = [np.nonzero(keys[w * chunk:(w + 1) * chunk] % G == b)[0]
               + w * chunk for w in range(warps)]
        for w in range(warps):
            np.add.at(counts[w], keys[own[w]] // G, 1)
        total = counts.sum(0)
        starts = np.concatenate([[0], np.cumsum(total)])
        cursor = starts[:-1] + np.cumsum(counts, 0) - counts
        placed = np.full(int(total.sum()), -1)
        for w in range(warps):
            for pos in own[w]:
                k = keys[pos] // G
                placed[cursor[w, k]] = pos
                cursor[w, k] += 1
        assert (placed >= 0).all()
        for k in np.nonzero(total)[0]:
            key = k * G + b
            run = placed[starts[k]:starts[k + 1]]
            assert (keys[run] == key).all() and (np.diff(run) > 0).all()
            acc = out[key].copy()
            for pos in run:
                acc = acc + terms[pos]
            out[key] = acc
        seen[placed] = True
    assert seen.all()
    return out


def _huffman_out_keys(V, batch, seed, start=0):
    """Word2Vec's `out` keys of one batch: the Huffman paths (padded with
    inner node 0 to the longest) of ``batch`` context words drawn from a
    seeded Zipf count vector over ``V`` words, flattened."""
    rng = np.random.default_rng(seed)
    counts = np.sort(rng.zipf(1.2, V).clip(max=10 ** 6))[::-1]
    points = build_huffman(counts.tolist())[0]
    assert np.array_equal(points, jax_build_huffman(counts.tolist())[0])
    p = counts / counts.sum()
    words = rng.choice(V, start + batch, p=p)[start:]
    return points[words].reshape(-1).astype(np.int32), points.shape[1], V - 1


@pytest.mark.parametrize("M,S,C,sms", [(1, 7, 3, 132), (256, 4541, 4, 132),
                                       (3840, 4540, 3, 132), (500, 37, 1, 3),
                                       (700, 30_000, 33, 132),
                                       (11_264, 65_536, 2, 132)])
def test_small_path_order_is_the_plain_version(M, S, C, sms):
    """The small path's block order gives the plain version's bits, with
    keys at 0 and at S - 1 (the key ownership's edges)."""
    ncg = kr.lane_split(C)[1]
    G = kr.small_blocks(sms, M, S, ncg) // ncg
    rng = np.random.default_rng(M + C)
    keys = (rng.zipf(1.3, M) % S).astype(np.int32)
    keys[:: 5] = 0
    keys[1:: 7] = S - 1
    state = rng.standard_normal((S, C)).astype(np.float32)
    terms = rng.standard_normal((M, C)).astype(np.float32)
    want = kr.scatter_rows_plain(torch.from_numpy(state.copy()),
                                 torch.from_numpy(keys),
                                 torch.from_numpy(terms)).numpy()
    got = _small_path_walk(state, keys, terms, G)
    assert np.array_equal(_bits(got), _bits(want))


def test_small_path_one_run():
    """Every key equal: one block owns the one run, in position order."""
    S, M, C = 100, 2000, 5
    keys = np.full(M, 42, np.int32)
    rng = np.random.default_rng(3)
    state = rng.standard_normal((S, C))
    terms = rng.standard_normal((M, C))
    want = kr.scatter_rows_plain(torch.from_numpy(state.copy()),
                                 torch.from_numpy(keys),
                                 torch.from_numpy(terms)).numpy()
    got = _small_path_walk(state, keys, terms, 7)
    assert np.array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("seed,start", [(0, 0), (1, 256), (2, 25_600)])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_plain_bitwise_at_word2vec_out_layout(dtype, seed, start):
    """Word2Vec's `out` scatter at its real key layout (256 padded Huffman
    paths, the long run at key 0, the root's 256 at the top inner node):
    the plain version bitwise to the JAX package's ``.at[].add`` and to
    the small path's block order at its grid over 132 SMs."""
    keys, L, S = _huffman_out_keys(4541, 256, seed, start)
    runs = np.bincount(keys, minlength=S)
    assert runs[0] == runs.max() > 256 and runs[S - 1] == 256
    D = 100
    rng = np.random.default_rng(seed + 7)
    state = rng.standard_normal((S, D)).astype(dtype)
    terms = (rng.standard_normal((keys.shape[0], D)) * 1e-2).astype(dtype)
    want = np.asarray(jnp.asarray(state).at[jnp.asarray(keys)].add(
        jnp.asarray(terms)))
    got = kr.scatter_rows_plain(torch.from_numpy(state.copy()),
                                torch.from_numpy(keys),
                                torch.from_numpy(terms)).numpy()
    assert np.array_equal(_bits(got), _bits(want))
    ncg = kr.lane_split(D)[1]
    G = kr.small_blocks(132, keys.shape[0], S, ncg) // ncg
    assert np.array_equal(_bits(_small_path_walk(state, keys, terms, G)),
                          _bits(want))
