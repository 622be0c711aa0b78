"""The ordered sparse gradient of linear training (``kernels/linear.py``)
on the CPU: its plain version, its plan and the margins.

The contract is a Python loop: ``grad[keys[i, k]] += val[i, k] * c[i]``
over the positions in flattened (row, column) order, from ``+0.0``. The
plain version (``index_add_`` on the CPU) is held to that loop bit for
bit, and to the JAX package's padded-COO gradient (an XLA scatter-add)
bit for bit. The kernel itself is held to the plain version on the card
by ``chip_smoke.py`` phase 12. Here also: the plan's classes of runs
(heavy, medium, short) against a numpy reference, the card's plan
(``csrc/run_plan.cu``) step by step in numpy against the plain plan, the
launch's grid, the kernel's division by the row width, and what reaches
the C function.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from alink_tpu_torch.kernels import _build
from alink_tpu_torch.kernels import linear as kl

DTYPES = {"f32": (np.float32, torch.float32), "f64": (np.float64, torch.float64)}


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int64) if a.dtype == np.float64 else a.view(np.int32)


def _design(layout, dt, seed=0):
    """Keys, values and c of a small design: padded-COO (an intercept at
    slot 0 in every row, padding at slot 1 with value 0, a few slots left
    unhit) or field-blocked (one key per field, field 0 the intercept)."""
    rng = np.random.RandomState(seed)
    n = 300
    if layout == "coo":
        dim, w = 64, 9
        keys = rng.randint(2, dim - 5, (n, w)).astype(np.int32)
        keys[:, 0] = 0
        val = rng.randn(n, w).astype(dt)
        val[:, 0] = 1.0
        pad = rng.rand(n, w) < 0.2
        pad[:, 0] = False
        keys[pad] = 1
        val[pad] = 0.0
    else:
        F, S = 5, 16
        dim, w = F * S, F
        keys = (rng.randint(0, S, (n, F)) + np.arange(F) * S).astype(np.int32)
        keys[:, 0] = 0
        val = np.ones((n, F), dt)
    c = rng.randn(n).astype(dt)
    c[3] = -0.0
    return keys, val, c, dim


def _heavy_design(dt, seed=0):
    """Runs of every class in one design: slot 0 in every row (the
    intercept, heavy), slots 1 and 2 of equal heavy length, slot 3 exactly
    ``HEAVY_MIN`` long, slot 4 one short of it, slot 5 ``SHORT_MAX + 1``
    long, slot 6 ``SHORT_MAX`` long; the rest short and random."""
    H, S = kl.HEAVY_MIN, kl.SHORT_MAX
    rng = np.random.RandomState(seed)
    n, dim = 2 * H + 600, 4096
    keys = rng.randint(7, dim, (n, 4)).astype(np.int32)
    keys[:, 0] = 0
    rows = np.arange(n)
    keys[rows % 2 == 0, 1] = 1
    keys[rows % 2 == 1, 1] = 2
    keys[:H, 2] = 3
    keys[H:2 * H - 1, 2] = 4
    keys[2 * H:2 * H + S + 1, 3] = 5
    keys[2 * H + S + 1:2 * H + 2 * S + 1, 3] = 6
    val = rng.randn(n, 4).astype(dt)
    c = rng.randn(n).astype(dt)
    return keys, val, c, dim


def _loop(keys, val, c, dim):
    out = np.zeros(dim, val.dtype)
    for i in range(keys.shape[0]):
        for k in range(keys.shape[1]):
            out[keys[i, k]] = out[keys[i, k]] + val[i, k] * c[i]
    return out


@pytest.mark.parametrize("layout", ["coo", "fieldblock", "heavy"])
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_plain_is_the_sequential_loop(layout, dt):
    npd, tdt = DTYPES[dt]
    keys, val, c, dim = (_heavy_design(npd) if layout == "heavy"
                         else _design(layout, npd))
    plan = kl.grad_plan(torch.from_numpy(keys), dim, torch.from_numpy(val))
    got = kl.linear_grad(plan, torch.from_numpy(c)).numpy()
    assert got.dtype == npd
    np.testing.assert_array_equal(_bits(got), _bits(_loop(keys, val, c, dim)))


def test_plan_runs_intercept_and_unhit_slots():
    """The runs are the distinct keys in key order, each listing its
    positions in ascending order; the intercept's run is every row's
    first position; a slot no key names has no run and a +0.0
    gradient."""
    keys, val, c, dim = _design("coo", np.float64)
    plan = kl.grad_plan(torch.from_numpy(keys), dim, torch.from_numpy(val))
    walk = plan.walk
    runs = kl.plan_counts(walk)[0]
    starts, perm = walk.starts.numpy(), walk.perm.numpy()
    slots = walk.slots.numpy()[:runs]
    flat = keys.reshape(-1)
    np.testing.assert_array_equal(slots, np.unique(flat))
    assert starts[0] == 0 and starts[runs] == flat.size
    for r, s in enumerate(slots):
        run = perm[starts[r]:starts[r + 1]]
        np.testing.assert_array_equal(run, np.flatnonzero(flat == s))
    n, w = keys.shape
    assert slots[0] == 0
    np.testing.assert_array_equal(perm[starts[0]:starts[1]],
                                  np.arange(n) * w)
    unhit = np.setdiff1d(np.arange(dim), flat)
    assert unhit.size >= 5
    got = kl.linear_grad(plan, torch.from_numpy(c)).numpy()
    assert (_bits(got[unhit]) == 0).all()              # +0.0


@pytest.mark.parametrize("layout", ["coo", "fieldblock", "heavy"])
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_plan_walk_is_the_plain_bits(layout, dt):
    """The kernel's walk of the shared run plan, in Python: each run from
    +0.0, its positions' rounded products in order, stored at its slot of
    a zeroed vector, gives the plain version's bits."""
    npd, _ = DTYPES[dt]
    keys, val, c, dim = (_heavy_design(npd) if layout == "heavy"
                         else _design(layout, npd))
    plan = kl.grad_plan(torch.from_numpy(keys), dim, torch.from_numpy(val))
    walk = plan.walk
    runs = kl.plan_counts(walk)[0]
    perm, starts = walk.perm.numpy(), walk.starts.numpy()
    slots, order = walk.slots.numpy(), walk.order.numpy()[:runs]
    assert sorted(order) == list(range(runs))
    width = keys.shape[1]
    fv = val.reshape(-1)
    out = np.zeros(dim, npd)
    for r in order:
        acc = npd(0)
        for p in perm[starts[r]:starts[r + 1]]:
            acc = acc + fv[p] * c[p // width]
        out[slots[r]] = acc
    want = kl.linear_grad(plan, torch.from_numpy(c)).numpy()
    np.testing.assert_array_equal(_bits(out), _bits(want))


def _classes(keys):
    """The numpy reference of the plan's run classes, as the runs' slots:
    the runs of more than ``SHORT_MAX`` terms by length, longest first,
    ties by slot, then the short runs by slot; the heavy and medium
    counts."""
    slots, counts = np.unique(keys, return_counts=True)
    order = slots[np.lexsort((slots,
                              np.where(counts > kl.SHORT_MAX, -counts, 0)))]
    n_heavy = int((counts >= kl.HEAVY_MIN).sum())
    n_medium = int(((counts > kl.SHORT_MAX) & (counts < kl.HEAVY_MIN)).sum())
    return order, n_heavy, n_medium


def _class_case(case):
    H, S = kl.HEAVY_MIN, kl.SHORT_MAX
    rng = np.random.RandomState(3)
    if case == "every_class":
        return _heavy_design(np.float64)[0], 4096
    if case == "equal_heavy":       # four heavy runs of one length: by slot
        keys = np.tile(np.array([[9, 2, 30, 5]], np.int32), (H + 3, 1))
        return keys, 40
    if case == "threshold":         # exactly HEAVY_MIN, one short of it
        keys = np.concatenate([np.full(H, 6), np.full(H - 1, 2),
                               np.full(S + 1, 0), np.full(S, 7)])
        return keys.astype(np.int32)[:, None], 8
    if case == "no_heavy":          # the field-blocked bulk: no intercept
        keys = (rng.randint(0, 16, (3000, 5)) + np.arange(5) * 16)
        return keys.astype(np.int32), 80
    keys = np.zeros((H, 2), np.int32)   # dim_below_grid: 3 slots, one run
    return keys, 3


@pytest.mark.parametrize("case", ["every_class", "equal_heavy", "threshold",
                                  "no_heavy", "dim_below_grid"])
def test_plan_classes_runs_by_length(case):
    """``order`` lists the runs of more than ``SHORT_MAX`` terms by length,
    longest first and ties by slot, then the short ones by slot; the first
    ``n_heavy`` have at least ``HEAVY_MIN`` terms, the next ``n_medium``
    more than ``SHORT_MAX``; a run exactly at a threshold takes the longer
    class, one short of it the shorter."""
    keys, dim = _class_case(case)
    walk = kl.grad_plan(torch.from_numpy(keys), dim,
                        torch.ones(keys.shape, dtype=torch.float64)).walk
    order, n_heavy, n_medium = _classes(keys)
    assert walk.order.dtype == walk.slots.dtype == torch.int32
    runs_, heavy_, medium_, short_ = kl.plan_counts(walk)
    by_run = walk.order.numpy()[:runs_]
    np.testing.assert_array_equal(walk.slots.numpy()[by_run], order)
    assert (heavy_, medium_) == (n_heavy, n_medium)
    assert short_ == runs_ - n_heavy - n_medium
    runs = np.diff(walk.starts.numpy()[:runs_ + 1])[by_run]
    assert (runs[:n_heavy] >= kl.HEAVY_MIN).all()
    assert (runs[n_heavy:n_heavy + n_medium] > kl.SHORT_MAX).all()
    assert (runs[n_heavy + n_medium:] <= kl.SHORT_MAX).all()
    want = {"every_class": (4, 2), "equal_heavy": (4, 0),
            "threshold": (1, 2), "no_heavy": (0, 80),
            "dim_below_grid": (1, 0)}[case]
    assert (n_heavy, n_medium) == want
    if case == "equal_heavy":
        np.testing.assert_array_equal(order[:4], [2, 5, 9, 30])
    if case == "threshold":
        np.testing.assert_array_equal(order, [6, 2, 0, 7])
    short = by_run[n_heavy + n_medium:]
    assert (np.diff(short) > 0).all()


def _radix_pass(kin, vin, n, chunk, blocks, shift, bits, flip=0):
    """One pass of ``csrc/run_plan.cu::radix_pass`` in numpy over ``n``
    (key, value) pairs, the digit that of ``flip - key`` when ``flip``:
    count (each block's chunk of ``chunk`` pairs, each of its 16 warps
    counting its part's digits; the block's counts into a digit-major
    histogram), scan (each digit's column over the blocks, exclusive, and
    the digit's total) and place (the block's cursor of a digit is the
    exclusive sum of the totals plus its column entry; each tile of 8192
    pairs: warp w ranks its 512 pairs by digit in its own column, a pair's
    place in the tile is the tile's start of its digit, the earlier
    warps' count of it and its rank; the staged tile is written out in
    order at each digit's cursor, which then moves past the tile's pairs
    of that digit). Returns the keys (flipped) and values."""
    D = 1 << bits
    key = flip - kin if flip else kin
    dig = (key >> shift) & (D - 1)
    part = -(-chunk // 512) * 32
    hist = np.zeros((D, blocks), np.int64)
    for b in range(blocks):
        lo, hi = min(n, b * chunk), min(n, b * chunk + chunk)
        for w in range(16):
            a, z = min(hi, lo + w * part), min(hi, lo + w * part + part)
            hist[:, b] += np.bincount(dig[a:z], minlength=D)
    col = np.cumsum(hist, 1) - hist
    tot = hist.sum(1)
    kout, vout = np.full(n, -1), np.full(n, -1)
    for b in range(blocks):
        cursor = np.cumsum(tot) - tot + col[:, b]
        lo, hi = min(n, b * chunk), min(n, b * chunk + chunk)
        for base in range(lo, hi, 8192):
            idx = np.arange(base, min(base + 8192, hi))
            tab = np.zeros((16, D), np.int64)
            rank = np.zeros(idx.size, np.int64)
            for j, i in enumerate(idx):
                w = (i - base) // 512
                rank[j] = tab[w, dig[i]]
                tab[w, dig[i]] += 1
            earlier = np.cumsum(tab, 0) - tab
            n_d = tab.sum(0)
            tstart = np.cumsum(n_d) - n_d
            stage = np.full(idx.size, -1)
            for j, i in enumerate(idx):
                d = dig[i]
                stage[tstart[d] + earlier[(i - base) // 512, d] + rank[j]] = i
            for j, i in enumerate(stage):
                pos = cursor[dig[i]] + j - tstart[dig[i]]
                kout[pos], vout[pos] = key[i], vin[i]
            cursor += n_d
    return kout, vout


def _card_plan(keys, size, sms=132):
    """``csrc/run_plan.cu`` step by step in numpy: the grid of
    ``plan_grid``; the sort (``sort_digits``' passes of
    :func:`_radix_pass` over (key, position)); heads (each block's heads,
    long and heavy heads, a run's class read off the sorted keys at
    ``SHORT_MAX`` and ``HEAVY_MIN - 1`` past its head, and its first
    head); runs (each block's offsets the sums of the blocks' counts
    before it; per tile of 4096 positions, 8 a thread, one exclusive scan
    of the heads and long heads packed in 16-bit halves: starts, slots,
    the long runs compacted with their lengths (the block's last run
    ending at the next block's first head), the short runs placed; one
    long run goes straight to ``order[0]``) and order (up to 1024 long
    runs, each placed by one block at the count of the longer runs and of
    the runs of its length before it; more, the long runs' stable LSD
    sort by ``maxlen - length`` over the blocks, 8 bits a pass, chunks of
    ``ceil(n_long / blocks)``). The arrays past ``runs`` stay -1."""
    H, S = kl.HEAVY_MIN, kl.SHORT_MAX
    flat = keys.reshape(-1).astype(np.int64)
    M = flat.size
    assert 0 <= flat.min() and flat.max() < size
    chunk, blocks = kl.plan_grid(M, sms)
    assert chunk % 512 == 0 and (blocks - 1) * chunk < M <= blocks * chunk
    passes, bits = kl.sort_digits(size)
    sk, perm = flat, np.arange(M)
    for p in range(passes):
        sk, perm = _radix_pass(sk, perm, M, chunk, blocks, p * bits, bits)
    head = np.ones(M, bool)
    head[1:] = sk[1:] != sk[:-1]
    p_all = np.arange(M)
    long_ = np.zeros(M, bool)
    ok = p_all < M - S
    long_[ok] = sk[p_all[ok] + S] == sk[ok]
    heavy = np.zeros(M, bool)
    ok = p_all <= M - H
    heavy[ok] = sk[p_all[ok] + H - 1] == sk[ok]
    blk = []
    for b in range(blocks):
        sl = slice(b * chunk, min(M, (b + 1) * chunk))
        h, lg = head[sl], long_[sl] & head[sl]
        first = b * chunk + int(np.argmax(h)) if h.any() else 2 ** 31 - 1
        blk.append((int(h.sum()), int(lg.sum()), int((lg & heavy[sl]).sum()),
                    first))
    runs = sum(x[0] for x in blk)
    n_long = sum(x[1] for x in blk)
    n_heavy = sum(x[2] for x in blk)
    starts = np.full(M + 1, -1, np.int64)
    slots = np.full(M, -1, np.int64)
    order = np.full(M, -1, np.int64)
    lng = np.full(M // (S + 1) + 1, -1, np.int64)
    llen = np.full(M // (S + 1) + 1, -1, np.int64)
    longest = []
    for b in range(blocks):
        r = sum(x[0] for x in blk[:b])
        q = q0 = sum(x[1] for x in blk[:b])
        nxt = min([x[3] for x in blk[b + 1:]] + [M])
        hi = min(M, (b + 1) * chunk)
        for base in range(b * chunk, hi, 4096):
            for pos in range(base, min(base + 4096, hi)):
                if not head[pos]:
                    continue
                starts[r], slots[r] = pos, sk[pos]
                if long_[pos]:
                    if n_long > 1:
                        lng[q] = r
                    else:
                        order[q] = r
                    q += 1
                else:
                    order[n_long + r - q] = r
                r += 1
        if n_long > 1:
            for j in range(q0, q):
                end = starts[lng[j] + 1] if lng[j] + 1 < r else nxt
                llen[j] = end - starts[lng[j]]
            longest.append(int(llen[q0:q].max(initial=0)))
    starts[runs] = M
    if 1 < n_long <= 1024:
        # block 0 places each long run at the count of the longer ones and
        # of the ones of its length before it
        lens = llen[:n_long]
        for i in range(n_long):
            rank = int((lens > lens[i]).sum() + (lens[:i] == lens[i]).sum())
            order[rank] = lng[i]
    elif n_long > 1:
        maxlen = max(longest)
        opasses, v = 0, maxlen - (S + 1)
        while v > 0:
            opasses += 1
            v >>= 8
        k, rv = llen[:n_long], lng[:n_long]
        ochunk = -(-n_long // blocks)
        for p in range(opasses):
            k, rv = _radix_pass(k, rv, n_long, ochunk, blocks, 8 * p, 8,
                                flip=maxlen if p == 0 else 0)
        order[:n_long] = rv
    return (perm, starts, slots, order,
            np.array([runs, n_heavy, n_long - n_heavy, runs - n_long]))


PLAN_CASES = ("every_class", "coo", "lengths", "straddle", "one_run",
              "all_short", "threshold", "below_one_block", "one_block",
              "above_one_block", "order_rank", "order_blocks", "size_one")


def _plan_case(case):
    """(keys, size, chunk): ``chunk`` the least positions a block takes
    (None: ``PLAN_MIN_CHUNK`` as the kernel has it; 1024, so a small case
    spans several blocks and the long runs' sort several chunks)."""
    H, S = kl.HEAVY_MIN, kl.SHORT_MAX
    rng = np.random.RandomState(11)
    if case in ("below_one_block", "one_block", "above_one_block"):
        M = kl.PLAN_MIN_CHUNK + {"below_one_block": -1, "one_block": 0,
                                 "above_one_block": 1}[case]
        keys = rng.randint(0, 300, M)
        keys[:S + 40] = 7                          # a long run across tiles
        return rng.permutation(keys).astype(np.int32)[:, None], 300, None
    if case == "order_rank":        # 400 long runs of 33 .. 1,232 terms
        lens = S + 1 + rng.randint(0, 1200, 400)
        keys = np.repeat(rng.permutation(1000)[:400], lens)
        keys = np.concatenate([keys, rng.randint(0, 1000, 5000)])
        return rng.permutation(keys).astype(np.int32)[:, None], 1000, 1024
    if case == "order_blocks":      # 1,100 long runs of 33 .. 432 terms
        lens = S + 1 + rng.randint(0, 400, 1100)
        keys = np.repeat(rng.permutation(3000)[:1100], lens)
        keys = np.concatenate([keys, rng.randint(0, 3000, 5000)])
        return rng.permutation(keys).astype(np.int32)[:, None], 3000, 1024
    if case == "size_one":
        return np.zeros((70, 3), np.int32), 1, None
    if case == "every_class":
        return _heavy_design(np.float64)[0], 4096, 1024
    if case == "coo":
        return _design("coo", np.float64)[0], 64, 1024
    if case == "lengths":           # long runs of 33 .. 700 terms: 2 passes
        lens = rng.permutation(np.arange(S + 1, 700, 7))
        keys = np.repeat(np.arange(lens.size) * 3, lens)
        keys = np.concatenate([keys, rng.randint(0, 3 * lens.size, 3000)])
        return (rng.permutation(keys).astype(np.int32)[:, None],
                3 * lens.size, 1024)
    if case == "straddle":          # runs across the chunks of 1024
        keys = np.repeat(np.arange(40), rng.randint(1, 600, 40))
        return keys.astype(np.int32)[:, None], 40, 1024
    if case == "one_run":
        return np.full((H + 5, 3), 2, np.int32), 3, 1024
    if case == "all_short":
        return rng.randint(0, 5000, (2000, 3)).astype(np.int32), 5000, 1024
    keys = np.concatenate([np.full(H, 6), np.full(H - 1, 2),   # threshold
                           np.full(S + 1, 0), np.full(S, 7)])
    return keys.astype(np.int32)[:, None], 8, 1024


@pytest.mark.parametrize("case", PLAN_CASES)
def test_card_plan_algorithm_is_the_plain_plan(case, monkeypatch):
    """The card's plan (``csrc/run_plan.cu``, modelled step by step) equals
    the plain one array by array over the first ``runs`` entries (all of
    ``perm``), and the four counts: at the kernel's one-block threshold
    (``PLAN_MIN_CHUNK`` - 1, at it, + 1), at ``size`` 1, and with blocks
    of at least 1024 positions, so the small cases span several blocks
    and tiles: ``order_rank``'s 400 long runs ordered by rank in one
    block, ``order_blocks``' 1,100 sorted by length over 127 blocks in
    chunks of 9, two 8-bit passes."""
    keys, size, chunk = _plan_case(case)
    if chunk is not None:
        monkeypatch.setattr(kl, "PLAN_MIN_CHUNK", chunk)
    perm, starts, slots, order, counts = _card_plan(keys, size)
    plain = kl.run_plan(torch.from_numpy(keys), size)
    runs = kl.plan_counts(plain)[0]
    np.testing.assert_array_equal(counts, plain.counts.numpy())
    np.testing.assert_array_equal(perm, plain.perm.numpy())
    np.testing.assert_array_equal(starts[:runs + 1],
                                  plain.starts.numpy()[:runs + 1])
    np.testing.assert_array_equal(slots[:runs], plain.slots.numpy()[:runs])
    np.testing.assert_array_equal(order[:runs], plain.order.numpy()[:runs])
    blocks = kl.plan_grid(keys.size, 132)[1]
    if case == "order_rank":
        assert blocks == 128 and counts[1] + counts[2] == 400
    if case == "order_blocks":
        assert blocks == 127 and counts[1] + counts[2] == 1100
    if case in ("below_one_block", "one_block", "size_one"):
        assert blocks == 1
    if case == "above_one_block":
        assert blocks == 2


def test_chip_smoke_plan_edges():
    """The edges ``chip_smoke.py`` phase 14(e) holds the card's plan to:
    one key; one run of every key; keys only at 0 and ``size - 1`` (3
    passes); ``PLAN_MIN_CHUNK`` - 1, + 0 and + 1 keys (one block, one, two)
    with a long run; ``size`` 2^19 in 3 passes with 500 long runs of many
    lengths (ordered by rank in one block; the shapes' 6,559 to 65,537
    long runs take the sort over the blocks). Each plain plan builds."""
    import chip_smoke
    edges = {name: (keys, size) for name, keys, size in
             chip_smoke.plan_edges(kl)}
    assert list(edges) == ["one key", "one run", "keys at 0 and size-1",
                           "PLAN_MIN_CHUNK-1", "PLAN_MIN_CHUNK+0",
                           "PLAN_MIN_CHUNK+1", "size 2^19"]
    counts = {}
    for name, (keys, size) in edges.items():
        plan = kl.run_plan_plain(torch.from_numpy(keys), size)
        counts[name] = kl.plan_counts(plan)
        blocks = kl.plan_grid(keys.size, 132)[1]
        if name.startswith("PLAN_MIN_CHUNK"):
            assert keys.size == kl.PLAN_MIN_CHUNK + int(name[-2:])
            assert blocks == (2 if name.endswith("+1") else 1)
    assert counts["one key"] == (1, 0, 0, 1)
    assert counts["one run"] == (1, 1, 0, 0)
    assert counts["keys at 0 and size-1"][0] == 2
    assert kl.sort_digits(edges["keys at 0 and size-1"][1])[0] == 3
    keys, size = edges["size 2^19"]
    assert size == 1 << 19 and kl.sort_digits(size) == (3, 7)
    assert counts["size 2^19"][1] + counts["size 2^19"][2] == 500


@pytest.mark.parametrize("size,want", [
    (1, (1, 1)), (2, (1, 1)), (512, (1, 9)), (513, (2, 5)),
    (3 * 1648 + 1, (2, 7)),                     # bench_ftrl's stream
    (65_537, (2, 9)),                           # its padded-COO batch
    (40 * 1648, (2, 9)),                        # its field-blocked batch
    ((1 << 20) + 1, (3, 7)),                    # 2^20 hashed + intercept
    (2 ** 31 - 1, (4, 8)),
])
def test_sort_digits(size, want):
    """The card's radix sort: the fewest passes of at most 9 bits that
    cover ``size - 1``, the bits spread evenly."""
    passes, bits = kl.sort_digits(size)
    assert (passes, bits) == want
    assert bits <= 9 and passes * bits >= (size - 1).bit_length()


@pytest.mark.parametrize("M,sms,want", [
    (1, 132, (4096, 1)),
    (4095, 132, (4096, 1)),
    (4096, 132, (4096, 1)),                     # the one-block threshold
    (4097, 132, (4096, 2)),
    (65_536, 132, (4096, 16)),                  # bench_ftrl's stream
    (163_840, 132, (4096, 40)),                 # its batch micro-batches
    (1_086_997, 132, (8704, 125)),              # LDA's corpus
    (3_900_000, 132, (29_696, 132)),            # FM's design
    (6_600_000, 132, (50_176, 132)),            # field-blocked L-BFGS
    (2 ** 31 - 1, 132, (16_269_312, 132)),
    (10_000, 1, (10_240, 1)),
    (163_840, 16, (10_240, 16)),
])
def test_plan_grid(M, sms, want):
    """The card's plan is one cooperative launch of blocks of a multiple
    of 512 positions (the kernel's threads), at least ``PLAN_MIN_CHUNK``,
    at most one an SM, covering ``M`` with the last one partial."""
    chunk, blocks = kl.plan_grid(M, sms)
    assert (chunk, blocks) == want
    assert chunk % 512 == 0 and chunk >= kl.PLAN_MIN_CHUNK
    assert 1 <= blocks <= sms and (blocks - 1) * chunk < M <= blocks * chunk


def test_one_block_fits_shared_memory():
    """A plan of one block keeps its data in shared memory beside what
    every block takes there (the 16 warps' counts of 512 digits, a row of
    17 a digit; a tile of 8192 keys and values as placed; the block's
    digit counts and cursors): three arrays of ``PLAN_MIN_CHUNK`` keys or
    positions, the long runs and their lengths and five values, within
    Hopper's 227 KB less the kernel's 384 bytes of static shared
    memory."""
    M = kl.PLAN_MIN_CHUNK
    every = 512 * 17 + 2 * 8192 + 2 * 512
    local = 3 * M + 2 * (M // 33 + 1) + 5
    assert 4 * (every + local) <= 232_448 - 384


@pytest.mark.parametrize("sms,M,want", [
    (132, 200_000 * 33, (66, 1056)),           # field-blocked bench_logreg
    (132, 100_000 * 40, (66, 1056)),           # padded-COO, phase 7's rows
    (132, 4096 * 40, (66, 640)),               # bench_ftrl's batch step
    (132, 2047, (0, 8)),                       # no room for a heavy run
    (132, 1, (0, 1)),
    (132, 4096, (4, 16)),                      # two heavy runs at most
    (132, 16_384 * 4, (64, 256)),              # bench_ftrl's stream
    (1, 10_000, (2, 8)),                       # one cluster, 8 light blocks
    (132, 2 ** 31 - 1, (66, 1056)),
])
def test_launch_grid(sms, M, want):
    """From upper bounds of the positions: heavy blocks, a cluster of two
    per possible heavy run (``M // HEAVY_MIN``), up to a quarter of the
    SMs' clusters; light blocks (8 warps), a warp a medium run or 32
    short runs (``M / 256``), up to 8 an SM."""
    assert kl.launch_grid(sms, M) == want


@pytest.mark.parametrize("width", [1, 2, 3, 7, 8, 33, 40, 41, 1000, 2048,
                                   65_537, (1 << 20) + 1, (1 << 30) + 3,
                                   (1 << 31) - 1])
def test_div_magic_is_exact(width):
    """The kernel's row of a position, ``(p * magic) >> shift``, is
    ``p // width`` for every ``p < 2**31`` (edges and a random sample)."""
    magic, shift = kl.div_magic(width)
    assert 0 < magic < 2 ** 32 and 31 <= shift <= 62
    top = 2 ** 31 - 1
    ps = {0, 1, width - 1, width, width + 1, top, top - 1}
    q = top // width
    for k in (1, 2, 3, q - 1, q):
        ps.update({k * width - 1, k * width, k * width + 1})
    rng = np.random.RandomState(width % 1000)
    ps.update(int(x) for x in rng.randint(0, top, 2000))
    for p in ps:
        if 0 <= p <= top:
            assert (p * magic) >> shift == p // width, p


def test_plan_rejects_keys_outside_the_model():
    keys = torch.tensor([[0, 3]], dtype=torch.int32)
    val = torch.ones((1, 2))
    with pytest.raises(IndexError):
        kl.grad_plan(keys, 3, val)
    with pytest.raises(IndexError):
        kl.grad_plan(-keys, 3, val)


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_padded_coo_gradient_is_the_jax_scatter_add(dt):
    """The JAX package's padded-COO gradient (``objfunc.py::rmatvec``, an
    XLA scatter-add) and the plain version agree bit for bit."""
    from alink_tpu.operator.common.optim.objfunc import rmatvec
    npd, _ = DTYPES[dt]
    keys, val, c, dim = _design("coo", npd, seed=4)
    ref = np.asarray(rmatvec({"idx": jnp.asarray(keys), "val": jnp.asarray(val)},
                             jnp.asarray(c), dim))
    plan = kl.grad_plan(torch.from_numpy(keys), dim, torch.from_numpy(val))
    got = kl.linear_grad(plan, torch.from_numpy(c)).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(ref))


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_margins_are_the_sparse_score_kernels(dt):
    """``sparse_margins`` is the sparse serving kernel's plain version at
    zero bias: each row's terms added left to right from zero."""
    npd, _ = DTYPES[dt]
    keys, val, _, dim = _design("coo", npd, seed=2)
    coef = np.random.RandomState(1).randn(dim).astype(npd)
    got = kl.sparse_margins(torch.from_numpy(keys), torch.from_numpy(val),
                            torch.from_numpy(coef)).numpy()
    want = np.zeros(keys.shape[0], npd)
    for k in range(keys.shape[1]):
        want = want + val[:, k] * coef[keys[:, k]]
    np.testing.assert_array_equal(_bits(got), _bits(want))


class _FakeFn:
    def __init__(self):
        self.calls = []
        self.argtypes = self.restype = None

    def __call__(self, *args):
        self.calls.append(args)
        return 0


def test_cuda_tensors_reach_the_kernel_not_the_plain_version(monkeypatch):
    """With a library in place, a CUDA tensor goes to the C function once,
    on the current stream, and counts one launch; the plain version is
    never called. The plan's tensors reach it by their own pointers (the
    slots' order too), with the division's magic number, the run classes'
    counts and the grid."""
    fake = types.SimpleNamespace(alink_linear_grad=_FakeFn(),
                                 alink_scatter_walk=_FakeFn(),
                                 alink_linear_error_string=_FakeFn(),
                                 alink_run_plan=_FakeFn(),
                                 alink_run_plan_error_string=_FakeFn())
    monkeypatch.setattr(kl, "_fns", None)
    monkeypatch.setattr(kl, "_sms", {0: 132})
    monkeypatch.setattr(_build, "load_library", lambda n: fake)
    monkeypatch.setattr(_build, "current_device", lambda: 0)
    monkeypatch.setattr(_build, "stream_handle", lambda i: 55)
    ptrs = {}
    monkeypatch.setattr(torch.Tensor, "data_ptr", lambda t: ptrs.setdefault(
        id(t), 4096 * (len(ptrs) + 1)))

    def no_plain(*a):
        raise AssertionError("a CUDA tensor reached the plain version")
    monkeypatch.setattr(kl, "linear_grad_plain", no_plain)
    kl.reset_launch_counts()
    with FakeTensorMode():
        walk = kl.RunPlan(*(torch.zeros(n, dtype=torch.int32, device="cuda")
                            for n in (40, 41, 40, 40, 4)))
        plan = kl.GradPlan(
            torch.zeros((10, 4), dtype=torch.int32, device="cuda"),
            torch.zeros((10, 4), dtype=torch.float64, device="cuda"), 100,
            walk)
        c = torch.zeros(10, dtype=torch.float64, device="cuda")
        out = kl.linear_grad(plan, c)
        assert out.shape == (100,)
        with pytest.raises(ValueError):
            kl.linear_grad(plan, torch.zeros(10, device="cuda"))
        with pytest.raises(ValueError):
            kl.linear_grad(plan._replace(walk=walk._replace(
                counts=torch.zeros(4, dtype=torch.int32, device="meta"))), c)
    (args,) = fake.alink_linear_grad.calls
    assert args[:2] == (0, 1)
    assert args[2:10] == tuple(t.data_ptr() for t in (
        walk.perm, walk.starts, walk.order, walk.slots, walk.counts,
        plan.val, c, out))
    assert len(set(args[2:10])) == 8
    assert args[10:] == (*kl.div_magic(4), *kl.launch_grid(132, 40), 55)
    assert kl.launch_grid(132, 40) == (0, 1)
    # the module's other kernels, the ordered scatter-add and the plan,
    # launched nothing
    assert kl.launch_counts() == {"linear_grad": 1, "scatter_walk": 0,
                                  "run_plan": 0}


def test_margins_route_to_the_sparse_score_kernel(monkeypatch):
    """On the card the margins go to ``serve.sparse_scores`` in f32 mode
    with a zero bias of the values' dtype."""
    seen = []
    monkeypatch.setattr(kl, "sparse_scores",
                        lambda model, idx, val, mode: seen.append(
                            (model, idx, val, mode)) or val[:, 0])
    keys = torch.zeros((3, 2), dtype=torch.int32)
    val = torch.ones((3, 2), dtype=torch.float64)
    kl.sparse_margins(keys, val, torch.ones(4, dtype=torch.float64))
    ((w, b), idx, v, mode) = seen[0]
    assert mode == "f32" and b.dtype == torch.float64 and float(b) == 0.0
    assert idx is keys and v is val
