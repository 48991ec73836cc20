import numpy as np
import pytest

from kaamer_jax.index.build import dedup_sets
from kaamer_jax.index.hashtable import build_table, lookup_np


def test_hashtable_roundtrip():
    rng = np.random.default_rng(0)
    keys = np.unique(rng.integers(0, 2**32 - 2, size=5000, dtype=np.uint32))
    starts = np.arange(keys.size, dtype=np.uint32) * 3
    lens = (np.arange(keys.size, dtype=np.uint32) % 7) + 1
    ht = build_table(keys, starts, lens)
    assert ht.log2 >= 3
    # load factor respected (2 slots per row)
    assert keys.size <= 2 * ht.rows * 0.8 + 1

    got_s, got_l = lookup_np(ht, keys, miss_start=0xFFFF)
    np.testing.assert_array_equal(got_s, starts)
    np.testing.assert_array_equal(got_l, lens)

    # absent keys miss with (miss_start, 0)
    absent = np.setdiff1d(
        rng.integers(0, 2**32 - 2, size=1000, dtype=np.uint32), keys
    )
    got_s, got_l = lookup_np(ht, absent, miss_start=0xFFFF)
    assert (got_s == 0xFFFF).all() and (got_l == 0).all()


def test_hashtable_dense_and_min_log2():
    """A dense key set near the load threshold still converges, and
    min_log2 forces a larger structurally-identical table."""
    keys = np.arange(1, 60000, dtype=np.uint32)
    starts = keys * 2
    lens = np.ones_like(keys)
    ht = build_table(keys, starts, lens)
    got_s, got_l = lookup_np(ht, keys, miss_start=7)
    np.testing.assert_array_equal(got_s, starts)
    ht2 = build_table(keys, starts, lens, min_log2=ht.log2 + 2)
    assert ht2.log2 == ht.log2 + 2
    got_s2, _ = lookup_np(ht2, keys, miss_start=7)
    np.testing.assert_array_equal(got_s2, starts)


def test_dedup_sets_matches_bruteforce():
    rng = np.random.default_rng(1)
    # small synthetic pairs with repeated sets
    kmers = rng.integers(0, 50, size=400, dtype=np.uint64)
    rows = rng.integers(0, 10, size=400, dtype=np.uint64)
    pairs = np.sort((kmers << np.uint64(32)) | rows)

    uk, sid, soff, post = dedup_sets(pairs)

    # brute force
    ref = {}
    for p in pairs:
        ref.setdefault(int(p >> np.uint64(32)), set()).add(int(p & np.uint64(0xFFFFFFFF)))

    assert sorted(ref) == [int(k) for k in uk]
    seen_sets = {}
    for i, k in enumerate(uk):
        s = int(sid[i])
        lo, hi = int(soff[s]), int(soff[s + 1])
        got = sorted(int(x) for x in post[lo:hi])
        assert got == sorted(ref[int(k)]), f"kmer {k}"
        # identical sets must share a set id
        sig = tuple(got)
        if sig in seen_sets:
            assert seen_sets[sig] == s
        else:
            seen_sets[sig] = s
    # number of unique sets matches
    assert len(seen_sets) == soff.size - 1


def test_dedup_sets_empty():
    uk, sid, soff, post = dedup_sets(np.empty(0, dtype=np.uint64))
    assert uk.size == 0 and soff.size == 1
