"""Packed single-key sort (ops/count.sort_rle pack_w_bits) is bit-identical
to the two-operand comparator sort it replaces, on the exact value ranges the
engine guarantees (rows < 2^(32-bits)-1, weights in [0, L] with 0 only on
sentinel lanes)."""

import numpy as np
import pytest

jnp = pytest.importorskip("jax.numpy")

from kaamer_jax.ops.count import ROW_SENTINEL, count_topk, sort_rle
from kaamer_jax.ops.hotset import merge_hot_cold


def _mk(rng, B, cap, nrow, L):
    rows = rng.integers(0, nrow, size=(B, cap)).astype(np.uint32)
    w = rng.integers(1, L + 1, size=(B, cap)).astype(np.int32)
    # trailing sentinel pad with weight 0, like gather_postings emits
    npad = rng.integers(0, cap // 2, size=B)
    for b in range(B):
        if npad[b]:
            rows[b, cap - npad[b]:] = ROW_SENTINEL
            w[b, cap - npad[b]:] = 0
    # gather_postings emits rows ordered by (kmer slice, offset); sort_rle
    # must not care, so feed them pre-sorted per slice-ish or random: random
    return jnp.asarray(rows), jnp.asarray(w)


@pytest.mark.parametrize("bits", [9, 10])
def test_sort_rle_packed_matches(bits):
    rng = np.random.default_rng(5)
    L = (1 << bits) - 1
    rows, w = _mk(rng, 8, 512, 1 << 18, min(L, 300))
    s0, c0, i0 = sort_rle(rows, weights=w)
    s1, c1, i1 = sort_rle(rows, weights=w, pack_w_bits=bits)
    np.testing.assert_array_equal(np.asarray(s0), np.asarray(s1))
    np.testing.assert_array_equal(np.asarray(c0), np.asarray(c1))
    np.testing.assert_array_equal(np.asarray(i0), np.asarray(i1))


def test_count_topk_packed_matches():
    rng = np.random.default_rng(6)
    rows, w = _mk(rng, 16, 320, 4000, 250)
    c0, h0 = count_topk(rows, 16, weights=w)
    c1, h1 = count_topk(rows, 16, weights=w, pack_w_bits=9)
    np.testing.assert_array_equal(np.asarray(c0), np.asarray(c1))
    np.testing.assert_array_equal(np.asarray(h0), np.asarray(h1))


def test_merge_hot_cold_packed_matches():
    rng = np.random.default_rng(7)
    G, cap, P, L = 4, 128, 512, 100
    rows = np.sort(rng.integers(0, P, size=(G, cap)).astype(np.uint32),
                   axis=1)
    # RLE structure over the sorted rows
    is_start = np.ones((G, cap), dtype=bool)
    is_start[:, 1:] = rows[:, 1:] != rows[:, :-1]
    per = rng.integers(1, 5, size=(G, cap)).astype(np.int32)
    cold = np.where(is_start, per, 0)
    counts_hot = rng.integers(0, 2, size=(G, P)).astype(np.float32) * \
        rng.integers(1, L, size=(G, P)).astype(np.float32)
    args = (jnp.asarray(counts_hot), jnp.asarray(rows), jnp.asarray(cold),
            jnp.asarray(is_start), 8)
    c0, h0 = merge_hot_cold(*args)
    c1, h1 = merge_hot_cold(*args, pack_w_bits=9)
    np.testing.assert_array_equal(np.asarray(c0), np.asarray(c1))
    np.testing.assert_array_equal(np.asarray(h0), np.asarray(h1))
