"""Batched k-mer hash-probe on device.

The reference resolves each query k-mer with two Badger LSM point reads and a
protobuf unmarshal inside a goroutine loop (search.go:419-437).  Here the
entire batch is resolved against the device-resident cuckoo table
(index/hashtable.py) with exactly TWO dense row-gathers -- one per hash
choice -- plus vectorized compares.  No data-dependent loops: a while-loop
probe pays per-iteration launch overhead and worst-case cluster depth; the
2-choice cuckoo layout makes the probe shape static and load-independent.

Design premise: a row-gather costs a fixed amount per row plus a little per
byte, so the 24 B cuckoo rows with INLINE (start, len) postings slices need
fewer and narrower rows than 64 B 8-slot buckets or a separate set-offsets
gather.  The premise was measured on the machine the engine was first
written for; it has not been measured on the current GPU yet (ROADMAP.md).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..index.hashtable import HASH_MULT, HASH_MULT2

EMPTY_KEY = np.uint32(0xFFFFFFFF)


def probe_slices(table, queries, log2: int, miss_start):
    """Look up the postings slice of a batch of k-mer codes.

    table:    uint32[rows, 6] device array ([k0, s0, l0, k1, s1, l1] rows)
    queries:  uint32[...] k-mer codes (all < 2^32-1)
    returns:  (starts uint32[...], lens uint32[...]); misses and padding get
              (miss_start, 0).

    Each key occupies exactly one slot of its two candidate rows, so the hit
    value is recovered as a masked sum (cheaper than chained selects on the
    VPU).  The only way two compared slots can both match is h1(q) == h2(q)
    (the same row gathered twice), so each check masks out already-found
    lanes to avoid double-accumulating in that case.
    """
    shape = queries.shape
    q = queries.reshape(-1)

    start_acc = jnp.zeros(q.shape, dtype=jnp.uint32)
    len_acc = jnp.zeros(q.shape, dtype=jnp.uint32)
    found = jnp.zeros(q.shape, dtype=jnp.bool_)
    for mult in (HASH_MULT, HASH_MULT2):
        b = ((q * mult) >> np.uint32(32 - log2)).astype(jnp.int32)
        rows = jnp.take(table, b, axis=0)  # [m, 6]
        for s0 in (0, 3):
            hit = (rows[:, s0] == q) & ~found
            start_acc = start_acc + jnp.where(hit, rows[:, s0 + 1], 0)
            len_acc = len_acc + jnp.where(hit, rows[:, s0 + 2], 0)
            found = found | hit
    starts = jnp.where(found, start_acc, jnp.uint32(miss_start))
    return starts.reshape(shape), len_acc.reshape(shape)
