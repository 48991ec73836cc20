"""Hit counting as sort + run-length-encoding (no scatter).

The reference tallies hits by incrementing a sharded concurrent counter per
posting (search.go:431-433) and then sorts the counter map (search.go:132-152).
A scatter-add is the literal translation, but contended scatters serialize.
Instead we materialize, per query, the concatenated multiset of protein rows
from all matched postings lists (one big CSR gather), sort it, and run-length
-encode: the count of each protein is the length of its run.  Sort, cumsum,
gather and top_k all map onto XLA primitives directly.

Ranking: count descending; ties broken by LOWER protein row.  (The reference's
tie order is Go map iteration order, i.e. nondeterministic -- search.go:136-150
-- so any fixed tie-break is compatible with its accepted outputs; ours is
deterministic.)  lax.top_k prefers lower indices on equal values and the runs
are laid out in ascending protein order, which yields exactly that tie-break.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

ROW_SENTINEL = np.uint32(0xFFFFFFFF)


def gather_postings(postings, offs, cum, total, cap: int, wstart=None):
    """Expand per-k-mer postings slices into a dense [B, cap] row multiset.

    postings: uint32[P]      global postings array
    offs:     int32[B, L]    start offset of each k-mer's postings slice
    cum:      int32[B, L]    inclusive cumsum of slice lengths per query
    total:    int32[B]       total postings per query (== cum[:, -1])
    wstart:   optional int32[B, L] per-position run weights (dedup_runs);
              when given, also returns each entry's weight as a 4th output.
    Entries beyond `total` are ROW_SENTINEL.  Also returns seg, the k-mer
    position index each entry came from (for position bitmaps).

    The flat-position -> segment mapping is computed as a dense comparison
    count, seg[b,j] = sum_l [cum[b,l] <= j]: dense elementwise work in
    place of a gather-heavy binary search (vmapped searchsorted).
    The segment's exclusive start is recovered the same way, as
    max_l cum[b,l]*[cum[b,l] <= j], saving another gather; entry weights
    reuse the same masks (entry j is in segment l iff le[l-1] & ~le[l]),
    so the weighted path adds no extra gather or comparison pass.
    """
    B, L = offs.shape
    # chunk the [B, L, cap_chunk] comparison volume to bound working set
    chunk = max(512, min(cap, (1 << 24) // max(L, 1)))
    segs = []
    prevs = []
    ws = []
    for c0 in range(0, cap, chunk):
        c1 = min(cap, c0 + chunk)
        j3 = jnp.arange(c0, c1, dtype=jnp.int32)[None, None, :]
        le = cum[:, :, None] <= j3                                 # [B, L, c]
        segs.append(le.astype(jnp.int32).sum(axis=1))
        prevs.append(jnp.max(jnp.where(le, cum[:, :, None], 0), axis=1))
        if wstart is not None:
            le_prev = jnp.concatenate(
                [jnp.ones_like(le[:, :1]), le[:, :-1]], axis=1)
            in_seg = le_prev & ~le                                 # one l per j
            ws.append((in_seg * wstart[:, :, None]).sum(axis=1))
    seg = segs[0] if len(segs) == 1 else jnp.concatenate(segs, axis=1)
    prev = prevs[0] if len(prevs) == 1 else jnp.concatenate(prevs, axis=1)

    j = jnp.arange(cap, dtype=jnp.int32)[None, :]
    seg_cl = jnp.minimum(seg, L - 1)
    src = jnp.take_along_axis(offs, seg_cl, axis=1) + (j - prev)
    valid = j < total[:, None]
    src = jnp.where(valid, src, 0)
    rows = jnp.where(valid, jnp.take(postings, src.reshape(-1)).reshape(B, cap), ROW_SENTINEL)
    if wstart is None:
        return rows, seg_cl, valid
    w = ws[0] if len(ws) == 1 else jnp.concatenate(ws, axis=1)
    return rows, seg_cl, valid, jnp.where(valid, w, 0)


def expand_hybrid(postings, offs, cum_s, wstart, cum_t, lens_l,
                  cap_s: int, cap_t: int):
    """Two-tier postings expansion: short runs element-by-element (as
    gather_postings), LONG runs via full-tile row gathers.

    Premise: a gather costs about as much per ROW whether the row is one
    uint32 or a full 512 B tile of 128 (measured on the machine the engine
    was first written for; not yet on the current GPU) -- so a run of
    length n >= ~64 is fetched as the ceil(((start & 127) + n) / 128) tile
    rows that cover it, with out-of-slice lanes masked to ROW_SENTINEL
    (they wash out of sort+RLE exactly like cap padding).  Engine phase 1
    splits the tiers at T_SPLIT=64.

    postings: uint32[P] with P % 128 == 0 (the engine pads at init; the
              [P//128, 128] tile view is a free reshape)
    offs:     int32[B, L]  slice start of each position's postings run
    cum_s:    int32[B, L]  inclusive cumsum of SHORT cold run lengths
    wstart:   int32[B, L]  run weight at run-start lanes
    cum_t:    int32[B, L]  inclusive cumsum of LONG cold runs' tile-row
              counts (ceil(((offs & 127) + len) / 128) at long run starts)
    lens_l:   int32[B, L]  true length at LONG run starts, 0 elsewhere
    cap_s:    element capacity of the short part
    cap_t:    tile-row capacity of the long part (0 = no long part; the
              compiled program is then gather_postings minus its
              take_along_axis src pass)

    Returns (rows uint32[B, cap_s + 128*cap_t], seg int32[...] run-start
    lane per entry, valid bool[...], w int32[...]) -- the gather_postings
    contract on the concatenated array.  The run-to-lane maps are dense
    comparison counts with the per-entry base/weight/lane folded into the
    same masked-sum pass (in_seg selects exactly one lane per entry), so
    no take_along_axis gathers remain.
    """
    B, L = offs.shape

    def _sel_pass(cum, cap, fold):
        """seg + in_seg-folded selections over a [B, L, cap] compare.
        fold: list of int32[B, L] per-lane values to select at each
        entry's run lane.  Returns (seg, [folded...])."""
        chunk = max(512, min(cap, (1 << 24) // max(L, 1)))
        segs = []
        outs = [[] for _ in fold]
        for c0 in range(0, cap, chunk):
            c1 = min(cap, c0 + chunk)
            j3 = jnp.arange(c0, c1, dtype=jnp.int32)[None, None, :]
            le = cum[:, :, None] <= j3
            segs.append(le.astype(jnp.int32).sum(axis=1))
            le_prev = jnp.concatenate(
                [jnp.ones_like(le[:, :1]), le[:, :-1]], axis=1)
            in_seg = le_prev & ~le
            for o, v in zip(outs, fold):
                o.append((in_seg * v[:, :, None]).sum(axis=1))
        cat = lambda xs: xs[0] if len(xs) == 1 else jnp.concatenate(xs, 1)
        return cat(segs), [cat(o) for o in outs]

    # --- short part: element expansion --------------------------------
    cum_s_prev = jnp.concatenate(
        [jnp.zeros((B, 1), jnp.int32), cum_s[:, :-1]], axis=1)
    vbase = offs - cum_s_prev
    seg_s, (base_s, w_s) = _sel_pass(cum_s, cap_s, [vbase, wstart])
    j = jnp.arange(cap_s, dtype=jnp.int32)[None, :]
    valid_s = j < cum_s[:, -1:]
    src = jnp.where(valid_s, base_s + j, 0)
    rows_s = jnp.where(
        valid_s, jnp.take(postings, src.reshape(-1)).reshape(B, cap_s),
        ROW_SENTINEL)
    seg_s = jnp.minimum(seg_s, L - 1)
    w_s = jnp.where(valid_s, w_s, 0)
    if cap_t == 0:
        return rows_s, seg_s, valid_s, w_s

    # --- long part: tile-row expansion --------------------------------
    P = postings.shape[0]
    ptiles = postings.reshape(P // 128, 128)
    cum_t_prev = jnp.concatenate(
        [jnp.zeros((B, 1), jnp.int32), cum_t[:, :-1]], axis=1)
    tbase = (offs >> 7) - cum_t_prev
    seg_t, (base_t, off_t, len_t, w_t) = _sel_pass(
        cum_t, cap_t, [tbase, offs, lens_l, wstart])
    jr = jnp.arange(cap_t, dtype=jnp.int32)[None, :]
    valid_t = jr < cum_t[:, -1:]
    tile = jnp.where(valid_t, base_t + jr, 0)
    tile = jnp.clip(tile, 0, P // 128 - 1)
    gath = jnp.take(ptiles, tile.reshape(-1), axis=0).reshape(B, cap_t, 128)
    a = jnp.arange(128, dtype=jnp.int32)[None, None, :]
    abs_idx = tile[:, :, None] * 128 + a
    keep = (valid_t[:, :, None]
            & (abs_idx >= off_t[:, :, None])
            & (abs_idx < (off_t + len_t)[:, :, None]))
    rows_t = jnp.where(keep, gath, ROW_SENTINEL).reshape(B, cap_t * 128)
    seg_t = jnp.minimum(seg_t, L - 1)
    segt_e = jnp.broadcast_to(seg_t[:, :, None],
                              (B, cap_t, 128)).reshape(B, cap_t * 128)
    wt_e = jnp.broadcast_to(
        jnp.where(valid_t, w_t, 0)[:, :, None],
        (B, cap_t, 128)).reshape(B, cap_t * 128)
    keep_e = keep.reshape(B, cap_t * 128)

    rows = jnp.concatenate([rows_s, rows_t], axis=1)
    seg = jnp.concatenate([seg_s, segt_e], axis=1)
    valid = jnp.concatenate([valid_s, keep_e], axis=1)
    w = jnp.concatenate([w_s, jnp.where(keep_e, wt_e, 0)], axis=1)
    return rows, seg, valid, w


def sort_rle(rows, weights=None, pack_w_bits: int = 0):
    """Sort each query's row multiset and run-length-encode it.

    rows: uint32[B, cap]; weights: optional int32[B, cap] per-entry
    multiplicities (from run-deduplicated expansion, see dedup_runs) -- a
    run's count is then the sum of its weights rather than its length.
    Returns (s uint32[B, cap] sorted rows, counts int32[B, cap] with each
    run's total at its start lane and 0 elsewhere, is_start bool[B, cap];
    sentinels excluded).

    pack_w_bits > 0: sort ONE uint32 key (row << bits | weight) instead of
    the two-operand (rows, weights) comparator sort -- a single-operand
    sort is XLA's fast path.  Callers must guarantee every
    real row < 2^(32-bits) - 1 and every weight < 2^bits (weights are
    position-run lengths <= L, so the engine picks bits from the static L
    and checks num_proteins; see engine._pack_w_bits).  Row order is
    unchanged (equal rows tie-break by weight, and RLE sums per-run
    weights, which is order-invariant), so results are bit-identical.
    """
    cap = rows.shape[1]
    if weights is None:
        s = jnp.sort(rows, axis=1)
    elif pack_w_bits:
        shift = jnp.uint32(pack_w_bits)
        mask = jnp.uint32((1 << pack_w_bits) - 1)
        packed = jnp.where(
            rows == ROW_SENTINEL, jnp.uint32(0xFFFFFFFF),
            (rows.astype(jnp.uint32) << shift)
            | weights.astype(jnp.uint32))
        ps = jnp.sort(packed, axis=1)
        sent = ps == jnp.uint32(0xFFFFFFFF)
        s = jnp.where(sent, ROW_SENTINEL, ps >> shift)
        w = jnp.where(sent, 0, (ps & mask).astype(jnp.int32))
    else:
        s, w = jax.lax.sort((rows, weights.astype(jnp.int32)), num_keys=1)

    idx = jnp.arange(cap, dtype=jnp.int32)[None, :]
    is_start = jnp.concatenate(
        [jnp.ones_like(s[:, :1], dtype=bool), s[:, 1:] != s[:, :-1]], axis=1
    ) & (s != ROW_SENTINEL)

    # Run end position: smallest j >= i where the value changes (or cap-1).
    change_next = jnp.concatenate(
        [s[:, 1:] != s[:, :-1], jnp.ones_like(s[:, :1], dtype=bool)], axis=1
    )
    ends = jnp.where(change_next, idx, cap)
    run_end = jax.lax.cummin(ends, axis=1, reverse=True)

    if weights is None:
        counts = jnp.where(is_start, run_end - idx + 1, 0).astype(jnp.int32)
    else:
        # weighted run sum without gathers: backward-fill each run's
        # inclusive-cumsum endpoint (wc is nondecreasing, so the NEAREST
        # future endpoint -- this run's -- is the minimum over future
        # endpoints; a reverse cummin of the masked endpoints recovers
        # wc[run_end] per lane)
        wc = jnp.cumsum(w, axis=1)
        wc_end = jax.lax.cummin(
            jnp.where(change_next, wc, np.int32(2**31 - 1)),
            axis=1, reverse=True)
        counts = jnp.where(is_start, wc_end - wc + w, 0).astype(jnp.int32)
    return s, counts, is_start


def count_topk(rows, k: int, weights=None, pack_w_bits: int = 0):
    """Sort + RLE + top-k (count, row) pairs; see sort_rle.  Returns
    (counts int32[B, k], hit_rows uint32[B, k]); absent entries have
    count 0, row ROW_SENTINEL."""
    s, counts, _ = sort_rle(rows, weights, pack_w_bits=pack_w_bits)
    top_counts, top_pos = jax.lax.top_k(counts, k)
    hit_rows = jnp.take_along_axis(s, top_pos, axis=1)
    hit_rows = jnp.where(top_counts > 0, hit_rows, ROW_SENTINEL)
    return top_counts, hit_rows


def dedup_runs(offs, lens):
    """Query-time KComb: collapse consecutive k-mer positions that resolved
    to the SAME postings slice into one weighted expansion unit.

    The reference dedups identical k-mer->protein sets across the database
    (kcomb_store.go:42-63) because conserved domains make many k-mers share
    one set; at query time those k-mers are CONSECUTIVE positions, so the
    per-query expansion re-pays the multiplicity the store already factored
    out.  Collapsing runs of equal slice starts makes the expansion volume
    (and therefore the adaptive cap and device cost) scale with the DISTINCT
    postings volume: on domain-skewed data this is the difference between
    cap=512 and cap=64k.

    offs: int32[B, L] per-position slice starts (miss/padding = sentinel);
    lens: int32[B, L] slice lengths.
    Returns (lens_u, wstart, run_start):
      lens_u:    lens with non-run-start positions zeroed (feed to cumsum /
                 gather_postings -- seg then lands on run starts)
      wstart:    int32[B, L] run length in positions, valid AT run starts
      run_start: int32[B, L] index of each position's run start (for
                 expanding per-run position bitmaps back to positions)
    """
    B, L = offs.shape
    lane = jnp.arange(L, dtype=jnp.int32)[None, :]
    diff_prev = offs[:, 1:] != offs[:, :-1]
    is_new = jnp.concatenate(
        [jnp.ones((B, 1), dtype=bool), diff_prev], axis=1)
    lens_u = jnp.where(is_new, lens, 0)
    change_next = jnp.concatenate(
        [diff_prev, jnp.ones((B, 1), dtype=bool)], axis=1)
    ends = jnp.where(change_next, lane, L)
    run_end = jax.lax.cummin(ends, axis=1, reverse=True)
    wstart = run_end - lane + 1
    run_start = jax.lax.cummax(jnp.where(is_new, lane, 0), axis=1)
    return lens_u, wstart, run_start


def expand_run_bitmaps(found_u, run_start):
    """Broadcast per-run position bitmaps to every position of the run.

    found_u: bool[B, K, L] with bits only at run-start columns (seg always
    lands on run starts under dedup_runs); run_start: int32[B, L].  A
    forward-fill along L without gathers: each column's value is
    (run_start * 2 + bit), whose running max within a run preserves the run
    head's bit and resets at the next run (strictly larger run_start).
    """
    t = run_start[:, None, :] * 2 + found_u.astype(jnp.int32)
    return (jax.lax.cummax(t, axis=2) & 1).astype(jnp.bool_)


def member_bitmap(postings, offs, lens, hits, iters: int):
    """UNUSED ALTERNATIVE kept for reference/testing; production uses
    member_bitmap_from_rows (one-hot matmul), which is independent of the
    longest postings list.

    Device-side position bitmaps: for each query b, hit k, and k-mer
    position l, whether hit row hits[b,k] is in the postings slice
    postings[offs[b,l] : offs[b,l]+lens[b,l]] (slices are sorted ascending).

    postings: uint32[P]; offs/lens: int32[B, L]; hits: uint32[B, K];
    iters: static bound ceil(log2(max_len+1))+1 from the DB's longest
    postings list.  Returns bool[B, K, L] via an unrolled batched binary
    search -- `iters` gathers of B*K*L elements, independent of the
    expansion cap (the host equivalent is member_np below).
    """
    P = postings.shape[0]
    lo = jnp.broadcast_to(offs[:, None, :], offs.shape[:1] + hits.shape[1:2] + offs.shape[1:])
    end = offs + lens
    hi = jnp.broadcast_to(end[:, None, :], lo.shape)
    lo = lo.astype(jnp.int32)
    hi = hi.astype(jnp.int32)
    h = hits[:, :, None]
    for _ in range(iters):
        active = lo < hi
        mid = (lo + hi) >> 1
        v = jnp.take(postings, jnp.clip(mid, 0, max(P - 1, 0)).reshape(-1)).reshape(mid.shape)
        go_right = active & (v < h)
        lo = jnp.where(go_right, mid + 1, lo)
        hi = jnp.where(active & ~go_right, mid, hi)
    in_range = lo < end[:, None, :]
    v = jnp.take(postings, jnp.clip(lo, 0, max(P - 1, 0)).reshape(-1)).reshape(lo.shape)
    return in_range & (v == h)


def member_bitmap_from_rows(rows, seg, hits, L: int):
    """Position bitmaps from the already-expanded postings (gather-free).

    rows: uint32[B, cap] expanded row multiset (ROW_SENTINEL padding);
    seg:  int32[B, cap] k-mer position index of each expanded entry;
    hits: uint32[B, K] top hit rows.  bitmap[b,k,l] = expanded entry with
    row==hits[b,k] at position l exists.  Computed as one bf16 batched
    matmul over {0,1} indicators -- each (row, l) pair occurs at most once,
    so the f32-accumulated sum is exactly 0 or 1.  Matmul work is B*cap*K*L
    MACs: far cheaper than a postings binary search at small caps, and
    independent of the DB's longest postings list.
    """
    match_k = (rows[:, :, None] == hits[:, None, :]).astype(jnp.bfloat16)
    onehot_l = (seg[:, :, None] == jnp.arange(L, dtype=jnp.int32)).astype(jnp.bfloat16)
    acc = jnp.einsum("bjk,bjl->bkl", match_k, onehot_l,
                     preferred_element_type=jnp.float32)
    return acc > 0.5


def pack_bits(bits):
    """bool[..., L] -> uint8[..., L//8] little-endian bit packing (L % 8 == 0);
    host inverse is np.unpackbits(..., bitorder='little')."""
    w = jnp.asarray([1, 2, 4, 8, 16, 32, 64, 128], dtype=jnp.uint8)
    shaped = bits.reshape(bits.shape[:-1] + (bits.shape[-1] // 8, 8))
    return (shaped.astype(jnp.uint8) * w).sum(axis=-1).astype(jnp.uint8)


def member_np(postings: np.ndarray, offs: np.ndarray, lens: np.ndarray,
              hits: np.ndarray) -> np.ndarray:
    """Host-side position bitmaps: for one query, which k-mer positions'
    postings sets contain each hit row.

    postings: uint32[P]; offs/lens: int64[L] per-k-mer slices (sorted rows);
    hits: uint32[K].  Returns bool[K, L] via vectorized binary search.
    """
    L = offs.shape[0]
    K = hits.shape[0]
    lo = np.broadcast_to(offs[None, :], (K, L)).astype(np.int64).copy()
    hi = (offs + lens)[None, :].astype(np.int64)
    hi = np.broadcast_to(hi, (K, L)).copy()
    h = hits[:, None].astype(np.uint32)
    maxlen = int(lens.max()) if L else 0
    iters = max(1, int(np.ceil(np.log2(maxlen + 1))) + 1) if maxlen > 0 else 0
    for _ in range(iters):
        active = lo < hi
        mid = (lo + hi) >> 1
        v = postings[np.clip(mid, 0, max(len(postings) - 1, 0))]
        go_right = active & (v < h)
        lo = np.where(go_right, mid + 1, lo)
        hi = np.where(active & ~go_right, mid, hi)
    in_range = lo < (offs + lens)[None, :]
    found = np.zeros((K, L), dtype=bool)
    if len(postings):
        found = in_range & (postings[np.clip(lo, 0, len(postings) - 1)] == h)
    return found
