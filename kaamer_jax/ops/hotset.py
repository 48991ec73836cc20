"""Hot-set dense counting: matmuls instead of postings expansion.

On skewed databases (the regime the reference's KComb store exists for,
kcomb_store.go:42-63) a handful of popular postings sets carry most of the
expansion volume, so the per-entry postings gather dominates device time
when every set is expanded.  Those same hot sets are FEW and STATIC, so their membership is precomputed once as a dense
0/1 matrix M[H, P] and a query's hot contribution to every protein's count
becomes ONE matmul:

    counts_hot[g, p] = sum_h W[g, h] * M[h, p]        (f32-exact)

where W[g, h] is the total k-mer-position weight query g puts on hot set h.
Only COLD sets (postings length < the hot threshold) still go through the
gather + sort + RLE pipeline -- at caps 10-30x smaller.  Exact integer
arithmetic throughout: indicators are {0,1}, weights are ints < 2^24, and
every accumulation is f32 (exact for ints < 2^24).

Merging the two contributions stays exact via a candidate-union argument:
every protein with a nonzero cold count appears among the cold RLE rows
(its total = cold RLE count + a gather from counts_hot), and every protein
with zero cold count that could make the top-k appears in the dense hot
top-k (its total = its hot count).  Hot top-k candidates that also have a
nonzero cold count are zeroed (they are already exact in the cold list), so
candidates are distinct; a final sort by protein row restores the global
(count desc, row asc) tie-break before lax.top_k.

The dense hot top-k itself is hierarchical and EXACT (see topk_dense): if a
tile's max is below the k-th selected tile max, every element in it is
outscored by >= k elements, so the top-k tiles by max contain all top-k
elements (ties included, by the row-asc ordering of tile gathering).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

ROW_SENTINEL = np.uint32(0xFFFFFFFF)

# hot sets must be worth a dense row: below this postings length the gather
# pipeline is cheaper than M's memory
MIN_HOT_LEN = 24
# dense-path budget: M bytes (bf16).  4 GB funds H=2048 hot sets at 1M
# proteins; H scales down with P automatically, and there is deliberately
# NO hard P cutoff here.  The value is inherited from the first target
# machine, not measured on the current GPU; ROADMAP.md Speed 5 re-derives
# it.
M_BYTES_BUDGET = 1 << 32


def select_hot_sets(set_offsets: np.ndarray, num_proteins: int,
                    h_max: int = 2048, min_len: int = MIN_HOT_LEN):
    """Pick the hot sets (longest postings slices) and build their dense
    membership matrix.  Returns (hot_starts int32[H] (slice start offsets,
    the probe's native set identity), threshold_len, P_pad) or None when the
    database has no set worth a dense row or the budgets don't fit.

    set_offsets: uint64[S+1] postings slice boundaries."""
    if set_offsets is None or set_offsets.size < 2:
        return None
    P_pad = -(-max(num_proteins, 1) // 128) * 128
    h_budget = int(M_BYTES_BUDGET // (P_pad * 2))
    h_max = min(h_max, h_budget)
    if h_max < 1:
        return None
    lens = np.diff(set_offsets.astype(np.int64))
    eligible = np.flatnonzero(lens >= min_len)
    if eligible.size == 0:
        return None
    if eligible.size > h_max:
        part = np.argpartition(lens[eligible], eligible.size - h_max)
        hot_ids = eligible[part[eligible.size - h_max:]]
        # The hot set must be a PURE length threshold: phase 1 marks every
        # run with len >= thresh as hot (and drops it from the cold
        # expansion), so any set at the cut length that argpartition did
        # NOT select would be silently uncounted.  Drop the whole tie tier
        # instead; its members stay on the (exact) cold path.
        thresh = int(lens[hot_ids].min())
        if int(np.count_nonzero(lens >= thresh)) > hot_ids.size:
            thresh += 1
            hot_ids = np.flatnonzero(lens >= thresh)
            if hot_ids.size == 0:
                return None
    else:
        hot_ids = eligible
    hot_starts = set_offsets[hot_ids].astype(np.int64)
    # threshold: every set with len >= T is hot, and EXACTLY those sets are
    # in hot_starts (the tie tier at the cut was dropped above)
    thresh = int(lens[hot_ids].min())
    order = np.argsort(hot_starts)
    return hot_starts[order].astype(np.int32), thresh, P_pad


def build_membership_np(postings: np.ndarray, set_offsets: np.ndarray,
                        hot_starts: np.ndarray, P_pad: int,
                        out: np.ndarray = None) -> np.ndarray:
    """M[H, P_pad] float32: M[h, p] = 1 iff protein row p is in hot set h.
    `out` (optional) writes into a preallocated row block (the sharded
    engine stacks per-shard matrices)."""
    M = out if out is not None else np.zeros(
        (hot_starts.shape[0], P_pad), dtype=np.float32)
    ends = set_offsets.astype(np.int64)
    for h, s in enumerate(hot_starts.astype(np.int64)):
        e = ends[np.searchsorted(ends, s, side="right")]
        M[h, postings[s:e]] = 1.0
    return M


# M smaller than this stays f32: dtype makes no measurable difference on
# a few-MB matrix and the f32 path never needs hot_matmul's weight split.
M_F32_BYTES = 64 << 20


def build_membership(postings: np.ndarray, set_offsets: np.ndarray,
                     hot_starts: np.ndarray, P_pad: int):
    """Membership matrix as a device array: bf16 beyond the small-DB
    regime -- 0/1 is exact in bf16, the per-dispatch stream halves, and
    W @ M runs at the bf16 matmul rate.  Tiny matrices stay f32 (no
    difference, and no weight split on long queries).

    Built ON DEVICE by one scatter over the compact (hot set, protein row)
    pairs: at 1M proteins M is ~1 GB while the pairs are a few MB, so
    engine init uploads little.  (Scatter is forbidden in serving hot
    paths, not at init.)"""
    import jax.numpy as jnp  # local: keep module importable host-only

    H = int(hot_starts.shape[0])
    ends = set_offsets.astype(np.int64)
    hs, rows = [], []
    for h, s in enumerate(hot_starts.astype(np.int64)):
        e = ends[np.searchsorted(ends, s, side="right")]
        seg = postings[s:e]
        hs.append(np.full(seg.size, h, dtype=np.int32))
        rows.append(np.asarray(seg, dtype=np.int32))
    hh = np.concatenate(hs) if hs else np.empty(0, np.int32)
    rr = np.concatenate(rows) if rows else np.empty(0, np.int32)
    dtype = jnp.float32 if H * P_pad * 4 <= M_F32_BYTES else jnp.bfloat16
    M = jnp.zeros((H, P_pad), dtype=dtype)
    return M.at[jnp.asarray(hh), jnp.asarray(rr)].set(1, mode="drop",
                                                      unique_indices=True)


def hot_weights(offs, whot, hot_starts):
    """W f32[G, H]: total position weight each query puts on each hot set.

    offs: int32[G, L] per-position slice starts
    whot: int32[G, L] run weight at HOT run-start lanes, 0 elsewhere
          (phase 1 masks wstart by is_run_start & hot)
    hot_starts: int32[H]

    One [G, L, H] one-hot compare-einsum; every lane of a run carries the
    same offs, so the run-start masking makes each run contribute exactly
    once with multiplicity wstart.  Weights are bounded by L (a run weight
    is a position count), so for L <= 256 the whole contraction is exact in
    bf16 operands (integers 0..256 are exactly representable) and runs at
    the bf16 matmul rate with an f32 accumulator; longer L keeps f32
    operands.
    """
    L = offs.shape[1]
    if L <= 256:
        ind = (offs[:, :, None] == hot_starts[None, None, :]).astype(
            jnp.bfloat16)
        return jnp.einsum("glh,gl->gh", ind, whot.astype(jnp.bfloat16),
                          preferred_element_type=jnp.float32)
    # f32 operands at default precision may run as TF32 on a GPU, which
    # holds integers exactly only up to 2^11 -- and run weights reach L
    ind = (offs[:, :, None] == hot_starts[None, None, :]).astype(jnp.float32)
    return jnp.einsum("glh,gl->gh", ind, whot.astype(jnp.float32),
                      preferred_element_type=jnp.float32,
                      precision=jax.lax.Precision.HIGHEST)


def hot_matmul(W, M, max_w: int, out_dtype=None):
    """counts_hot [G, P] = W @ M, exactly, at the bf16 matmul rate.

    W: f32[G, H] integer-valued hot weights (values <= max_w, the group's
    query length); M: {0,1} membership, f32 or bf16.  A bf16 M must NOT be
    upcast (M.astype(f32) materializes a full f32 copy of a multi-GB matrix
    per dispatch and runs the dot at the slower f32 rate).
    Instead the weights move to bf16: directly when max_w <= 256 (exact),
    otherwise split W = 256*hi + lo with each half <= 256 and two bf16
    matmuls recombined in f32 -- every product is an integer < 2^24, so f32
    accumulation is exact.

    out_dtype: result dtype; accumulation stays f32 (exact) and XLA fuses
    the final convert into the matmul epilogue.  Callers pass bf16 when
    the counts fit it exactly (integers <= 256, i.e. L <= 256) -- the
    [G, P] slab write + its downstream reads then halve.

    The bf16 contractions need no precision argument: their operands are
    integers <= 256, exact in bf16, and they accumulate in f32.  The f32
    branch pins HIGHEST, since default precision may round W to TF32."""
    if M.dtype == jnp.bfloat16:
        if max_w <= 256:
            out = jnp.dot(W.astype(jnp.bfloat16), M,
                          preferred_element_type=jnp.float32)
        else:
            hi = jnp.floor(W * (1.0 / 256.0))
            lo = W - hi * 256.0
            out = (jnp.dot(lo.astype(jnp.bfloat16), M,
                           preferred_element_type=jnp.float32)
                   + 256.0 * jnp.dot(hi.astype(jnp.bfloat16), M,
                                     preferred_element_type=jnp.float32))
    else:
        out = jnp.dot(W, M, preferred_element_type=jnp.float32,
                      precision=jax.lax.Precision.HIGHEST)
    return out.astype(out_dtype) if out_dtype is not None else out


def topk_dense(vals, k: int, direct_max: int = 4096):
    """Exact top-k over a dense [G, P] f32 array with the (value desc,
    index asc) tie-break of lax.top_k, hierarchical for large P.

    P is tiled by 128; the top-k TILES by tile-max provably contain every
    top-k element: if element x's tile were not selected, >= k tiles have
    (max, idx) ranking above it, each contributing an element that outranks
    x.  Selected tiles are re-ordered ascending so candidate index order is
    global index order, preserving the tie-break.  Returns (values f32[G, k],
    idx int32[G, k]).
    """
    G, P = vals.shape
    if P <= direct_max or P % 128 or k > P // 128:
        v, i = jax.lax.top_k(vals, k)
        return v, i.astype(jnp.int32)
    T = P // 128
    tiles = vals.reshape(G, T, 128)
    tmax = tiles.max(axis=2)
    _, ti = jax.lax.top_k(tmax, k)                    # [G, k] tile ids
    ti = jnp.sort(ti, axis=1)                          # ascending: row order
    cand = jnp.take_along_axis(tiles, ti[:, :, None], axis=1)  # [G, k, 128]
    v, j = jax.lax.top_k(cand.reshape(G, k * 128), k)
    tile_of = jnp.take_along_axis(ti, j // 128, axis=1)
    return v, (tile_of * 128 + j % 128).astype(jnp.int32)


def merge_hot_cold(counts_hot, s_rows, cold_counts, is_start, k: int,
                   k_hot: int = 0, pack_w_bits: int = 0):
    """Exact top-k of total = hot + cold counts via the candidate union.

    counts_hot:  f32[G, P_pad] dense hot counts (W @ M)
    s_rows:      uint32[G, cap] SORTED cold row multiset (ROW_SENTINEL pad)
    cold_counts: int32[G, cap]  RLE count at run starts (0 elsewhere)
    is_start:    bool[G, cap]   run-start lanes of s_rows
    pack_w_bits: as in ops/count.sort_rle -- totals are matched-position
    counts <= L < 2^bits, so the union re-sort can ride the single-operand
    fast path under the same row-range guarantee.
    Returns (counts int32[G, k], hit_rows uint32[G, k]).
    """
    G, P = counts_hot.shape
    cap = s_rows.shape[1]
    k_hot = k_hot or k

    # cold candidates: every distinct cold row; total = cold + hot[row]
    safe = jnp.minimum(s_rows, np.uint32(P - 1)).astype(jnp.int32)
    hot_at_cold = jnp.take_along_axis(counts_hot, safe, axis=1)
    cold_tot = jnp.where(is_start,
                         cold_counts + hot_at_cold.astype(jnp.int32), 0)

    # hot candidates: dense top-k; zeroed when the row has any cold count
    # (it is then already exact among the cold candidates)
    hv, hi = topk_dense(counts_hot, k_hot)
    in_cold = (
        (s_rows[:, None, :] == hi.astype(jnp.uint32)[:, :, None]) & is_start[:, None, :]
    ).any(axis=2)
    hot_tot = jnp.where(in_cold, 0, hv.astype(jnp.int32))
    hot_tot = jnp.where(hv > 0, hot_tot, 0)
    hot_rows = jnp.where(hot_tot > 0, hi.astype(jnp.uint32), ROW_SENTINEL)

    # union, re-sorted by row so lax.top_k's index preference realizes the
    # global (count desc, row asc) tie-break
    rows_u = jnp.concatenate(
        [jnp.where(cold_tot > 0, s_rows, ROW_SENTINEL), hot_rows], axis=1)
    tot_u = jnp.concatenate([cold_tot, hot_tot], axis=1)
    if pack_w_bits:
        shift = jnp.uint32(pack_w_bits)
        mask = jnp.uint32((1 << pack_w_bits) - 1)
        packed = jnp.where(
            rows_u == ROW_SENTINEL, jnp.uint32(0xFFFFFFFF),
            (rows_u.astype(jnp.uint32) << shift)
            | tot_u.astype(jnp.uint32))
        ps = jnp.sort(packed, axis=1)
        sent = ps == jnp.uint32(0xFFFFFFFF)
        rows_s = jnp.where(sent, ROW_SENTINEL, ps >> shift)
        tot_s = jnp.where(sent, 0, (ps & mask).astype(jnp.int32))
    else:
        rows_s, tot_s = jax.lax.sort((rows_u, tot_u), num_keys=1)
    top_counts, top_pos = jax.lax.top_k(tot_s, k)
    hit_rows = jnp.take_along_axis(rows_s, top_pos, axis=1)
    hit_rows = jnp.where(top_counts > 0, hit_rows, ROW_SENTINEL)
    return top_counts, hit_rows


# Candidate width of the threshold merge: top-CAND_K cold rows + top-CAND_K
# hot rows.  Must comfortably exceed the serving k (k_full=16) so the
# exactness certificate below almost never fails.
CAND_K = 64


def merge_hot_cold_tam(counts_hot, rows, w, k: int, pack_w_bits: int = 0,
                       k_cand: int = CAND_K, k_cold: int = 0):
    """Exact top-k of hot+cold totals WITHOUT a per-lane counts_hot gather.

    The candidate-union merge (merge_hot_cold) gathers counts_hot at every
    expanded lane, which dominates a hot chunk at 1M-protein scale.  This
    variant applies the threshold algorithm (Fagin) under static
    shapes instead.  Candidates are

      C1: the top-k_cold COLD rows by cold count (extracted by one more
          packed sort -- O(cap) regardless of k_cold, unlike top_k), with
          exact totals via k_cold tiny counts_hot gathers per query, and
      H2: the top-k_cand HOT rows by dense hot count, with exact cold
          counts obtained by INJECTING them into the expansion sort as
          zero-weight entries: an injected entry sorts to the head of its
          row's run (weight 0 < any real weight), and the weighted RLE
          count at a run head IS that row's exact cold count.

    Any row outside both lists has total <= bound = (k_cold-th cold count)
    + (k_cand-th hot count); the per-query exactness certificate is

        exact = (tau > bound) | (bound == 0)
              | ((tau == bound) & (rho <= R))        [plateau clause]

    with tau the k-th candidate total, rho its row id, and R the largest
    SELECTED row of the binding tier (see the inline derivation).  The
    engine re-runs !exact rows through the per-lane legacy merge on
    device; k_cold is sized per DB scale so that is rare.

    counts_hot: f32[G, P] dense hot counts (W @ M)
    rows/w:     uint32/int32[G, cap] expanded cold multiset PRE-sort, as
                produced by expand_hybrid (ROW_SENTINEL padding, w=0 there;
                every real entry has w >= 1)
    pack_w_bits: single-key packing as in sort_rle; the single-sort
                candidate extraction additionally spends one key bit on
                the injected flag, so rows must fit 31 - bits (callers
                gate on P < 2^(31-bits); counts are matched-position
                tallies over DISJOINT hot/cold position sets, so
                total <= L < 2^bits)
    Returns (counts int32[G, k], hit_rows uint32[G, k], exact bool[G]).
    """
    G, P = counts_hot.shape
    cap = rows.shape[1]
    # the candidate sort is cap + k_cand wide, so at most cap lanes exist
    # beyond the injected block -- and a C1 of width cap always
    # enumerates EVERY distinct cold row (there are at most cap), so the
    # clamp never weakens the certificate
    k_cold = min(k_cold or k_cand, cap)
    SENT32 = jnp.uint32(0xFFFFFFFF)

    hv, hi = topk_dense(counts_hot, k_cand)          # [G, K2] desc by hot
    hv_i = hv.astype(jnp.int32)
    cand = jnp.minimum(hi, P - 1).astype(jnp.uint32)  # defensive clamp

    # ---- expansion sort with injected candidate markers ----
    if pack_w_bits:
        shift = jnp.uint32(pack_w_bits)
        mask = jnp.uint32((1 << pack_w_bits) - 1)
        packed = jnp.where(rows == ROW_SENTINEL, SENT32,
                           (rows.astype(jnp.uint32) << shift)
                           | w.astype(jnp.uint32))
        inj = cand << shift                           # weight field = 0
        ps = jnp.sort(jnp.concatenate([packed, inj], axis=1), axis=1)
        sent = ps == SENT32
        s = jnp.where(sent, ROW_SENTINEL, ps >> shift)
        wv = jnp.where(sent, 0, (ps & mask).astype(jnp.int32))
    else:
        rows_i = jnp.concatenate([rows, cand], axis=1)
        w_i = jnp.concatenate(
            [w.astype(jnp.int32), jnp.zeros_like(cand, jnp.int32)], axis=1)
        # num_keys=2: zero-weight injected entries sort to their run head
        s, wv = jax.lax.sort((rows_i, w_i), num_keys=2)
        sent = s == ROW_SENTINEL
        wv = jnp.where(sent, 0, wv)

    n = cap + k_cand
    idx = jnp.arange(n, dtype=jnp.int32)[None, :]
    is_start = jnp.concatenate(
        [jnp.ones_like(s[:, :1], dtype=bool), s[:, 1:] != s[:, :-1]],
        axis=1) & ~sent
    change_next = jnp.concatenate(
        [s[:, 1:] != s[:, :-1], jnp.ones_like(s[:, :1], dtype=bool)], axis=1)
    wc = jnp.cumsum(wv, axis=1)
    wc_end = jax.lax.cummin(
        jnp.where(change_next, wc, np.int32(2**31 - 1)), axis=1,
        reverse=True)
    counts_rle = jnp.where(is_start, wc_end - wc + wv, 0).astype(jnp.int32)

    # ---- candidate extraction: ONE (count desc, row asc) sort ----
    # key = [injected? 0 : 1](1 bit) | ~count(cb bits) | row(rb bits),
    # ascending.  An injected entry is the only zero-weight non-sentinel
    # lane of its run and sorts first within it, so it IS the run head and
    # its RLE count is the row's exact cold count.  Exactly k_cand
    # injected heads exist per query (distinct rows), so after the sort
    # the FIRST k_cand lanes are the H2 candidates with their exact cold
    # counts, and the NEXT k_cold lanes are the top cold rows among
    # NON-injected distinct rows -- exactly the C1 the certificate needs:
    # an injected row is already an exact candidate via H2, and an outside
    # row is by definition non-injected, so both the cc bound and the
    # plateau row bound remain valid over the non-injected population.
    # (This replaces a separate cold-top sort plus a width-cap_e top_k of
    # the injected payloads -- the two largest non-RLE costs per chunk.)
    inj_lane = is_start & (wv == 0) & ~sent
    cb = max(pack_w_bits, 1) if pack_w_bits else 16
    if pack_w_bits:
        rb = 31 - pack_w_bits  # top bit flags non-injected
        cmax = jnp.uint32((1 << pack_w_bits) - 1)
        base = (((cmax - counts_rle.astype(jnp.uint32)) << rb)
                | s.astype(jnp.uint32))
        ckey = jnp.where(
            inj_lane, base,
            jnp.where(counts_rle > 0, base | jnp.uint32(0x80000000),
                      SENT32))
        ckey = jnp.sort(ckey, axis=1)
        inj_keys = jax.lax.slice_in_dim(ckey, 0, k_cand, axis=1)
        c1_keys = jax.lax.slice_in_dim(ckey, k_cand, k_cand + k_cold,
                                       axis=1)
        rmask = jnp.uint32((1 << rb) - 1)
        cand_cold_byc = (cmax - (inj_keys >> rb)).astype(jnp.int32)
        cand_s_byc = inj_keys & rmask
        # align with the hot values: re-sort both tiny lists by row asc
        rkey = ((cand_s_byc << cb)
                | jnp.minimum(cand_cold_byc, (1 << cb) - 1
                              ).astype(jnp.uint32))
        rkey = jnp.sort(rkey, axis=1)
        cand_s = rkey >> cb
        cand_cold = (rkey & jnp.uint32((1 << cb) - 1)).astype(jnp.int32)
        csent = c1_keys == SENT32
        cc = jnp.where(
            csent, 0,
            (cmax - ((c1_keys & jnp.uint32(0x7FFFFFFF)) >> rb)
             ).astype(jnp.int32))
        rows_c = jnp.where(csent, ROW_SENTINEL, c1_keys & rmask)
    else:
        pay = jnp.where(
            inj_lane,
            ((s.astype(jnp.uint32) << cb)
             | jnp.minimum(counts_rle, (1 << cb) - 1).astype(jnp.uint32))
            + 1,
            jnp.uint32(0))
        pay_top, _ = jax.lax.top_k(pay, k_cand)
        cand_s = ((pay_top - 1) >> cb)[:, ::-1]              # asc by row
        cand_cold = (((pay_top - 1) & jnp.uint32((1 << cb) - 1))[:, ::-1]
                     ).astype(jnp.int32)
        cc, pos = jax.lax.top_k(counts_rle, k_cold)
        rows_c = jnp.where(cc > 0, jnp.take_along_axis(s, pos, axis=1),
                           ROW_SENTINEL)
    # align the hot values: sort (hi, hv) ascending by row
    hkey = (cand.astype(jnp.uint32) << cb) | hv_i.astype(jnp.uint32)
    hkey = jnp.sort(hkey, axis=1)
    cand_hot = (hkey & jnp.uint32((1 << cb) - 1)).astype(jnp.int32)
    cand_tot = cand_cold + cand_hot
    # largest selected row of the k_cold-th cold-count tier (selection is
    # row-asc within the tier, so the LAST entry is the tier's max
    # selected row); feeds the plateau certificate below
    row_c_last = rows_c[:, -1]
    safe_c = jnp.minimum(rows_c, np.uint32(P - 1)).astype(jnp.int32)
    hot_at_c = jnp.take_along_axis(counts_hot, safe_c, axis=1)
    tot_c = jnp.where(cc > 0, cc + hot_at_c.astype(jnp.int32), 0)
    rows_c = jnp.where(cc > 0, rows_c, ROW_SENTINEL)

    # drop H2 entries already present in C1 (their totals are equal --
    # keeping both would duplicate the row in the final top-k)
    dup = (cand_s[:, :, None] == rows_c[:, None, :]).any(axis=2)
    keep_h = (cand_tot > 0) & ~dup
    cand_rows_u = jnp.where(keep_h, cand_s, ROW_SENTINEL)
    cand_tot_u = jnp.where(keep_h, cand_tot, 0)

    # ---- union top-k with the global (count desc, row asc) tie-break ----
    u_rows = jnp.concatenate([rows_c, cand_rows_u], axis=1)
    u_tot = jnp.concatenate([tot_c, cand_tot_u], axis=1)
    if pack_w_bits:
        up = jnp.where(u_rows == ROW_SENTINEL, SENT32,
                       (u_rows << jnp.uint32(pack_w_bits))
                       | u_tot.astype(jnp.uint32))
        ups = jnp.sort(up, axis=1)
        usent = ups == SENT32
        u_rows = jnp.where(usent, ROW_SENTINEL, ups >> jnp.uint32(pack_w_bits))
        u_tot = jnp.where(
            usent, 0,
            (ups & jnp.uint32((1 << pack_w_bits) - 1)).astype(jnp.int32))
    else:
        u_rows, u_tot = jax.lax.sort((u_rows, u_tot), num_keys=1)
        u_tot = jnp.where(u_rows == ROW_SENTINEL, 0, u_tot)
    top_counts, top_pos = jax.lax.top_k(u_tot, k)
    hit_rows = jnp.take_along_axis(u_rows, top_pos, axis=1)
    hit_rows = jnp.where(top_counts > 0, hit_rows, ROW_SENTINEL)

    # ---- exactness certificate ----
    # tau > bound: no outside row can reach the k-th total.  tau == bound
    # (plateau boundary, the common case on shared-domain data): an
    # outside contender must have EXACTLY the split (cold == cc[k_cand-1],
    # hot == hv[k_cand-1]) -- cold <= c_bound and hot <= h_bound with an
    # equal sum forces equality.  Such a row was excluded from its tier's
    # top-k by the row-asc tie preference, so its row id exceeds every
    # SELECTED tier row: > row_c_last when c_bound > 0 (any cold > 0 row
    # appears in the expansion sort), else > hi[:, -1] (the largest
    # selected hot-tier row; hot-only contenders live in H2's tier).  If
    # our k-th pick's row id rho is <= that bound row R, every missed
    # outside row sorts after ALL our tier picks (picks are row-asc, rho
    # is their max), so the top-k set and order are exact.
    tau = top_counts[:, k - 1]
    c_bound, h_bound = cc[:, -1], hv_i[:, -1]
    bound = c_bound + h_bound
    R = jnp.where(c_bound > 0, row_c_last, hi[:, -1].astype(jnp.uint32))
    rho = hit_rows[:, k - 1]
    exact = ((tau > bound) | (bound <= 0)
             | ((tau == bound) & (tau > 0) & (rho <= R)))
    return top_counts, hit_rows, exact


def hot_lane_mask(whot, run_start):
    """bool[G, L]: lanes belonging to a HOT run, forward-filled from the
    run-start mask (whot > 0) without gathers -- the cummax-of-(2*run_start
    + bit) trick of ops/count.py:expand_run_bitmaps."""
    t = run_start * 2 + (whot > 0).astype(jnp.int32)
    return (jax.lax.cummax(t, axis=1) & 1).astype(jnp.bool_)


def hot_position_bitmaps(offs, hot_lanes, hot_starts, MT, hits):
    """bool[G, K, L]: for each top hit, which query positions sit in a HOT
    run whose set contains the hit (the hot half of StoreMatchPositions,
    search.go:442-452; the cold half comes from member_bitmap_from_rows).

    MT: bf16[P_pad, H] (transposed membership, precomputed at engine init);
    hits: uint32[G, K].  M columns at the k hit rows are row-gathered from
    MT, then combined with the per-lane one-hot over hot_starts by a
    matmul.
    """
    G, L = offs.shape
    P, H = MT.shape
    safe = jnp.minimum(hits, np.uint32(P - 1)).astype(jnp.int32)
    mcols = jnp.take(MT, safe.reshape(-1), axis=0).reshape(
        G, hits.shape[1], H)                                   # [G, K, H]
    ind = ((offs[:, :, None] == hot_starts[None, None, :])
           & hot_lanes[:, :, None]).astype(jnp.bfloat16)       # [G, L, H]
    acc = jnp.einsum("glh,gkh->gkl", ind, mcols,
                     preferred_element_type=jnp.float32)
    return acc > 0.5
