"""Batched device search engine.

The serving pipeline (replacing the per-k-mer LSM pointer chase of reference
search.go:414-440 with static-shaped device batches):

  host: read queries, bucket by length, pad residue codes to int8[B, L+K-1]
  dev : encode 7-mers -> hash probe -> postings CSR expand -> sort ->
        run-length encode -> top_k     (ONE fused jit call per shape bucket)
  host: reference-exact filtering (FilterResults, search.go:189-220),
        position bitmaps, formatting.

Transfer discipline: one packed upload per batch, one small device_get of
(counts, hit_rows, totals) back.
The postings expansion capacity `cap` is a power-of-two bucket chosen
adaptively; when a batch's true postings volume exceeds it, the batch is
re-run at the next bucket (compile caches make this cheap), and beyond
CAP_MAX single queries fall back to a host bincount.  Per-k-mer set ids stay
on device and are pulled lazily, only when position bitmaps are requested.
"""

from __future__ import annotations

from functools import partial
from typing import Dict, List, Sequence

import numpy as np

from .. import codec
from ..index.artifact import DBArtifact

KMER_SIZE = 7
CAP_MAX = 1 << 21
# with hot sets served by the dense matmul path, cold expansion volumes sit
# far below the old 256 floor (p50 ~40 on the skewed bench DB)
CAP_MIN = 1 << 6
# MinKMatch/MinKRatio are monotone in Kmatch and hits are ranked by Kmatch
# desc, so FilterResults keeps a PREFIX of the ranked list; top-k with
# k >= MaxResults is therefore exact.  16 leaves slack for small MaxResults.
TOPK_MIN = 16


def _next_pow2(n: int) -> int:
    return 1 << (int(n) - 1).bit_length() if n > 1 else 1


def _positions_on_device(cap: int, k: int, L: int, B: int) -> bool:
    """Whether the matmul bitmap path fits: both the [B, cap, L] and
    [B, cap, k] bf16 indicators must stay bounded (< ~0.5 GB).  Beyond this
    the lazy host binary-search path wins, since it only touches the few
    kept hits of gate-passing queries."""
    budget = (1 << 17) * 2048
    return cap * L * B <= budget and cap * k * B <= budget


def _cap_bucket(n: int) -> int:
    """Smallest allowed expansion capacity >= n.

    Allowed capacities are {2^k, 1.25*2^k, 1.5*2^k} (all multiples of 64 for
    k >= 8): device execution scales with B*L*cap, so the finer-than-pow2
    grid avoids paying 2x when the workload's postings volume sits just past
    a power of two (e.g. max totals 262 -> cap 320, not 512).
    """
    n = max(int(n), CAP_MIN)
    if n >= CAP_MAX:
        return CAP_MAX
    p = _next_pow2(n)
    h = p >> 1
    for c in (h + (h >> 2), h + (h >> 1)):
        if c >= n:
            return c
    return p


# Whole-batch expansion budget: a batch's [B, cap] expansion (and its sort)
# is clamped to this many elements (64 MB of uint32 rows at 2^24), so a few
# postings-heavy queries can NEVER drag a full 2048-wide batch to a
# multi-GB shape -- they overflow their clamped cap and are re-run in
# RERUN_B-sized sub-batches at the cap they actually need (bounded by
# RERUN_B * CAP_MAX).  Skewed databases (the regime KComb exists for) hit
# this constantly; random benchmarks never do.
MAX_EXPANSION_ELEMS = 1 << 24

# Dense hot-path budget: a hot group's phase 2 materializes counts_hot
# f32[G, P_pad] plus a [G, L, H] one-hot indicator (ops/hotset.py), neither
# of which the cold G*cap budget tracks -- without this cap a hot group at
# G=2048, P_pad=2^20 is a multi-GB intermediate.  4 GB affords hot
# G=1024 at 1M proteins, so wide chunks amortize a hot chunk's fixed costs
# (M stream, counts slab, TAM sorts); the planner's per-lane dense charge
# (engine._hot_lane_rows) keeps small databases from over-widening.
#
# This constant and the planner constants below are inherited from the
# machine the engine was first written for; none was measured on the
# current GPU.  ROADMAP.md Speed 5 re-derives them from a sweep on the card.
HOT_DENSE_BYTES = 4 << 30


# The fixed cost of one phase-2 dispatch, in dispatched expansion rows at
# PIPE_ROWS_PER_S.  The chunker rounds a tail UP to a wider quantized group
# only when the padding rows it adds cost less than the dispatches it
# saves.
DISPATCH_COST_ROWS = 1 << 17
# Quantized phase-2 group widths: every (G, cap) pair is one compiled
# shape, so widths stay coarse -- but heavy caps need a width between 16
# and 256: at cap ~16-40k a 256-query window spans a wide totals quantile
# and pads the expansion heavily; G=64 keeps those chunks near their own
# quantile.
G_QUANTA = (16, 64, 256, 2048)
# A HOT chunk additionally streams the FULL membership matrix M and
# materializes/ranks its counts_hot slab.  These defaults are the LEGACY
# per-lane-merge economics (still used by the sharded engine's planner);
# the single-chip engine derives its own post-TAM values from (H, P) at
# init (see __init__: _hot_chunk_rows / _hot_lane_rows) and passes them to
# _plan_normal_chunks explicitly.
HOT_CHUNK_COST_ROWS = 1 << 18
# Rows of a hot chunk under the LEGACY merge pay ~2x a cold row (the
# candidate-union merge gathers counts_hot at every expanded lane).  Under
# the TAM merge (single-chip) a hot row costs the same as a cold row.
HOT_ROW_COST = 2
# Hardware rates the derived planner constants are computed from: the
# dense bf16 matmul rate and the device-memory bandwidth of one H100 SXM
# (NVIDIA's data sheet: 989 TFLOP/s dense bf16, 3.35 TB/s), the matmul rate
# at an explicit 50% efficiency; and the fused-pipeline gather rate that
# DISPATCH_COST_ROWS is denominated in (inherited, not measured here).
MATMUL_EFFICIENCY = 0.5
MATMUL_FLOPS = 989e12 * MATMUL_EFFICIENCY
MEM_BPS = 3.35e12
PIPE_ROWS_PER_S = 25e6


def _cap_bucket_vec(totals: np.ndarray) -> np.ndarray:
    """_cap_bucket over a whole batch (the scheduler calls it once per
    query; vectorized it is one pass instead of ~30k Python calls/s at
    read-search rates)."""
    n = np.clip(totals.astype(np.int64), CAP_MIN, CAP_MAX)
    # float64 holds these ints exactly; log2 of an exact power of two is
    # exact, so ceil never over-rounds
    p = (1 << np.ceil(np.log2(n)).astype(np.int64))
    h = p >> 1
    c1 = h + (h >> 2)
    c2 = h + (h >> 1)
    cap = np.where(c1 >= n, c1, np.where(c2 >= n, c2, p))
    return np.where(n >= CAP_MAX, CAP_MAX, cap)


def _plan_normal_chunks(normal, totals_l, hot_l, caps_l, cap_pin,
                        groups_for, hot_extra_rows,
                        hot_chunk_rows: int = HOT_CHUNK_COST_ROWS,
                        hot_row_cost: int = HOT_ROW_COST):
    """Chunk the totals-desc `normal` rows (hot class first) into quantized
    phase-2 groups; shared by the single-chip and sharded schedulers.

    Since every chunk dispatches at its own HEAD's cap bucket (caps are
    nonincreasing within a hotness class under the totals-desc order),
    fine-grained cap segmentation is unnecessary: all same-hotness rows
    form one segment and only chunk WIDTH is optimized, per chunk, by the
    measured cost model

        n_chunks * (DISPATCH_COST_ROWS [+ HOT_CHUNK_COST_ROWS])
            + padding_rows * row_cost

    -- a hot chunk pays a large fixed cost (it streams the full membership
    matrix and ranks a dense counts slab) and ~HOT_ROW_COST gather-row
    equivalents per dispatched row (the candidate-union merge re-gathers
    counts_hot at every expanded lane), so hot queries coalesce into few,
    wide chunks while a heavy-cap tail still drops to G=16 rather than pad
    a 256-wide group.

    Width choice is greedy per chunk, by COST PER COVERED QUERY: a wide
    chunk dispatches every lane -- real, spread (a light query under the
    head's cap), and padded -- at cap_head rows, so its waste is
    G*cap_head - sum(totals of covered queries), computable from a prefix
    sum.  This is what keeps a heavy-cap head from pulling hundreds of
    light queries to its cap (their spread waste dominates D) while a
    uniform small-cap tail still rounds up to one wide chunk (its spread
    waste is trivial next to extra dispatches).

    normal: row ids, hot-first then totals-desc within each class;
    groups_for(cap, hot) -> allowed quantized widths (respects the caller's
    expansion/dense budgets and cap pinning); hot_extra_rows() -> the dense
    share one group lane adds in a hot group.  Returns
    [(rows, G, cap, hot)]."""
    chunks: List[tuple] = []
    i0 = 0
    n = len(normal)
    while i0 < n:
        hot0 = hot_l[normal[i0]]
        i1 = i0 + 1
        while i1 < n and hot_l[normal[i1]] == hot0:
            i1 += 1
        seg = normal[i0:i1]
        i0 = i1
        pref = [0]
        for q in seg:
            pref.append(pref[-1] + totals_l[q])
        D = DISPATCH_COST_ROWS + (hot_chunk_rows if hot0 else 0)
        extra = hot_extra_rows() if hot0 else 0
        c_row = hot_row_cost if hot0 else 1
        c0 = 0
        while c0 < len(seg):
            rem = len(seg) - c0
            cap_c = cap_pin or caps_l[seg[c0]]
            G_c, best = None, None
            for g in groups_for(cap_c, hot0):
                take_g = min(g, rem)
                # chunk cost in gather-row equivalents: fixed dispatch +
                # wasted expansion rows (dispatched minus useful; useful
                # rows cost the same under any chunking) + the per-lane
                # dense share of hot groups
                waste = g * cap_c - (pref[c0 + take_g] - pref[c0])
                score = (D + waste * c_row + g * extra) / take_g
                if best is None or score < best:
                    G_c, best = g, score
            take = min(rem, G_c)
            chunks.append((seg[c0 : c0 + take], G_c, cap_c, hot0))
            c0 += take
    return chunks


def _cap_floor(limit: int) -> int:
    """Largest allowed capacity bucket <= limit (>= CAP_MIN)."""
    limit = max(int(limit), CAP_MIN)
    p = 1 << (limit.bit_length() - 1)
    for c in (p + (p >> 1), p + (p >> 2), p):  # 1.5*2^k, 1.25*2^k, 2^k
        if c <= limit:
            return c
    return p  # pragma: no cover


def _cap_clamp(cap: int, B: int) -> int:
    return min(cap, _cap_floor(MAX_EXPANSION_ELEMS // max(B, 1)))


class QueryCounts:
    """Raw counting result for one query: top hits (dense rows) with their
    k-match counts, plus lazily materialized per-k-mer postings slices for
    position lookups.  Slotted plain class: one is built per query, so
    construction cost is on the serving hot path."""

    __slots__ = ("hit_rows", "counts", "_engine", "_batch", "_row",
                 "_n_kmers", "_offs", "_lens", "_bitmaps")

    def __init__(self, hit_rows, counts, _engine=None, _batch=None,
                 _row=0, _n_kmers=0):
        self.hit_rows = hit_rows    # uint32[k'] dense protein rows, count desc
        self.counts = counts        # int32[k']
        self._engine = _engine
        self._batch = _batch
        self._row = _row
        self._n_kmers = _n_kmers
        self._offs = None
        self._lens = None
        self._bitmaps = None        # uint8[k_eff, L] device-computed bitmaps

    def _materialize_slices(self):
        if self._offs is None:
            offs = self._batch.host()[self._row, : self._n_kmers].astype(np.int64)
            starts = self._engine.set_starts_np
            # slice start -> dense set id (strictly increasing starts; the
            # miss sentinel start == P maps to the empty set row n_sets)
            ids = np.searchsorted(starts, offs, side="left")
            self._offs = offs
            self._lens = (starts[ids + 1] - starts[ids]).astype(np.int64)

    @property
    def offs(self) -> np.ndarray:
        self._materialize_slices()
        return self._offs

    @property
    def lens(self) -> np.ndarray:
        self._materialize_slices()
        return self._lens


def _finalize_pending(jax_mod, pending, results, sizes, B_real, batch,
                      engine, min_top: int = 0, partial: bool = False):
    """Shared collect_batch body (single-chip and sharded engines): fetch
    each phase-2 chunk's outputs and build per-query QueryCounts.

    Pending items are (rows, (outs2, pos_dev[, flagged])): flagged chunks
    (the single-chip hot path) carry a per-row `exact` certificate at
    outs2[2] (merge_hot_cold_tam).  Uncertified rows are SKIPPED here --
    their device counts are lower bounds, so neither the result nor the
    min_top gate may use them; the caller (collect_batch) has already
    re-dispatched them through the exact legacy merge and appended those
    chunks to `pending`, which fill the skipped slots when their turn
    comes.

    min_top > 0: rows whose top count is below it become None without
    constructing anything; their position bitmaps are never unpacked
    (host unpackbits over a [G, k, L] group is the other per-row cost).

    All device arrays are fetched in ONE device_get: per-chunk fetches
    would each pay a host-device round trip."""
    want = []
    for _, item in pending:
        outs2, pos_dev = item[0], item[1]
        n = 2 + (1 if (len(item) > 2 and item[2]) else 0) + (1 if pos_dev
                                                             else 0)
        want.append(outs2[:n])
    fetched = jax_mod.device_get(want)
    for (rows, item), arrs in zip(pending, fetched):
        pos_dev = item[1]
        flagged = len(item) > 2 and item[2]
        if flagged:
            ch, hh, ex = arrs[0], arrs[1], arrs[2]
            fb = (~ex).tolist()
        else:
            ch, hh = arrs[0], arrs[1]
            fb = None
        keep = None
        if min_top > 0:
            # counts are sorted desc, so column 0 is each row's top count;
            # padded rows carry zeros and gate out with everything else
            keep = (ch[:, 0] >= min_top).tolist()
        bm = None
        bpos = 0
        if pos_dev:
            packed = arrs[-1]
            if keep is None:
                bm = np.unpackbits(packed, axis=-1,
                                   bitorder="little").view(np.bool_)
            else:
                idx = [j for j in range(len(rows)) if keep[j]]
                if idx:
                    bm = np.unpackbits(packed[idx], axis=-1,
                                       bitorder="little").view(np.bool_)
        # one vectorized pass, then plain ints (numpy-scalar slice
        # bounds cost ~3x an int at 30k queries/s)
        ms = (ch > 0).sum(axis=1).tolist()
        for j, i in enumerate(rows):
            if i >= B_real:  # identity groups include padding rows
                if keep is not None and keep[j]:
                    bpos += 1  # mirrors the idx construction above
                continue
            if fb is not None and fb[j]:
                if keep is not None and keep[j]:
                    bpos += 1
                continue  # a legacy re-run chunk later in `pending` fills it
            if keep is not None and not keep[j]:
                results[i] = None
                continue
            m = ms[j]
            qc = QueryCounts(
                hit_rows=hh[j][:m], counts=ch[j][:m], _engine=engine,
                _batch=batch, _row=i, _n_kmers=sizes[i],
            )
            if bm is not None:
                qc._bitmaps = bm[j] if keep is None else bm[bpos]
            if keep is not None:
                bpos += 1
            results[i] = qc
    if partial:
        return None  # rows skipped for re-runs are filled by a later call
    return [results[i] for i in range(B_real)]


class _BatchIds:
    """Shared handle to a batch's device-resident per-k-mer slice starts;
    pulled to host at most once, and only if some query needs position
    bitmaps (set ids are recovered host-side by searchsorted)."""

    def __init__(self, ids_dev):
        self._dev = ids_dev
        self._np = None

    def host(self) -> np.ndarray:
        if self._np is None:
            self._np = np.asarray(self._dev)
            self._dev = None
        return self._np


class PositionBitmapServing:
    """Position-bitmap lookups shared by the single-chip and sharded engines
    (both keep host-side `postings_np` / set-start views and attach device
    bitmaps to QueryCounts when the batch ran with positions=True)."""

    def position_bitmaps(
        self, qc: "QueryCounts", hit_rows: Sequence[int]
    ) -> Dict[int, List[bool]]:
        """Per-hit bitmaps over query k-mer positions (reference
        StoreMatchPositions, search.go:442-452) as plain bool lists."""
        return {
            k: v.tolist()
            for k, v in self.position_bitmaps_np(qc, hit_rows).items()
        }

    def position_bitmaps_np(
        self, qc: "QueryCounts", hit_rows: Sequence[int]
    ) -> Dict[int, np.ndarray]:
        """position_bitmaps as numpy bool arrays (the serving pipelines'
        form: translated search consumes one bitmap per hit per ORF, so
        per-element Python lists are too slow).  Served straight from the
        device-computed bit-packed bitmaps when the batch was dispatched
        with positions=True; otherwise via vectorized host binary search in
        the postings slices."""
        if qc._bitmaps is not None:
            idx = {int(r): j for j, r in enumerate(qc.hit_rows)}
            n = qc._n_kmers
            bmq = qc._bitmaps
            if bmq.dtype != np.bool_:  # legacy uint8 0/1 bitmaps
                bmq = bmq.view(np.bool_)
            out = {
                int(h): bmq[idx[int(h)], :n]
                for h in hit_rows
                if int(h) in idx
            }
            # requested rows outside the device top-k (callers today only
            # pass subsets of hit_rows, but the host path below answers
            # arbitrary rows -- keep both paths' contracts identical)
            rest = [h for h in hit_rows if int(h) not in idx]
            if rest:
                out.update(self._host_bitmaps_np(qc, rest))
            return out
        return self._host_bitmaps_np(qc, hit_rows)

    def _host_bitmaps_np(self, qc: "QueryCounts", hit_rows) -> Dict[int, np.ndarray]:
        from ..ops.count import member_np

        hits = np.asarray(list(hit_rows), dtype=np.uint32)
        if hits.size == 0 or qc.offs.size == 0:
            return {}
        found = member_np(self.postings_np, qc.offs, qc.lens, hits)
        return {int(h): found[j] for j, h in enumerate(hits)}


class SearchEngine(PositionBitmapServing):
    """Holds the device-resident index and runs batched searches."""

    def __init__(self, art: DBArtifact, hot: bool = True):
        if not art.indexed:
            raise ValueError("database is not indexed; run index_db first")
        if getattr(art, "index_shards", 0):
            raise ValueError(
                f"this database was built with {art.index_shards} index "
                f"shards; serve it with parallel.dist.ShardedSearchEngine "
                f"on a {art.index_shards}-shard mesh")
        import jax
        import jax.numpy as jnp

        self._jax = jax
        self.art = art

        # the cuckoo table carries each k-mer's (start, len) inline, so the
        # device probe needs no set-offsets indirection (ops/probe.py)
        self.table = jnp.asarray(np.asarray(art.hash_table))
        so = np.asarray(art.set_offsets)
        if so.size and int(so[-1]) >= 2**31:
            raise ValueError(
                "postings larger than 2^31 need a sharded index: rebuild "
                "with index_db(n_shards > 1) and serve with "
                "ShardedSearchEngine")
        # +sentinel "empty set" row used for probe misses and padding lanes:
        # a miss reports start == P (== set_starts_np[n_sets]), len 0, and
        # np.searchsorted(set_starts_np, start) recovers the dense set id
        # (starts are strictly increasing; P maps to the sentinel n_sets)
        self.set_starts_np = np.concatenate([so, so[-1:]]).astype(np.int32)
        self.postings_np = np.asarray(art.postings)
        # device copy padded to a whole number of 128-lane tiles: the tile
        # tier of expand_hybrid bitcasts it to [P//128, 128] rows, and a
        # long run near the array end may cover the final partial tile
        # (padding lanes are always masked to ROW_SENTINEL)
        pad = (-len(self.postings_np)) % 128
        self.postings = jnp.asarray(
            np.concatenate([self.postings_np,
                            np.zeros(pad, np.uint32)])
            if pad else self.postings_np)
        self.n_sets = int(so.size - 1)
        self.miss_start = int(so[-1]) if so.size else 0
        self.hash_log2 = art.hash_log2
        self._cap_hint = CAP_MIN

        # hot-set dense counting (ops/hotset.py): the longest postings sets
        # are counted by one matmul against a precomputed membership
        # matrix instead of being expanded -- on skewed databases the
        # per-entry postings gather dominates device time otherwise.
        # None => feature off (small/random DBs,
        # or P beyond the dense budget) and everything runs the plain path.
        from ..ops import hotset

        self.hot_starts = None
        self.hot_thresh = 1 << 30
        self.M = self.MT = None
        # post-tile hot budget: beyond ~2^18 proteins the dense per-query
        # cost (2*H*P flops + the counts_hot slab) grows linearly in H*P
        # while a demoted set costs only len/128 tile-row gathers per
        # occurrence; small DBs keep the wide net.
        h_max = 2048 if art.num_proteins <= (1 << 18) else 1024
        hot = (hotset.select_hot_sets(so, art.num_proteins, h_max=h_max)
               if hot else None)
        self._hot_chunk_rows = HOT_CHUNK_COST_ROWS
        self._hot_lane_rows = 0
        if hot is not None:
            hot_starts_np, self.hot_thresh, P_pad = hot
            self.hot_starts = jnp.asarray(hot_starts_np)
            self.M = hotset.build_membership(self.postings_np, so,
                                             hot_starts_np, P_pad)
            self.MT = self.M.astype(jnp.bfloat16).T  # positions path only
            # post-TAM planner economics: a hot chunk's fixed cost is the
            # M stream (2*H*P bytes); each group lane adds the dense flops
            # plus its counts_hot slab share.  Converted to the planner's
            # gather-row-equivalents at the fused pipeline rate.
            H = int(hot_starts_np.shape[0])
            self._hot_chunk_rows = int(
                2 * H * P_pad / MEM_BPS * PIPE_ROWS_PER_S) + (1 << 16)
            # slab share: bf16 counts_hot write + its topk read (4 bytes
            # per protein per lane total)
            self._hot_lane_rows = int(
                (2 * H * P_pad / MATMUL_FLOPS + 4 * P_pad / MEM_BPS)
                * PIPE_ROWS_PER_S)

        # two-phase dispatch: phase 1 probes + dedups the whole batch,
        # splits hot runs out of the expansion, and reports exact per-query
        # COLD totals; the host then schedules phase 2 in totals-sorted
        # GROUPS, each at the cap bucket it needs.  One postings-heavy query
        # therefore never drags 2048 light queries to its expansion capacity
        # (a ~6x device-time tax on skewed data).
        self._p1 = jax.jit(
            partial(_phase1_impl, hash_log2=self.hash_log2,
                    miss_start=self.miss_start,
                    hot_thresh=self.hot_thresh),
            static_argnames=("width",),
        )
        self._p2 = jax.jit(
            _phase2_grouped_impl,
            static_argnames=("cap_s", "cap_t", "k", "positions",
                             "pack_w_bits"),
        )
        self._p2h = jax.jit(
            _phase2_hot_impl,
            static_argnames=("cap_s", "cap_t", "k", "positions",
                             "pack_w_bits", "k_cold"),
        )
        # exact per-lane legacy merge, used only to re-run the rare rows
        # whose TAM certificate fails (collect_batch); G is pinned to
        # RERUN_B and caps to a pow4 ladder so its compile grid stays tiny
        self._p2h_full = jax.jit(
            _phase2_hot_legacy_impl,
            static_argnames=("cap_s", "cap_t", "k", "positions",
                             "pack_w_bits"),
        )
        # cold-candidate width of the TAM merge: wide enough to enumerate
        # most queries' distinct cold rows (the certificate then binds
        # through the hot side).  Extraction is O(cap) at any width
        # (packed-sort slice); the width's real cost is the [G, k_cold]
        # hot-at-cold gather.  At 1M proteins 1024 enumerates most queries'
        # distinct cold rows outright -- each rerun costs a G=64 legacy
        # chunk incl. a full membership stream, far more than the wider
        # gather.
        P = art.num_proteins
        self._k_cold = 64 if P <= (1 << 15) else (
            128 if P <= (1 << 18) else 1024)
        # row selection is jitted separately so _p2's compiled shapes depend
        # only on (G, L, caps, k, positions), not on the source batch size
        self._sel = jax.jit(
            lambda arrs, idx: tuple(jnp.take(a, idx, axis=0) for a in arrs)
        )

    # ------------------------------------------------------------------
    # Core batched counting
    # ------------------------------------------------------------------

    def count_batch(
        self, seqs: Sequence[str], sizes: Sequence[int], k: int,
        positions: bool = False,
    ) -> List[QueryCounts]:
        """Count k-mer hits for a batch of equal-bucket queries.

        seqs: query sequences; sizes: SizeInKmer per query (kmers [0, size)
        are searched, which already excludes a trailing '*')."""
        return self.resolve_batch(self.dispatch_batch(seqs, sizes, k,
                                                      positions=positions))

    def dispatch_batch(self, seqs: Sequence[str], sizes: Sequence[int], k: int,
                       positions: bool = False, cap: int = 0,
                       adapt_hint: bool = True):
        """Asynchronously dispatch phase 1 (probe + dedup + exact totals) of
        one batch; returns a handle for resolve_batch.  JAX dispatch is
        async, so several batches can be in flight, overlapping
        upload/compute/fetch across batches (the analogue of the reference's
        pipelined worker pools).

        cap pins every phase-2 group's expansion capacity (warmup uses this
        so the intended shape buckets actually compile); adapt_hint is kept
        for interface stability (the group scheduler always uses this
        batch's own exact totals, so there is no cross-batch hint to
        pollute)."""
        import jax.numpy as jnp

        B_real = len(seqs)
        if B_real == 0:
            return None
        # batch dimension rounds to a power of two (min 16): a tail batch of
        # arbitrary size would otherwise compile a fresh program.  Padding
        # rows have n_kmers=0 and never produce hits.
        B = _next_pow2(max(B_real, 16))
        if B != B_real:
            seqs = list(seqs) + [""] * (B - B_real)
        L = _next_pow2(max(max(sizes), 8))
        width = L + KMER_SIZE - 1
        n_kmers = np.zeros(B, dtype=np.int32)
        n_kmers[:B_real] = sizes

        # ship 7 residues per uint32 (4.57 bits/residue) and unpack on
        # device; the native packer fuses padding + base-22 packing in one
        # multithreaded pass
        from .. import native

        wire = native.pack_queries(seqs, width)
        if wire is None:
            wire = codec.pack_codes7(codec.pad_codes_batch(seqs, width))

        outs1 = self._p1(self.table, jnp.asarray(wire), jnp.asarray(n_kmers),
                         width=width)
        totals_s, totals_t, hot_sums = outs1[7], outs1[8], outs1[9]
        # only the tiny exact-totals vectors come back eagerly; everything
        # else stays on device for the phase-2 groups
        totals_s.copy_to_host_async()
        totals_t.copy_to_host_async()
        hot_sums.copy_to_host_async()
        return (outs1, list(sizes), k, L, positions, cap)

    # Sub-batch size for overflow re-runs: postings-heavy outliers re-run in
    # chunks of RERUN_B at the (pow2) cap they need, so peak device memory
    # stays RERUN_B * CAP_MAX elements (~134 MB of uint32 rows) instead of a
    # whole batch at CAP_MAX (16 GB at B=2048).
    RERUN_B = 16
    # Phase-2 group width: large enough that per-group sort/top_k stay
    # efficient, small enough that a group's cap tracks its own totals
    # quantile instead of the batch max.
    GROUP_B = 256

    def resolve_batch(self, handle, min_top: int = 0) -> List[QueryCounts]:
        """schedule_batch + collect_batch in one call (see both)."""
        return self.collect_batch(self.schedule_batch(handle), min_top)

    def _hot_g_max(self, L: int) -> int:
        """Largest (pow2) hot-group width within the dense-path budget."""
        H = int(self.hot_starts.shape[0])
        P_pad = int(self.M.shape[1])
        per_g = 4 * max(P_pad, L * H)
        return max(16, 1 << max(0, (HOT_DENSE_BYTES // per_g).bit_length() - 1))

    def _quantized_groups(self, cap: int, B: int, hot: bool,
                          L: int) -> List[int]:
        """The group widths schedule_batch can emit for this (cap, hot, L):
        G_QUANTA clamped by the expansion and dense-path budgets.  Hot
        groups additionally get the 1024 rung: their fixed per-chunk costs
        (M stream + counts_hot slab + TAM sorts) dominate at 1M scale, so
        the planner wants the widest chunk the dense budget affords.
        warmup iterates exactly this set, so a warmed engine never compiles
        a new phase-2 shape at serving time."""
        g_budget = max(16, 1 << (MAX_EXPANSION_ELEMS // cap).bit_length() - 1)
        quanta = G_QUANTA
        if hot and self.hot_starts is not None:
            g_budget = min(g_budget, self._hot_g_max(L))
            quanta = tuple(sorted(set(G_QUANTA) | {1024}))
        return [g for g in quanta if g <= min(g_budget, B) or g == 16]

    def schedule_batch(self, handle):
        """Schedule phase 2 from the batch's exact totals: group queries,
        dispatch every phase-2 chunk asynchronously, and return a handle
        for collect_batch.  Splitting scheduling from collection lets a
        serving loop enqueue the next batch's device work before paying
        this batch's host-side finalization (the device never idles
        between batches).

        Queries are sorted by their phase-1 totals and processed in
        coalesced groups, each at the smallest cap bucket covering its
        heaviest member -- so the expansion volume tracks the workload's
        totals distribution instead of its max.  Outliers above the group
        budget re-run in RERUN_B chunks (bounded by RERUN_B * CAP_MAX);
        beyond CAP_MAX a query falls back to an unbounded host bincount."""
        if handle is None:
            return None
        (outs1, sizes, k, L, positions, cap_pin) = handle
        offs = outs1[0]
        ts_h, tt_h, hot_h = self._jax.device_get(
            (outs1[7], outs1[8], outs1[9]))
        # effective expansion volume: tile rows pay 128 sort lanes each
        totals_h = ts_h + 128 * tt_h
        B = int(offs.shape[0])
        B_real = len(sizes)
        max_total = int(totals_h[:B_real].max()) if B_real else 0
        self._cap_hint = _cap_bucket(max_total)  # diagnostic only

        batch_ids = _BatchIds(offs)
        k_full = _next_pow2(max(k, TOPK_MIN))
        results: Dict[int, QueryCounts] = {}

        G = min(self.GROUP_B, B)
        limit_g = _cap_floor(MAX_EXPANSION_ELEMS // G)
        # hot queries first (they share the matmul-path groups), then
        # cold-only; within each class totals-sorted so group caps track
        # the workload's totals distribution instead of its max
        order = np.lexsort((-totals_h[:B_real],
                            hot_h[:B_real] == 0)).tolist()
        totals_l = totals_h.tolist()  # plain ints: the segment loop below
        ts_l = ts_h.tolist()
        tt_l = tt_h.tolist()
        hot_l = (hot_h > 0).tolist()  # touches every query once in Python
        caps_l = np.minimum(_cap_bucket_vec(totals_h), limit_g).tolist()
        normal: List[int] = []
        chunks: List[tuple] = []  # (rows, G_c, eff_cap, hot)
        heavy: List[int] = []
        for i in order:
            t = totals_l[i]
            if t > CAP_MAX:
                results[i] = self._count_host_row(batch_ids, i, sizes[i],
                                                  k_full)
            elif t > limit_g and not cap_pin:
                heavy.append(i)
            else:
                normal.append(i)

        def any_hot(rows):
            return self.hot_starts is not None and any(
                hot_l[i] for i in rows)

        # outliers: narrow chunks at plain pow2 caps, width chosen by the
        # same dispatch-vs-padding trade as the bulk.  A fixed RERUN_B=16
        # pads heavily when the single heaviest query (totals ~8x the
        # next) drags 15 lighter heavies to its cap.
        c0 = 0
        while c0 < len(heavy):
            rem = len(heavy) - c0
            cap_c = _next_pow2(max(totals_l[heavy[c0]], CAP_MIN))
            G_c, best = self.RERUN_B, None
            for g in (4, self.RERUN_B):
                take = min(g, rem)
                waste = g * cap_c - sum(
                    totals_l[i] for i in heavy[c0 : c0 + take])
                score = (DISPATCH_COST_ROWS + waste) / take
                if best is None or score < best:
                    G_c, best = g, score
            rows = heavy[c0 : c0 + G_c]
            c0 += G_c
            chunks.append((rows, G_c, None, any_hot(rows)))

        # the bulk: shared cost-model chunker (see _plan_normal_chunks); G
        # stays quantized to G_QUANTA -- every extra (G, caps) tuple is one
        # more compiled shape
        def groups_for(cap_c, hot0):
            if cap_pin:  # warmup pins caps; only the dense budget clamps
                g_budget = (min(B, self._hot_g_max(L))
                            if hot0 and self.hot_starts is not None else B)
                return [g for g in G_QUANTA if g <= g_budget or g == 16]
            return self._quantized_groups(cap_c, B, hot0, L)

        if self.hot_starts is None:
            hot_l = [False] * B
        chunks.extend(_plan_normal_chunks(
            normal, totals_l, hot_l, caps_l, cap_pin, groups_for,
            lambda: self._hot_lane_rows,
            hot_chunk_rows=self._hot_chunk_rows,
            # the TAM merge gathers counts_hot only at candidate lanes, so
            # a hot expansion row costs the same as a cold one
            hot_row_cost=1))

        # the planner chunks on EFFECTIVE volume; each chunk then gets its
        # own two-tier capacities from its members' per-tier maxima (pow2
        # tile-row buckets: the tile tier's shape grid stays coarse)
        def tier_caps(rows, rerun):
            max_s = max(ts_l[i] for i in rows)
            max_t = max(tt_l[i] for i in rows)
            if rerun:
                cs = min(_next_pow2(max(max_s, CAP_MIN)), CAP_MAX)
            else:
                cs = cap_pin or _cap_bucket(max_s)
            # pow2 tile-row ladder with a 32-row floor: few compiled
            # shapes, <=2x row padding (each padded row costs one masked
            # 512 B gather + 128 sentinel sort lanes)
            ct = max(32, _next_pow2(max_t)) if max_t else 0
            return cs, ct

        # a fully uniform batch is ONE whole-batch group: skip the row
        # permutation gather entirely (padding rows have no k-mers)
        identity = (len(chunks) == 1 and not results
                    and len(chunks[0][0]) == B_real and chunks[0][1] == B)

        pending = []
        for rows, G_c, eff_cap, hot in chunks:
            cap_s, cap_t = tier_caps(rows, eff_cap is None)
            cap_e = cap_s + 128 * cap_t
            # tier_caps pads each tier to its own bucket, which can
            # overshoot the planner's effective-cap budget by up to ~4x:
            # re-split the chunk at the width the true cap_e
            # affords (2x slack tolerates ordinary bucket rounding without
            # fragmenting; sub-chunks recompute their own, tighter caps)
            if (not identity and G_c > 16
                    and G_c * cap_e > 2 * MAX_EXPANSION_ELEMS):
                g_ok = max(g for g in G_QUANTA
                           if g <= max(2 * MAX_EXPANSION_ELEMS // cap_e, 16))
                for s0 in range(0, len(rows), g_ok):
                    sub = rows[s0 : s0 + g_ok]
                    cs, ct = tier_caps(sub, eff_cap is None)
                    pending.append(
                        (sub, self._dispatch_group(outs1, sub, g_ok, cs, ct,
                                                   k_full, L, positions,
                                                   hot)))
                continue
            if identity:
                rows = list(range(B))
            pending.append(
                (rows, self._dispatch_group(outs1, rows, G_c, cap_s, cap_t,
                                            k_full, L, positions, hot,
                                            identity=identity))
            )
        rerun_ctx = (outs1, ts_l, tt_l, k_full, L, positions)
        return [pending, results, sizes, B_real, batch_ids, rerun_ctx,
                None]

    def prefetch_batch(self, sched, min_top: int = 0):
        """Advance this batch as far as possible without touching the
        device queue's tail: read its TAM certificates (blocks only on its
        OWN chunks, which sit at the queue head), dispatch any legacy
        re-run chunks (async), and finalize the PRIMARY chunks' per-query
        results on the host.

        Serving loops call this for every scheduled batch before
        collecting any: a re-run dispatched lazily at collect time lands
        behind every later batch's device work (its queue latency is then
        exposed, and the host finalize runs serially after it), while this
        host work overlaps the device.  collect_batch then only finalizes the
        re-run tail.  min_top must match the later collect_batch call
        (rows are gated here); collect_batch calls this lazily for
        callers that don't."""
        if sched is None or sched[6] is not None:
            return sched
        pending, results, sizes, B_real, batch_ids, rerun_ctx = sched[:6]
        hot_items = [(rows, item[0][2]) for rows, item in pending
                     if len(item) > 2 and item[2]]
        # one round trip for every certificate vector
        exs = self._jax.device_get([a for _, a in hot_items])
        flagged: List[int] = []
        for (rows, _), ex in zip(hot_items, exs):
            flagged += [i for j, i in enumerate(rows)
                        if i < B_real and not ex[j] and i not in results]
        n_primary = len(pending)
        if flagged:
            pending.extend(self._dispatch_legacy(rerun_ctx, flagged))
        _finalize_pending(self._jax, pending[:n_primary], results, sizes,
                          B_real, batch_ids, self, min_top, partial=True)
        sched[6] = n_primary
        return sched

    def collect_batch(self, sched, min_top: int = 0) -> List[QueryCounts]:
        """Fetch the scheduled phase-2 chunk outputs (already copied to the
        host asynchronously) and finalize per-query results.

        Hot chunks carry the TAM exactness certificate; rows it fails for
        (rare -- see merge_hot_cold_tam) are re-dispatched through the
        exact legacy merge in RERUN_B-wide chunks (prefetch_batch), and
        only that small tail is finalized here -- the primary chunks were
        finalized by prefetch_batch, overlapped with later batches'
        device work.

        min_top > 0 gates rows vectorized BEFORE any per-query work: a row
        whose top count is below it resolves to None instead of a
        QueryCounts (the translated-search drivers discard such ORFs
        outright, search_nucleotide.go:116 -- ~3/4 of all ORFs on real
        reads, so skipping their construction and bitmap unpack is a
        measurable share of fastq host time)."""
        if sched is None:
            return []
        sched = self.prefetch_batch(sched, min_top)
        pending, results, sizes, B_real, batch_ids = sched[:5]
        return _finalize_pending(self._jax, pending[sched[6]:], results,
                                 sizes, B_real, batch_ids, self, min_top)

    def _dispatch_legacy(self, rerun_ctx, flagged: List[int]):
        """Re-dispatch TAM-uncertified rows through the per-lane legacy
        merge: RERUN_B-wide chunks, totals-sorted, pow2 tier caps (the
        heavy-outlier rerun ladder -- per-lane cost matters here since the
        legacy merge gathers counts_hot at EVERY lane, so cap padding is
        paid double)."""
        (outs1, ts_l, tt_l, k_full, L, positions) = rerun_ctx
        flagged = sorted(flagged, key=lambda i: -(ts_l[i] + 128 * tt_l[i]))
        out = []
        c0 = 0
        while c0 < len(flagged):
            rem = len(flagged) - c0
            # width by the usual dispatch-vs-padding trade, with the
            # legacy kernel's fixed M-stream charged per chunk (a G=16
            # rerun chunk otherwise spends more streaming M than on its
            # 16 rows) and its per-lane counts_hot gather doubling the
            # padding cost
            head_eff = ts_l[flagged[c0]] + 128 * tt_l[flagged[c0]]
            G_c, best = self.RERUN_B, None
            for g in (self.RERUN_B, 64):
                take = min(g, rem)
                waste = g * head_eff - sum(
                    ts_l[i] + 128 * tt_l[i]
                    for i in flagged[c0 : c0 + take])
                score = (DISPATCH_COST_ROWS + self._hot_chunk_rows
                         + 2 * waste) / take
                if best is None or score < best:
                    G_c, best = g, score
            rows = flagged[c0 : c0 + G_c]
            c0 += G_c
            cap_s = _next_pow2(max(max(ts_l[i] for i in rows), CAP_MIN))
            max_t = max(tt_l[i] for i in rows)
            cap_t = max(32, _next_pow2(max_t)) if max_t else 0
            out.append((rows, self._dispatch_group(
                outs1, rows, G_c, min(cap_s, CAP_MAX), cap_t,
                k_full, L, positions, hot=True, legacy=True)))
        return out

    def _dispatch_group(self, outs1, rows: List[int], G: int, cap_s: int,
                        cap_t: int, k_full: int, L: int, positions: bool,
                        hot: bool = False, identity: bool = False,
                        legacy: bool = False):
        """Dispatch one phase-2 group (async); returns (outputs, pos_dev,
        flagged) where flagged marks hot chunks whose outputs carry the
        TAM exactness certificate at index 2 (_phase2_hot_impl).
        identity=True skips the row-permutation gather (rows == range(B));
        legacy=True routes through the exact per-lane merge (certificate
        re-runs)."""
        import jax.numpy as jnp

        if identity:
            sel = outs1[:7]
        else:
            idx = np.zeros(G, dtype=np.int32)
            idx[: len(rows)] = rows
            sel = self._sel(tuple(outs1[:7]), jnp.asarray(idx))
        offs, cum_s, wstart, run_start, whot, cum_t, lens_l = sel
        cap_e = cap_s + 128 * cap_t
        k2 = min(k_full, cap_e)
        # the hot path ranks k_full candidates (its dense top-k is not cap-
        # bounded), so its bitmap-cost check must use k_full, not k2
        pos_dev = positions and _positions_on_device(
            cap_e, k_full if hot else k2, L, G)
        pw = self._pack_w_bits(L)
        if legacy:
            outs2 = self._p2h_full(self.postings, self.M, self.MT,
                                   self.hot_starts, offs, cum_s, wstart,
                                   run_start, whot, cum_t, lens_l,
                                   cap_s=cap_s, cap_t=cap_t, k=k_full,
                                   positions=pos_dev, pack_w_bits=pw)
            for arr in outs2:
                arr.copy_to_host_async()
            return outs2, pos_dev  # no certificate: the legacy merge is exact
        if hot:
            outs2 = self._p2h(self.postings, self.M, self.MT,
                              self.hot_starts, offs, cum_s, wstart,
                              run_start, whot, cum_t, lens_l, cap_s=cap_s,
                              cap_t=cap_t, k=k_full, positions=pos_dev,
                              pack_w_bits=pw, k_cold=self._k_cold)
        else:
            outs2 = self._p2(self.postings, offs, cum_s, wstart, run_start,
                             cum_t, lens_l, cap_s=cap_s, cap_t=cap_t, k=k2,
                             positions=pos_dev, pack_w_bits=pw)
        for arr in outs2:
            arr.copy_to_host_async()
        return outs2, pos_dev, hot

    def _pack_w_bits(self, L: int) -> int:
        """Single-key sort packing width for this query length: weights and
        counts are matched-position tallies <= L, so L.bit_length() low bits
        hold them; rows (protein ids) must fit the remaining 32 bits with
        the all-ones sentinel excluded.  0 disables packing (two-operand
        comparator sort) -- only databases beyond ~2^22 proteins at L=512
        lose the fast path."""
        bits = max(int(L).bit_length(), 1)
        if self.art.num_proteins < (1 << (32 - bits)) - 1:
            return bits
        return 0

    def _count_host_row(self, batch_ids: "_BatchIds", i: int, n_kmers: int, k: int) -> QueryCounts:
        """Unbounded host fallback (np.bincount) for postings-heavy queries."""
        offs = batch_ids.host()[i, :n_kmers].astype(np.int64)
        starts = self.set_starts_np
        ids = np.searchsorted(starts, offs, side="left")
        lens = (starts[ids + 1] - starts[ids]).astype(np.int64)
        segs = [
            self.postings_np[int(o) : int(o) + int(l)]
            for o, l in zip(offs, lens)
            if l > 0
        ]
        if segs:
            rows = np.concatenate(segs)
            bc = np.bincount(rows)
            nz = np.flatnonzero(bc)
            order = np.lexsort((nz, -bc[nz]))[:k]
            hit_rows = nz[order].astype(np.uint32)
            counts = bc[hit_rows].astype(np.int32)
        else:
            hit_rows = np.empty(0, np.uint32)
            counts = np.empty(0, np.int32)
        qc = QueryCounts(hit_rows=hit_rows, counts=counts, _engine=self,
                         _n_kmers=n_kmers)
        qc._offs = offs
        qc._lens = lens
        return qc

    # Expansion-cap ladder warmup compiles by default: the buckets a skewed
    # workload's scheduler actually emits (observed grid on the bench DBs);
    # workloads whose totals exceed the ladder still pay a first-hit compile.
    WARM_CAPS = (CAP_MIN, 80, 96, 128, 160, 192, 256, 320, 384, 512)

    def warmup(self, batch_sizes=(16, 2048), lengths=(64, 128, 256, 512),
               positions=(False, True), caps=None,
               cap_ts=(0, 32, 128)) -> None:
        """Pre-compile the serving shape grid: phase 1 per (B, L), and EVERY
        phase-2 shape the group scheduler can emit for the cap ladder --
        (G, L, cap, positions) for the cold path and the hot matmul path,
        with G iterating exactly self._quantized_groups (so a warmed engine
        triggers no new _p2/_p2h compiles on a workload inside the ladder;
        tests/test_engine.py asserts this).

        Every shape costs a compile, so a server's first odd-shaped query
        would otherwise stall; run this (typically in
        a background thread at startup) to populate the in-process and
        persistent compile caches.  Shapes are ordered most-likely-first
        (no-position bulk shapes before position/hot tails) so early
        coverage matters even if the thread is still running at first
        query.  Warmup batches pin their cap and never touch the adaptive
        cap hint; errors are ignored -- warmup is best effort."""
        caps = tuple(caps) if caps else self.WARM_CAPS
        # phase 1 + scheduler plumbing, one dispatch per (B, L, positions)
        for pos in positions:
            for B in batch_sizes:
                for L in lengths:
                    try:
                        seq = "A" * min(L + KMER_SIZE - 1, 64)
                        seqs = [seq] * B
                        sizes = [len(seq) - KMER_SIZE + 1] * (B - 1) + [L]
                        self.resolve_batch(self.dispatch_batch(
                            seqs, sizes, k=10, positions=pos,
                            cap=CAP_MIN, adapt_hint=False))
                    except Exception:
                        pass
        # phase-2 shapes, compiled directly with zero inputs (a dispatch
        # can't steer synthetic text onto arbitrary caps or hot sets).
        # cap_t > 0 shapes are warmed too: any chunk containing a postings
        # run >= T_SPLIT dispatches a two-tier shape, which on skewed data
        # is the COMMON case, not the tail -- the tile-row
        # ladder here covers the serving grid's low rungs.
        B_max = max(batch_sizes)
        k_full = _next_pow2(max(10, TOPK_MIN))
        hots = (False, True) if self.hot_starts is not None else (False,)
        for pos in positions:
            for hot in hots:
                for cap_t in cap_ts:
                    for capv in caps:
                        cap_eff = capv + 128 * cap_t
                        for L in lengths:
                            for G in self._quantized_groups(cap_eff, B_max,
                                                            hot, L):
                                try:
                                    self._warm_p2(G, L, capv, cap_t,
                                                  k_full, pos, hot)
                                except Exception:
                                    pass

    def _warm_p2(self, G: int, L: int, cap: int, cap_t: int, k_full: int,
                 pos: bool, hot: bool) -> None:
        """Compile one phase-2 shape (zero-input dispatch, result discarded)."""
        import jax.numpy as jnp

        z = jnp.zeros((G, L), jnp.int32)
        offs = jnp.full((G, L), self.miss_start, jnp.int32)
        pw = self._pack_w_bits(L)
        cap_e = cap + 128 * cap_t
        if hot:
            self._p2h(self.postings, self.M, self.MT, self.hot_starts,
                      offs, z, z + 1, z, z, z, z, cap_s=cap, cap_t=cap_t,
                      k=k_full, positions=pos and _positions_on_device(
                          cap_e, k_full, L, G), pack_w_bits=pw,
                      k_cold=self._k_cold)
        else:
            k2 = min(k_full, cap_e)
            self._p2(self.postings, offs, z, z + 1, z, z, z, cap_s=cap,
                     cap_t=cap_t, k=k2,
                     positions=pos and _positions_on_device(cap_e, k2, L, G),
                     pack_w_bits=pw)

# ---------------------------------------------------------------------------
# jitted implementation
# ---------------------------------------------------------------------------


# Run-length threshold splitting the cold expansion into its two tiers
# (ops/count.expand_hybrid): runs shorter than this expand element-by-
# element; longer runs expand as full 512 B postings TILES (a gather row
# costs about the same at any width), cutting the gather count
# ~n/128-fold.  64 balances the tile parts' 128-lane sentinel padding
# (sorted and RLE'd like cap padding) against saved gathers.
T_SPLIT = 64


def _phase1_impl(table, codes, n_kmers, *, hash_log2, miss_start,
                 hot_thresh=1 << 30, width: int = 0):
    """codes: int8/int32[B, L+6] residue codes, or (width>0) a packed wire
    format with width == L+6: uint32 from codec.pack_codes7 (the serving
    path) or uint16 from codec.pack_codes3 (dtype selects the decoder).

    The cuckoo probe resolves each k-mer's (start, len) postings slice in
    exactly two row-gathers (ops/probe.py); masked lanes and misses get
    (miss_start, 0).

    Runs whose slice length >= hot_thresh are HOT (served by the dense
    matmul path, ops/hotset.py): their lengths are zeroed out of the
    expansion cumsum and their run weights reported separately in whot, so
    the returned totals are COLD expansion volume only."""
    import jax
    import jax.numpy as jnp

    from ..ops.probe import probe_slices

    if width:
        if codes.dtype == jnp.uint32:
            codes = codec.unpack_codes7_jnp(codes, width)
        else:
            codes = codec.unpack_codes3_jnp(codes, width)
    L = codes.shape[1] - (KMER_SIZE - 1)
    codes = codes.astype(jnp.int32)
    kmers = jax.vmap(lambda c: codec.encode_kmers_jnp(c, L))(codes)
    starts, lens = probe_slices(table, kmers, hash_log2, miss_start)
    lane = jnp.arange(L, dtype=jnp.int32)[None, :]
    in_query = lane < n_kmers[:, None]
    offs = jnp.where(in_query, starts, jnp.uint32(miss_start)).astype(jnp.int32)
    lens = jnp.where(in_query, lens, 0).astype(jnp.int32)
    # query-time KComb: expand each distinct consecutive slice once, with
    # its position multiplicity as a weight (ops/count.py:dedup_runs)
    from ..ops.count import dedup_runs

    lens_u, wstart, run_start = dedup_runs(offs, lens)
    hot = lens >= jnp.int32(hot_thresh)
    whot = jnp.where(hot & (lens_u > 0), wstart, 0).astype(jnp.int32)
    # two-tier cold split (expand_hybrid): SHORT runs expand by element,
    # LONG runs by covering 128-wide postings tiles
    long = (~hot) & (lens_u >= jnp.int32(T_SPLIT))
    lens_s = jnp.where(hot | long, 0, lens_u)
    cum_s = jnp.cumsum(lens_s, axis=1).astype(jnp.int32)
    rows_l = jnp.where(long, ((offs & 127) + lens_u + 127) >> 7, 0)
    cum_t = jnp.cumsum(rows_l, axis=1).astype(jnp.int32)
    lens_l = jnp.where(long, lens_u, 0).astype(jnp.int32)
    return (offs, cum_s, wstart, run_start, whot, cum_t, lens_l,
            cum_s[:, -1], cum_t[:, -1], whot.sum(axis=1))


def _phase2_hot_impl(postings, M, MT, hot_starts, offs, cum_s, wstart,
                     run_start, whot, cum_t, lens_l, *, cap_s, cap_t, k,
                     positions=False, pack_w_bits=0, k_cold=0):
    """Phase 2 for a group containing hot runs: two-tier cold expansion +
    dense hot matmul + threshold-algorithm merge (ops/hotset.py).

    Returns (counts, hit_rows, exact[, bitmaps]) -- one more output than
    _phase2_grouped_impl: `exact` bool[G] certifies each row's top-k; the
    engine re-runs uncertified rows through the legacy merge on device
    (merge_hot_cold_tam docstring -- rare by construction).  When the
    packed keys cannot hold row + count + the injected flag (pack_w_bits
    == 0, or P >= 2^(31-bits) on giant DBs) the per-lane candidate-union
    merge serves directly and `exact` is constant True (that merge
    gathers counts_hot at every lane: exact, just slower)."""
    import jax.numpy as jnp

    from ..ops.count import (expand_hybrid, expand_run_bitmaps,
                             member_bitmap_from_rows, pack_bits, sort_rle)
    from ..ops.hotset import (CAND_K, hot_lane_mask, hot_matmul,
                              hot_position_bitmaps, hot_weights,
                              merge_hot_cold, merge_hot_cold_tam)

    rows, seg, valid, w = expand_hybrid(postings, offs, cum_s, wstart,
                                        cum_t, lens_l, cap_s, cap_t)
    W = hot_weights(offs, whot, hot_starts)
    # counts are matched-position tallies <= L: for L <= 256 they are
    # exact in bf16, halving the [G, P] slab write and its topk/gather
    # reads (accumulation stays f32 inside hot_matmul)
    out_dt = jnp.bfloat16 if offs.shape[1] <= 256 else jnp.float32
    counts_hot = hot_matmul(W, M, max_w=offs.shape[1], out_dtype=out_dt)
    # TAM's single-sort extraction spends one key bit on the injected
    # flag, so rows must fit 31 - bits (vs the engine's 32 - bits packing
    # gate); beyond that the per-lane legacy merge serves directly
    if pack_w_bits and M.shape[1] < (1 << (31 - pack_w_bits)):
        counts, hit_rows, exact = merge_hot_cold_tam(
            counts_hot, rows, w, k, pack_w_bits=pack_w_bits,
            k_cand=max(CAND_K, k), k_cold=max(k_cold, k))
    else:
        s_rows, cold_counts, is_start = sort_rle(rows, weights=w,
                                                 pack_w_bits=pack_w_bits)
        counts, hit_rows = merge_hot_cold(counts_hot, s_rows, cold_counts,
                                          is_start, k,
                                          pack_w_bits=pack_w_bits)
        exact = jnp.ones(counts.shape[0], dtype=bool)
    if not positions:
        return counts, hit_rows, exact
    found = member_bitmap_from_rows(rows, seg, hit_rows, offs.shape[1])
    found = expand_run_bitmaps(found, run_start)
    hot_lanes = hot_lane_mask(whot, run_start)
    found = found | hot_position_bitmaps(offs, hot_lanes, hot_starts, MT,
                                         hit_rows)
    found = found & (counts[:, :, None] > 0)
    return counts, hit_rows, exact, pack_bits(found)


def _phase2_hot_legacy_impl(postings, M, MT, hot_starts, offs, cum_s,
                            wstart, run_start, whot, cum_t, lens_l, *,
                            cap_s, cap_t, k, positions=False,
                            pack_w_bits=0):
    """Exact per-lane candidate-union hot merge (merge_hot_cold): gathers
    counts_hot at every expanded lane, so it is never shape- or
    data-dependent-wrong -- but slow.  Serving uses it ONLY to
    re-run the rare rows whose TAM certificate fails (RERUN_B-wide
    chunks, engine._dispatch_legacy); the sharded engine's group kernel
    (parallel/mesh.py) uses the same merge as its primary.

    Returns (counts, hit_rows[, bitmaps]) -- no certificate output."""
    import jax.numpy as jnp

    from ..ops.count import (expand_hybrid, expand_run_bitmaps,
                             member_bitmap_from_rows, pack_bits, sort_rle)
    from ..ops.hotset import (hot_lane_mask, hot_matmul,
                              hot_position_bitmaps, hot_weights,
                              merge_hot_cold)

    rows, seg, valid, w = expand_hybrid(postings, offs, cum_s, wstart,
                                        cum_t, lens_l, cap_s, cap_t)
    s_rows, cold_counts, is_start = sort_rle(rows, weights=w,
                                             pack_w_bits=pack_w_bits)
    W = hot_weights(offs, whot, hot_starts)
    out_dt = jnp.bfloat16 if offs.shape[1] <= 256 else jnp.float32
    counts_hot = hot_matmul(W, M, max_w=offs.shape[1], out_dtype=out_dt)
    counts, hit_rows = merge_hot_cold(counts_hot, s_rows, cold_counts,
                                      is_start, k, pack_w_bits=pack_w_bits)
    if not positions:
        return counts, hit_rows
    found = member_bitmap_from_rows(rows, seg, hit_rows, offs.shape[1])
    found = expand_run_bitmaps(found, run_start)
    hot_lanes = hot_lane_mask(whot, run_start)
    found = found | hot_position_bitmaps(offs, hot_lanes, hot_starts, MT,
                                         hit_rows)
    found = found & (counts[:, :, None] > 0)
    return counts, hit_rows, pack_bits(found)


def _phase2_grouped_impl(postings, offs, cum_s, wstart, run_start, cum_t,
                         lens_l, *, cap_s, cap_t, k, positions=False,
                         pack_w_bits=0):
    """Phase 2 for one totals-sorted group: two-tier expand + weighted
    count + rank.

    Inputs are the group's rows of the phase-1 outputs (selected on device).
    Returns (counts int32[G,k], hit_rows uint32[G,k]
    [, bitmaps uint8[G,k,L//8]]).  With positions=True the per-hit k-mer
    position bitmaps (reference StoreMatchPositions, search.go:442-452) are
    computed on device from the expanded postings and shipped back
    bit-packed, avoiding a separate offs download + host search per batch.
    """
    from ..ops.count import (count_topk, expand_hybrid, expand_run_bitmaps,
                             member_bitmap_from_rows, pack_bits)

    rows, seg, valid, w = expand_hybrid(postings, offs, cum_s, wstart,
                                        cum_t, lens_l, cap_s, cap_t)
    counts, hit_rows = count_topk(rows, k, weights=w,
                                  pack_w_bits=pack_w_bits)
    if not positions:
        return counts, hit_rows
    # gather-free matmul path over the already-expanded entries; the scheduler
    # only requests device positions while the [G, cap, L] and [G, cap, k]
    # bf16 indicators stay bounded (_positions_on_device), falling back to
    # the lazy host bitmaps otherwise.  seg lands on run starts (dedup), so
    # the per-run bits are forward-filled to positions.
    found = member_bitmap_from_rows(rows, seg, hit_rows, offs.shape[1])
    found = expand_run_bitmaps(found, run_start)
    # rows with count 0 are sentinel padding; their bitmaps must be empty
    found = found & (counts[:, :, None] > 0)
    return counts, hit_rows, pack_bits(found)
