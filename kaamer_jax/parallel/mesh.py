"""Multi-device search: data-parallel queries over a sharded k-mer index.

The reference is a single-host Go program whose only parallelism is goroutine
pools over one Badger instance (SURVEY §2.3).  The scale-out here:

- Mesh axes (dp, shard): "dp" shards query batches (data parallel); "shard"
  shards the INDEX by postings-SET ownership (hash top bits of the set id;
  see shard_owner for why set -- not k-mer -- identity), the hash-table
  analogue of tensor parallelism.
- Per device: probe its index shard with the full dp-local query batch and
  expand its postings contribution [B, cap].
- lax.all_to_all over "shard" redistributes contributions so each device
  finalizes B/n_shards queries with ALL shards' postings [B/n, n*cap]
  (the "all-to-all hit return" of BASELINE.json's north star), then
  sort + RLE + top_k locally.
- Counts merge exactly: every (kmer -> protein) posting lives on exactly one
  shard, so concatenation before RLE reproduces single-chip counts.
- The single-chip engine's skew machinery runs shard-local: query-time run
  dedup (ops/count.py:dedup_runs) before expansion, and the hot-set dense
  path (ops/hotset.py) with PER-SHARD membership matrices -- each posting
  lives on one shard, so summing the shards' partial dense counts
  (psum_scatter) merges exactly.  Position bitmaps are computed from the
  deduplicated expansion in a second in-kernel round: the merged top hits
  are all_gather'd back to every shard, each shard builds and run-expands
  its own bitmap contribution, and the packed bitmaps OR-merge through one
  more all_to_all.

Works identically on real multi-chip meshes and on virtual CPU device meshes
(XLA_FLAGS=--xla_force_host_platform_device_count=N).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np

from ..index.hashtable import HASH_MULT, build_table, occupied_entries
from ..index.artifact import DBArtifact

KMER_SIZE = 7


def _next_pow2(n: int) -> int:
    return 1 << max(0, int(np.ceil(np.log2(max(n, 1)))))


@dataclass
class ShardedIndexArrays:
    """Host-side per-shard index arrays, padded to uniform shapes.

    tables:      uint32[n_shards, rows, 6]  (hashtable.py cuckoo layout,
                 values = shard-LOCAL postings (start, len) inline)
    postings:    uint32[n_shards, P_max]
    set_offsets: per-shard LOCAL postings slice boundaries (unpadded),
                 uint64[S_s + 1] each -- drives shard-local hot-set
                 selection (ops/hotset.py) and diagnostics
    postings_sizes: true (unpadded) postings length per shard
    """

    tables: np.ndarray
    postings: np.ndarray
    hash_log2: int
    n_shards: int
    set_offsets: List[np.ndarray] = None
    postings_sizes: List[int] = None


def shard_owner(keys: np.ndarray, n_shards: int) -> np.ndarray:
    """Owner shard of a uint32 key: top bits of the multiplicative hash (the
    SAME hash family as slot placement uses lower-order of; ownership uses
    the highest bits so in-shard placement stays uniform).

    The index shards by SET identity (every k-mer of a postings set lands on
    the set's owner shard, shard_index_arrays below), NOT by k-mer: adjacent
    query positions that resolve to one set -- the run structure the
    query-time dedup collapses (ops/count.py:dedup_runs) -- then stay
    consecutive on the owner shard, so the per-query sharded expansion
    volume EQUALS the single-chip deduplicated volume.  K-mer-hash ownership
    would scatter a run's positions across shards (adjacent k-mers hash
    independently), fragmenting every run to ~length 1 and re-paying the
    multiplicity the dedup exists to remove."""
    h = keys.astype(np.uint32) * HASH_MULT
    return ((h.astype(np.uint64) * np.uint64(n_shards)) >> np.uint64(32)).astype(np.int64)


# Sets whose postings slice is at least n_shards * SPLIT_SUB_MIN long are
# SPLIT contiguously across all shards instead of owned by one: whole-set
# ownership concentrates the power-law head on single shards, capping cold
# expansion balance at tsum/(n*tmax) ~= 0.19 at 8 shards (SCALING_r03) --
# per-batch expansion time is then set by whichever shard owns the biggest
# hot domains.  A split set contributes len/n rows on EVERY shard: sums
# (and therefore counts after the concat-RLE merge) are unchanged, each
# shard's sub-slice is sorted (contiguous cut of a sorted slice) so host
# bitmaps/fallback still binary-search it, and adjacent query positions
# still dedup into one run per shard.  The floor keeps sub-slices worth a
# few gather rows (>= 8 postings each).
SPLIT_SUB_MIN = 8


def split_set_mask(set_lens: np.ndarray, n_shards: int) -> np.ndarray:
    """Which sets are split across all shards (vs owned by shard_owner)."""
    if n_shards <= 1:
        return np.zeros(set_lens.shape, dtype=bool)
    return set_lens.astype(np.int64) >= n_shards * SPLIT_SUB_MIN


def shard_index(art: DBArtifact, n_shards: int) -> ShardedIndexArrays:
    """Split an indexed artifact into per-shard probe structures."""
    return shard_index_arrays(
        np.asarray(art.hash_table),
        np.asarray(art.set_offsets),
        np.asarray(art.postings),
        n_shards,
    )


def shard_index_arrays(
    hash_table: np.ndarray,
    set_offsets: np.ndarray,
    postings: np.ndarray,
    n_shards: int,
) -> ShardedIndexArrays:
    kmers, g_starts, g_lens = occupied_entries(np.ascontiguousarray(hash_table))
    # dense global set ids, recovered from the inline starts (set starts are
    # strictly increasing; see hashtable.py)
    set_ids = np.searchsorted(set_offsets, g_starts.astype(np.uint64),
                              side="left").astype(np.uint32)

    global_starts = set_offsets.astype(np.int64)
    n_sets = global_starts.size - 1
    lens_all = global_starts[1:] - global_starts[:-1]

    # ownership by SET identity preserves the query-time run-dedup structure
    # (see shard_owner); dense set ids are uniform under Fibonacci hashing.
    # Long sets are SPLIT across all shards for load balance (split_set_mask)
    owner_of_set = shard_owner(np.arange(n_sets, dtype=np.uint32), n_shards)
    split = split_set_mask(lens_all, n_shards)

    shard_posts = []
    shard_keys = []
    shard_starts_v = []
    shard_lens_v = []
    shard_set_offsets = []
    for s in range(n_shards):
        sel_sets = split | (owner_of_set == s)
        local_sets = np.flatnonzero(sel_sets)  # ascending global ids
        ls_lens = lens_all[local_sets]
        ls_split = split[local_sets]
        # sub-slice [lo, hi) of each local set: shard s's contiguous cut of
        # a split set, the whole slice otherwise
        lo = global_starts[local_sets] + np.where(
            ls_split, ls_lens * s // n_shards, 0)
        hi = global_starts[local_sets] + np.where(
            ls_split, ls_lens * (s + 1) // n_shards, ls_lens)
        lens = hi - lo
        starts_local = np.zeros(local_sets.size + 1, dtype=np.int64)
        np.cumsum(lens, out=starts_local[1:])
        total = int(starts_local[-1])
        src = (
            np.repeat(lo, lens)
            + np.arange(total, dtype=np.int64)
            - np.repeat(starts_local[:-1], lens)
        )
        post_local = postings[src]

        ksel = sel_sets[set_ids]
        local_rank = np.searchsorted(local_sets, set_ids[ksel])
        shard_keys.append(kmers[ksel])
        shard_starts_v.append(starts_local[local_rank].astype(np.uint32))
        shard_lens_v.append(lens[local_rank].astype(np.uint32))
        shard_posts.append(post_local)
        shard_set_offsets.append(starts_local.astype(np.uint64))

    # build with a shared table size so all shard tables stack shape-
    # identically; grow the common log2 until every shard converges at it
    common_t = 0
    while True:
        shard_tables = [
            build_table(k, st, ln, min_log2=common_t)
            for k, st, ln in zip(shard_keys, shard_starts_v, shard_lens_v)
        ]
        t_max = max(t.log2 for t in shard_tables)
        if all(t.log2 == t_max for t in shard_tables):
            common_t = t_max
            break
        common_t = t_max

    P_max = max(1, _next_pow2(max(p.size for p in shard_posts)))
    tables = np.stack([t.table for t in shard_tables])
    posts_pad = np.zeros((n_shards, P_max), dtype=np.uint32)
    for s in range(n_shards):
        posts_pad[s, : shard_posts[s].size] = shard_posts[s]

    return ShardedIndexArrays(
        tables=tables,
        postings=posts_pad,
        hash_log2=common_t,
        n_shards=n_shards,
        set_offsets=shard_set_offsets,
        postings_sizes=[p.size for p in shard_posts],
    )


# ---------------------------------------------------------------------------
# Device-side sharded search kernels
# ---------------------------------------------------------------------------


def _decode(codes, width):
    """Unpack the wire format (or pass through raw residue codes)."""
    import jax.numpy as jnp

    from .. import codec

    if width:
        if codes.dtype == jnp.uint32:
            return codec.unpack_codes7_jnp(codes, width)
        return codec.unpack_codes3_jnp(codes, width)
    return codes


def _probe_dedup(table_b, codes, n_kmers, hash_log2, miss_start, width):
    """Shared front half of every sharded kernel: decode -> encode ->
    shard-local cuckoo probe -> query-time run dedup.  Returns
    (offs, lens, lens_u, wstart, run_start, L)."""
    import jax
    import jax.numpy as jnp

    from .. import codec
    from ..ops.count import dedup_runs
    from ..ops.probe import probe_slices

    codes_i = _decode(codes, width)
    L = codes_i.shape[1] - (KMER_SIZE - 1)
    kmers = jax.vmap(lambda c: codec.encode_kmers_jnp(c.astype(jnp.int32), L))(
        codes_i)
    starts, lens = probe_slices(table_b, kmers, hash_log2,
                                miss_start=miss_start)
    lane = jnp.arange(L, dtype=jnp.int32)[None, :]
    in_query = lane < n_kmers[:, None]
    offs = jnp.where(in_query, starts, jnp.uint32(miss_start)).astype(jnp.int32)
    lens = jnp.where(in_query, lens, 0).astype(jnp.int32)
    lens_u, wstart, run_start = dedup_runs(offs, lens)
    return offs, lens, lens_u, wstart, run_start, L


def make_sharded_totals(mesh, hash_log2: int, miss_start: int,
                        width: int = 0):
    """Phase 1 of the grouped sharded engine: probe + run dedup + hot split
    on every shard, reporting each query's MAX shard-local cold expansion
    volume (drives the group cap), its SUM across shards (== the single-chip
    deduplicated volume under set-identity sharding; diagnostics/scaling
    evidence), and its total hot run weight (routes the query to the
    dense-path kernel).  hot_thresh is the per-shard hot-set length
    threshold (int32[n_shards]; 2^30 disables)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from jax import shard_map

    def local_totals(table_b, thresh_b, codes, n_kmers):
        table_b = table_b[0]
        offs, lens, lens_u, wstart, run_start, L = _probe_dedup(
            table_b, codes, n_kmers, hash_log2, miss_start, width)
        hot = lens >= thresh_b[0]
        whot = jnp.where(hot & (lens_u > 0), wstart, 0).astype(jnp.int32)
        cold_total = jnp.sum(jnp.where(hot, 0, lens_u), axis=1).astype(jnp.int32)
        tmax = jax.lax.pmax(cold_total, "shard")
        tsum = jax.lax.psum(cold_total, "shard")
        hot_sum = jax.lax.psum(whot.sum(axis=1), "shard")
        # replicate over dp too: every CONTROLLER schedules the whole
        # batch from these vectors (multi-controller determinism --
        # process-local device_get needs fully-addressable arrays), and
        # they are a few KB
        out = tuple(jax.lax.all_gather(t, "dp", axis=0, tiled=True)
                    for t in (tmax, tsum, hot_sum))
        return out

    fn = shard_map(
        local_totals,
        mesh=mesh,
        in_specs=(
            P("shard", None, None),   # tables
            P("shard",),              # hot_thresh
            P("dp", None),            # codes (replicated over shard)
            P("dp",),                 # n_kmers
        ),
        # pmax/psum/all_gather leave the outputs fully replicated
        out_specs=(P(), P(), P()),
        check_vma=False,
    )
    import jax as _jax

    return _jax.jit(fn)


def _or_merge_bitmaps(packed, counts, n_shards: int):
    """OR-merge per-shard packed bitmaps [B, K, L8] through one all_to_all:
    each finalizing device receives all shards' contributions for its B/n
    queries and bit-ors them; padding hits (count 0) are zeroed."""
    import jax
    import jax.numpy as jnp

    merged = jax.lax.all_to_all(packed, "shard", split_axis=0,
                                concat_axis=1, tiled=True)
    B_loc = merged.shape[0]
    K = merged.shape[1] // n_shards
    merged = merged.reshape(B_loc, n_shards, K, merged.shape[2])
    bits = jax.lax.reduce(merged, np.uint8(0), jax.lax.bitwise_or, (1,))
    return jnp.where(counts[:, :, None] > 0, bits, np.uint8(0))


def make_sharded_group(mesh, hash_log2: int, cap: int, k: int,
                       width: int = 0, positions: bool = False,
                       hot: bool = False, pack_w_bits: int = 0,
                       replicate_out: bool = False):
    """One phase-2 group of the sharded engine: per-shard run-deduplicated
    expansion at `cap`, all_to_all hit merge, weighted RLE count + top-k --
    plus, when hot=True, the dense hot-set path (shard-local W @ M partial
    counts merged exactly via psum_scatter, ops/hotset.py semantics).

    pack_w_bits: single-key sort packing (ops/count.sort_rle); postings
    carry GLOBAL protein rows on every shard, so the caller gates it on the
    global num_proteins exactly like the single-chip engine.

    Cold signature: fn(tables, postings, codes, n_kmers)
    Hot signature:  fn(tables, postings, hot_thresh, M, MT, hot_starts,
                       codes, n_kmers)
    Returns (counts int32[G, k], hit_rows uint32[G, k]
    [, bitmaps uint8[G, k, L//8] when positions]).

    With positions=True the bitmaps are computed from the deduplicated
    per-shard expansion in a second in-kernel round: merged top hits are
    all_gather'd to every shard, each shard run-expands its own bitmap
    contribution (ops/count.py:expand_run_bitmaps over ITS run structure --
    run structures differ per shard, so expansion must happen pre-merge),
    and the packed bitmaps OR-merge through one more all_to_all."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from jax import shard_map

    from ..ops.count import (count_topk, gather_postings,
                             member_bitmap_from_rows, pack_bits, sort_rle)

    n_shards = mesh.shape["shard"]

    def expand_and_merge(postings, offs, lens_u, wstart, hot_mask):
        lens_eff = lens_u if hot_mask is None else jnp.where(hot_mask, 0,
                                                             lens_u)
        cum = jnp.cumsum(lens_eff, axis=1).astype(jnp.int32)
        total = cum[:, -1]
        rows, seg, _, w = gather_postings(postings, offs, cum, total, cap,
                                          wstart=wstart)
        rows_ex = jax.lax.all_to_all(rows, "shard", split_axis=0,
                                     concat_axis=1, tiled=True)
        w_ex = jax.lax.all_to_all(w, "shard", split_axis=0, concat_axis=1,
                                  tiled=True)
        return rows, seg, rows_ex, w_ex

    def position_round(postings_rows, seg, run_start, hit_rows, counts, L,
                       extra_bits=None):
        hits_all = jax.lax.all_gather(hit_rows, "shard", axis=0, tiled=True)
        found = member_bitmap_from_rows(postings_rows, seg, hits_all, L)
        from ..ops.count import expand_run_bitmaps

        found = expand_run_bitmaps(found, run_start)
        if extra_bits is not None:
            found = found | extra_bits(hits_all)
        return _or_merge_bitmaps(pack_bits(found), counts, n_shards)

    if not hot:

        def local_step(table_b, postings, codes, n_kmers):
            table_b = table_b[0]
            postings = postings[0]
            miss_start = postings.shape[0]
            offs, lens, lens_u, wstart, run_start, L = _probe_dedup(
                table_b, codes, n_kmers, hash_log2, miss_start, width)
            rows, seg, rows_ex, w_ex = expand_and_merge(
                postings, offs, lens_u, wstart, None)
            counts, hit_rows = count_topk(rows_ex, k, weights=w_ex,
                                          pack_w_bits=pack_w_bits)
            if not positions:
                return counts, hit_rows
            bits = position_round(rows, seg, run_start, hit_rows, counts, L)
            return counts, hit_rows, bits

        in_specs = (
            P("shard", None, None),   # tables
            P("shard", None),         # postings
            P("dp", None),            # codes
            P("dp",),                 # n_kmers
        )
    else:
        from ..ops.hotset import (hot_lane_mask, hot_matmul,
                                  hot_position_bitmaps, hot_weights,
                                  merge_hot_cold)

        def local_step(table_b, postings, thresh_b, M_b, MT_b, hstarts_b,
                       codes, n_kmers):
            table_b = table_b[0]
            postings = postings[0]
            M, MT, hstarts = M_b[0], MT_b[0], hstarts_b[0]
            miss_start = postings.shape[0]
            offs, lens, lens_u, wstart, run_start, L = _probe_dedup(
                table_b, codes, n_kmers, hash_log2, miss_start, width)
            hot_mask = lens >= thresh_b[0]
            whot = jnp.where(hot_mask & (lens_u > 0), wstart, 0).astype(
                jnp.int32)
            rows, seg, rows_ex, w_ex = expand_and_merge(
                postings, offs, lens_u, wstart, hot_mask)
            s_rows, cold_counts, is_start = sort_rle(
                rows_ex, weights=w_ex, pack_w_bits=pack_w_bits)
            W = hot_weights(offs, whot, hstarts)
            partial = hot_matmul(W, M, max_w=offs.shape[1])
            # every posting lives on exactly one shard, so summing the
            # shards' dense partials merges exactly; scatter leaves each
            # finalizing device its own G/n query rows
            counts_hot = jax.lax.psum_scatter(partial, "shard",
                                              scatter_dimension=0,
                                              tiled=True)
            counts, hit_rows = merge_hot_cold(counts_hot, s_rows,
                                              cold_counts, is_start, k,
                                              pack_w_bits=pack_w_bits)
            if not positions:
                return counts, hit_rows

            hot_lanes = hot_lane_mask(whot, run_start)

            def extra(hits_all):
                return hot_position_bitmaps(offs, hot_lanes, hstarts, MT,
                                            hits_all)

            bits = position_round(rows, seg, run_start, hit_rows, counts, L,
                                  extra_bits=extra)
            return counts, hit_rows, bits

        in_specs = (
            P("shard", None, None),       # tables
            P("shard", None),             # postings
            P("shard",),                  # hot_thresh
            P("shard", None, None),       # M
            P("shard", None, None),       # MT
            P("shard", None),             # hot_starts
            P("dp", None),                # codes
            P("dp",),                     # n_kmers
        )

    if replicate_out:
        # multi-controller serving: every process's host scheduler needs
        # the full [G, k] outputs (device_get demands fully-addressable
        # arrays), so gather the per-device row blocks back in the
        # P(("dp","shard")) row order -- shard-minor, dp-major -- and
        # declare the outputs replicated.  A few KB per chunk.
        inner = local_step

        def local_step(*args):  # noqa: F811 -- deliberate wrap
            outs = inner(*args)
            rep = []
            for o in outs:
                o = jax.lax.all_gather(o, "shard", axis=0, tiled=True)
                rep.append(jax.lax.all_gather(o, "dp", axis=0, tiled=True))
            return tuple(rep)

        out_specs = [P()] * (3 if positions else 2)
    else:
        out_specs = [P(("dp", "shard"), None), P(("dp", "shard"), None)]
        if positions:
            out_specs.append(P(("dp", "shard"), None, None))
    fn = shard_map(
        local_step,
        mesh=mesh,
        in_specs=in_specs,
        out_specs=tuple(out_specs),
        # codes are replicated over "shard" while table gathers vary over it;
        # the probe loop carry mixes the two, so disable the vma check
        check_vma=False,
    )
    return jax.jit(fn)


def make_sharded_search(mesh, hash_log2: int, cap: int, k: int,
                        width: int = 0, positions: bool = False):
    """Whole-batch sharded search step (legacy/diagnostic API; the serving
    engine uses make_sharded_totals + make_sharded_group).  Returns
    fn(tables, postings, codes, n_kmers) -> (counts, hit_rows, totals
    [, bitmaps]); `totals` is each query's max shard-local DEDUPLICATED
    postings volume.  Unlike earlier rounds the positions path also runs
    the query-time run dedup (expansion volume now matches the counting
    path; results identical)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from jax import shard_map

    from ..ops.count import (count_topk, gather_postings,
                             member_bitmap_from_rows, pack_bits)

    n_shards = mesh.shape["shard"]

    def local_step(table_b, postings, codes, n_kmers):
        table_b = table_b[0]
        postings = postings[0]
        miss_start = postings.shape[0]
        offs, lens, lens_u, wstart, run_start, L = _probe_dedup(
            table_b, codes, n_kmers, hash_log2, miss_start, width)
        cum = jnp.cumsum(lens_u, axis=1).astype(jnp.int32)
        total = cum[:, -1]
        rows, seg, _, w = gather_postings(postings, offs, cum, total, cap,
                                          wstart=wstart)
        rows_ex = jax.lax.all_to_all(rows, "shard", split_axis=0,
                                     concat_axis=1, tiled=True)
        w_ex = jax.lax.all_to_all(w, "shard", split_axis=0, concat_axis=1,
                                  tiled=True)
        counts, hit_rows = count_topk(rows_ex, k, weights=w_ex)
        tmax = jax.lax.pmax(total, "shard")
        tmax = jax.lax.all_to_all(tmax[:, None], "shard", split_axis=0,
                                  concat_axis=1, tiled=True)[:, 0]
        if not positions:
            return counts, hit_rows, tmax
        hits_all = jax.lax.all_gather(hit_rows, "shard", axis=0, tiled=True)
        found = member_bitmap_from_rows(rows, seg, hits_all, L)
        from ..ops.count import expand_run_bitmaps

        found = expand_run_bitmaps(found, run_start)
        bits = _or_merge_bitmaps(pack_bits(found), counts, n_shards)
        return counts, hit_rows, tmax, bits

    out_specs = [P(("dp", "shard"), None), P(("dp", "shard"), None),
                 P(("dp", "shard"),)]
    if positions:
        out_specs.append(P(("dp", "shard"), None, None))
    fn = shard_map(
        local_step,
        mesh=mesh,
        in_specs=(
            P("shard", None, None),   # tables
            P("shard", None),         # postings
            P("dp", None),            # codes (replicated over shard)
            P("dp",),                 # n_kmers
        ),
        out_specs=tuple(out_specs),
        check_vma=False,
    )
    return jax.jit(fn)


def replicate_query_batch(seqs, sizes, batch_mult: int):
    """Pad a query batch so B is divisible by dp*shard, returning codes and
    n_kmers arrays (padding queries have 0 k-mers)."""
    from .. import codec as _codec

    B0 = len(seqs)
    B = max(batch_mult, ((B0 + batch_mult - 1) // batch_mult) * batch_mult)
    L = _next_pow2(max(max(sizes), 8) if sizes else 8)
    codes = np.full((B, L + KMER_SIZE - 1), -1, dtype=np.int32)
    n_kmers = np.zeros(B, dtype=np.int32)
    for i, s in enumerate(seqs):
        c = _codec.seq_to_codes(s)[: L + KMER_SIZE - 1]
        codes[i, : c.shape[0]] = c
        n_kmers[i] = sizes[i]
    return codes, n_kmers
