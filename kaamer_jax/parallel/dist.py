"""Multi-host distributed runtime glue + the grouped sharded search engine.

The reference is single-host (goroutines over one Badger instance); scale-out
here follows the standard JAX multi-controller pattern:

- every host runs the same program and calls `init_distributed()`
  (jax.distributed.initialize from env/args: coordinator address, process
  count, process id);
- `global_mesh(dp, shard)` builds a Mesh over ALL devices of the job.  Its
  shape follows the algorithm: "shard" splits the index (its collectives
  merge the per-shard hits of every query), "dp" splits the query batches
  and needs no collective at all.  By default the shard axis is one host's
  devices, so a host serves a whole index and further hosts add replicas;
- the sharded search kernels (parallel/mesh.py) are mesh-agnostic: the same
  all_to_all hit merge runs within one host or across hosts.

Index distribution across hosts: each host memory-maps the same artifact (or
its own replica) and feeds its devices their shard rows; shard ownership is a
pure function of the k-mer hash (mesh.shard_owner), so no coordination is
needed at build time.

The engine mirrors the single-chip two-phase design (search/engine.py):
phase 1 (make_sharded_totals) probes + run-dedups + hot-splits on every
shard and reports exact per-query MAX shard-local cold totals; the host
then schedules phase 2 in totals-sorted coalesced GROUPS, each re-uploaded
(wire rows are host numpy, so group row selection is free and works across
dp blocks) and dispatched through make_sharded_group at the cap bucket it
needs.  Hot queries route to the dense-matmul kernel with PER-SHARD
membership matrices (ops/hotset.py), merged exactly via psum_scatter.  The
price of the re-dispatch design is that groups re-probe their k-mers (two
row-gathers per k-mer, ~10-20% of device time on skewed data) -- paid so one
postings-heavy query never drags a whole batch to its expansion capacity,
the same trade the single-chip scheduler makes.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np

from ..search.engine import (HOT_DENSE_BYTES, MAX_EXPANSION_ELEMS, TOPK_MIN,
                             PositionBitmapServing, QueryCounts, _cap_bucket,
                             _cap_floor, _finalize_pending, _next_pow2,
                             _plan_normal_chunks, _positions_on_device)

KMER_SIZE = 7


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """jax.distributed.initialize with env-var fallbacks
    (KAAMER_COORDINATOR, KAAMER_NUM_PROCESSES, KAAMER_PROCESS_ID)."""
    import jax

    coordinator_address = coordinator_address or os.environ.get("KAAMER_COORDINATOR")
    if num_processes is None and "KAAMER_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["KAAMER_NUM_PROCESSES"])
    if process_id is None and "KAAMER_PROCESS_ID" in os.environ:
        process_id = int(os.environ["KAAMER_PROCESS_ID"])

    if coordinator_address is None:
        return  # single-process run

    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def global_mesh(n_shards: Optional[int] = None):
    """(dp, shard) Mesh over all devices of the job.  By default the shard
    axis equals the local device count, so every host holds a whole index
    and the collectives of a query never leave its host; the data-parallel
    axis spans hosts."""
    import jax
    from jax.sharding import Mesh

    devices = np.asarray(jax.devices())
    n = devices.size
    if n_shards is None:
        n_shards = min(jax.local_device_count(), n)
    while n % n_shards:
        n_shards -= 1
    dp = n // n_shards
    return Mesh(devices.reshape(dp, n_shards), axis_names=("dp", "shard"))


class ShardedSearchEngine(PositionBitmapServing):
    """Counting engine over a sharded index on a (dp, shard) mesh.  Exposes
    the same dispatch/schedule/collect contract as the single-chip
    SearchEngine, so the search pipelines (and their batch pipelining) run
    unmodified on top of it: queries ship packed 7 residues/uint32, device->
    host copies start at dispatch time, phase 2 runs in totals-sorted
    coalesced groups at adaptive cap buckets, hot queries take the dense
    matmul path, position bitmaps are computed on device from the
    run-deduplicated merged expansion, and postings-heavy outliers fall back
    to the exact host bincount -- feature parity with the single-chip
    engine, bit-identical results (tests/test_dist.py)."""

    CAP_MIN = 1 << 6   # per shard; the merge concatenates n_shards * cap
    CAP_MAX = 1 << 18  # per shard
    RERUN_B = 16
    GROUP_B = 256
    WARM_CAPS = (CAP_MIN, 96, 128, 192, 256, 320, 384, 512)

    def __init__(self, art, mesh=None, cap: int = 0, k: int = 64,
                 hot: bool = True):
        import jax
        import jax.numpy as jnp

        from .mesh import shard_index

        self._jax = jax
        self.art = art
        self.mesh = mesh or global_mesh()
        self.n_shards = self.mesh.shape["shard"]
        self.dp = self.mesh.shape["dp"]
        self.mult = self.dp * self.n_shards
        self._cap_hint = cap or self.CAP_MIN  # diagnostic only
        self.k = k
        self._totals_cache = {}
        self._group_cache = {}

        if getattr(art, "index_shards", 0):
            # build-time per-shard artifacts (index_db n_shards > 1): load
            # the shard arrays directly -- no global artifact exists (this
            # is the only layout past build.MAX_POSTINGS), so device arrays
            # are placed one shard at a time and the host fallbacks run
            # over a virtual concatenation of the shard postings
            if art.index_shards != self.n_shards:
                raise ValueError(
                    f"artifact has {art.index_shards} index shards; the "
                    f"mesh 'shard' axis is {self.n_shards} -- they must "
                    f"match (re-index or use an {art.index_shards}-shard "
                    f"mesh)")
            from .mesh import ShardedIndexArrays

            tables_l = [np.asarray(t) for t in art.shard_tables]
            posts_l = [np.asarray(p) for p in art.shard_postings]
            sizes = [int(p.shape[0]) for p in posts_l]
            self.sharded = ShardedIndexArrays(
                tables=None, postings=None,  # device-resident only
                hash_log2=art.hash_log2, n_shards=self.n_shards,
                set_offsets=[np.asarray(o) for o in art.shard_set_offsets],
                postings_sizes=sizes)
            self.postings_np = _ConcatPostings(posts_l)
            self._post_bases = self.postings_np.bases
            P_max = max(1, _next_pow2(max(sizes)))
            # set_starts_np is built lazily via __getattr__ (it is only
            # needed by host fallbacks, and is O(total sets) in memory)
        else:
            self.sharded = shard_index(art, self.n_shards)
            tables_l = [self.sharded.tables[s]
                        for s in range(self.n_shards)]
            posts_l = [self.sharded.postings[s, :sz] for s, sz in
                       enumerate(self.sharded.postings_sizes)]
            so = np.asarray(art.set_offsets)
            self.set_starts_np = np.concatenate([so, so[-1:]]).astype(
                np.int64)
            self.postings_np = np.asarray(art.postings)
            P_max = int(self.sharded.postings.shape[1])

        self._posts_local = posts_l  # shard-local views, true (unpadded) len
        self.tables = self._device_stack(tables_l, tables_l[0].shape,
                                         np.uint32)
        self.postings = self._device_stack(posts_l, (P_max,), np.uint32)
        self.miss_start = P_max

        self._init_hot(hot)

    def _device_stack(self, parts, shape_tail, dtype):
        """[n_shards, *shape_tail] device array laid out over the mesh's
        'shard' axis, placed one shard at a time (padding each part to the
        common tail shape) -- shard-built artifacts can exceed host RAM, so
        the full stacked array is never materialized on host."""
        import jax
        from jax.sharding import NamedSharding, PartitionSpec as P

        shape_tail = tuple(shape_tail)
        global_shape = (self.n_shards,) + shape_tail
        sharding = NamedSharding(self.mesh,
                                 P("shard", *([None] * len(shape_tail))))

        def cb(index):
            s = index[0].start or 0
            part = np.asarray(parts[s])
            if part.shape == shape_tail:
                buf = part[None]
            else:
                buf = np.zeros((1,) + shape_tail, dtype=dtype)
                buf[(0,) + tuple(slice(0, d) for d in part.shape)] = part
            return buf.astype(dtype, copy=False)

        return jax.make_array_from_callback(global_shape, sharding, cb)

    def __getattr__(self, name):
        if name == "set_starts_np":
            # virtual-global set starts over the shard postings concat:
            # strictly increasing (per-shard starts + rising bases), with
            # the usual +sentinel duplicate (searchsorted contract of
            # engine.QueryCounts)
            parts = [np.asarray(o[:-1]).astype(np.int64) + int(b)
                     for o, b in zip(self.art.shard_set_offsets,
                                     self._post_bases[:-1])]
            total = int(self._post_bases[-1])
            v = np.concatenate(parts + [np.asarray([total, total])])
            self.set_starts_np = v
            return v
        raise AttributeError(name)

    # ------------------------------------------------------------------
    # Hot-set dense path (per-shard ops/hotset.py structures)
    # ------------------------------------------------------------------

    def _init_hot(self, enabled: bool) -> None:
        import jax.numpy as jnp

        from ..ops import hotset

        import jax
        from jax.sharding import NamedSharding, PartitionSpec as P

        n = self.n_shards
        # shards with no hot sets keep threshold 2^30 (nothing qualifies)
        # and all-zero membership rows
        self.hot_thresh_np = np.full(n, 1 << 30, dtype=np.int32)
        self.hot_starts = None
        self.M = self.MT = None
        P_pad = -(-max(self.art.num_proteins, 1) // 128) * 128
        sels = [
            hotset.select_hot_sets(self.sharded.set_offsets[s],
                                   self.art.num_proteins)
            if enabled else None
            for s in range(n)
        ]
        if not any(s is not None for s in sels):
            self.hot_thresh = jax.make_array_from_callback(
                self.hot_thresh_np.shape,
                NamedSharding(self.mesh, P("shard")),
                lambda idx: self.hot_thresh_np[idx])
            return
        H_max = max(s[0].shape[0] for s in sels if s is not None)
        starts = np.full((n, H_max), -1, dtype=np.int32)
        # compact (hot row, protein row) pairs per shard; each device
        # builds ITS shard's [H_max, P_pad] block by one init-time scatter
        # (a 1M-protein shard block is ~1 GB -- never materialized on host,
        # mirroring hotset.build_membership on the single-chip engine)
        pairs = []
        for s, sel in enumerate(sels):
            if sel is None:
                pairs.append((np.empty(0, np.int32), np.empty(0, np.int32)))
                continue
            hs, thresh, _ = sel
            self.hot_thresh_np[s] = thresh
            starts[s, : hs.shape[0]] = hs
            post_local = self._posts_local[s]
            ends = self.sharded.set_offsets[s].astype(np.int64)
            hh, rr = [], []
            for h, st in enumerate(hs.astype(np.int64)):
                e = ends[np.searchsorted(ends, st, side="right")]
                seg = post_local[st:e]
                hh.append(np.full(seg.size, h, dtype=np.int32))
                rr.append(np.asarray(seg, dtype=np.int32))
            pairs.append((np.concatenate(hh) if hh else np.empty(0, np.int32),
                          np.concatenate(rr) if rr else np.empty(0, np.int32)))

        # per-DEVICE M is [H_max, P_pad]; f32 when it fits the budget
        dtype = (jnp.float32 if H_max * P_pad * 4 <= hotset.M_BYTES_BUDGET
                 else jnp.bfloat16)
        mesh_devices = np.asarray(self.mesh.devices)  # [dp, shard]
        blocks = []
        for dp_i in range(self.dp):
            for s in range(n):
                dev = mesh_devices[dp_i, s]
                # multi-process mesh: build only THIS controller's blocks
                if dev.process_index != jax.process_index():
                    continue
                hh, rr = pairs[s]
                with jax.default_device(dev):
                    blk = jnp.zeros((1, H_max, P_pad), dtype=dtype)
                    if hh.size:
                        blk = blk.at[0, jnp.asarray(hh), jnp.asarray(rr)].set(
                            1, mode="drop", unique_indices=True)
                blocks.append(blk)
        self.M = jax.make_array_from_single_device_arrays(
            (n, H_max, P_pad),
            NamedSharding(self.mesh, P("shard", None, None)), blocks)
        self.MT = jnp.swapaxes(self.M, 1, 2).astype(jnp.bfloat16)
        # small control arrays still need explicit multi-process placement
        self.hot_starts = jax.make_array_from_callback(
            starts.shape, NamedSharding(self.mesh, P("shard", None)),
            lambda idx: starts[idx])
        self.hot_thresh = jax.make_array_from_callback(
            self.hot_thresh_np.shape, NamedSharding(self.mesh, P("shard")),
            lambda idx: self.hot_thresh_np[idx])

    # ------------------------------------------------------------------
    # Kernel caches
    # ------------------------------------------------------------------

    def _totals_fn(self, width: int):
        from .mesh import make_sharded_totals

        key = width
        if key not in self._totals_cache:
            self._totals_cache[key] = make_sharded_totals(
                self.mesh, self.sharded.hash_log2, self.miss_start,
                width=width)
        return self._totals_cache[key]

    def _group_fn(self, cap: int, k: int, width: int, positions: bool,
                  hot: bool):
        from .mesh import make_sharded_group

        key = (cap, k, width, positions, hot)
        if key not in self._group_cache:
            # single-key sort packing, gated exactly like the single-chip
            # engine (engine._pack_w_bits): weights/counts <= L fit the low
            # bits, global protein rows must fit the rest
            L = width - 6
            bits = max(int(L).bit_length(), 1)
            if not (self.art.num_proteins < (1 << (32 - bits)) - 1):
                bits = 0
            self._group_cache[key] = make_sharded_group(
                self.mesh, self.sharded.hash_log2, cap=cap, k=k,
                width=width, positions=positions, hot=hot,
                pack_w_bits=bits,
                # multi-controller: every process's collect_batch
                # device_gets the full chunk outputs (see mesh.py)
                replicate_out=self._jax.process_count() > 1)
        return self._group_cache[key]

    # ------------------------------------------------------------------
    # dispatch / schedule / collect
    # ------------------------------------------------------------------

    def count_batch(self, seqs, sizes, k: int, positions: bool = False):
        return self.resolve_batch(self.dispatch_batch(seqs, sizes, k,
                                                      positions=positions))

    def resolve_batch(self, handle, min_top: int = 0):
        return self.collect_batch(self.schedule_batch(handle), min_top)

    def _pack(self, padded, width):
        from .. import codec, native

        wire = native.pack_queries(padded, width)
        if wire is None:
            wire = codec.pack_codes7(codec.pad_codes_batch(padded, width))
        return wire

    def dispatch_batch(self, seqs, sizes, k, positions: bool = False,
                       cap: int = 0, adapt_hint: bool = True):
        """Phase 1: pack the batch, probe + dedup + hot-split on every
        shard, and start the async copy of the exact totals.  adapt_hint is
        kept for interface stability (groups always use this batch's own
        totals)."""
        import jax.numpy as jnp

        if not seqs:
            return None
        B0 = len(seqs)
        B = self.mult * _next_pow2(-(-max(B0, 16) // self.mult))
        padded = list(seqs) + [""] * (B - B0)
        L = _next_pow2(max(max(sizes), 8))
        width = L + KMER_SIZE - 1
        wire = self._pack(padded, width)
        n_np = np.zeros(B, dtype=np.int32)
        n_np[:B0] = sizes

        outs = self._totals_fn(width)(
            self.tables, self.hot_thresh, jnp.asarray(wire),
            jnp.asarray(n_np))
        for arr in outs:
            arr.copy_to_host_async()
        return (outs, wire, n_np, list(seqs), list(sizes), k, L, positions,
                cap)

    def _hot_g_max(self, L: int) -> int:
        """Largest hot-group width within the per-DEVICE dense budget (each
        shard device holds [G/dp, P_pad] f32 partial counts and a
        [G/dp, L, H] indicator)."""
        if self.hot_starts is None:
            return 1 << 30
        H = int(self.hot_starts.shape[1])
        P_pad = int(self.M.shape[2])
        per_g = 4 * max(P_pad, L * H)
        g = self.dp * (HOT_DENSE_BYTES // per_g)
        return max(self._g_min(), 1 << max(0, int(g).bit_length() - 1))

    def _g_min(self) -> int:
        return max(16, self.mult)

    def _quantized_groups(self, cap: int, B: int, hot: bool,
                          L: int) -> List[int]:
        """Group widths schedule_batch can emit for (cap, hot, L) -- the
        engine.G_QUANTA quantization (mult-aligned), budget-clamped;
        warmup iterates exactly this set."""
        g_budget = max(self._g_min(),
                       1 << ((self.dp * MAX_EXPANSION_ELEMS // cap)
                             .bit_length() - 1))
        if hot:
            g_budget = min(g_budget, self._hot_g_max(L))
        gm = self._g_min()
        from ..search.engine import G_QUANTA

        out = [gm]
        for g in G_QUANTA:
            if g > gm and g % self.mult == 0 and g <= min(g_budget, B):
                out.append(g)
        return out

    def schedule_batch(self, handle):
        """Group queries by their exact phase-1 totals and dispatch every
        phase-2 group asynchronously (same scheduling policy as the
        single-chip engine; group wire rows are sliced host-side, so groups
        freely mix rows across dp blocks)."""
        if handle is None:
            return None
        (outs, wire, n_np, seqs, sizes, k, L, positions, cap_pin) = handle
        totals_h, _, hot_h = self._jax.device_get(tuple(outs))
        B = wire.shape[0]
        B_real = len(sizes)
        max_total = int(totals_h[:B_real].max()) if B_real else 0
        if not cap_pin:
            self._cap_hint = _cap_bucket(max_total)  # diagnostic only

        slices = _LazyBatchSlices(self, seqs, sizes)
        k_full = _next_pow2(max(k, TOPK_MIN))
        results: Dict[int, QueryCounts] = {}

        G0 = min(self.GROUP_B, B)
        limit_g = min(_cap_floor(self.dp * MAX_EXPANSION_ELEMS // G0),
                      self.CAP_MAX)
        order = np.lexsort((-totals_h[:B_real],
                            hot_h[:B_real] == 0)).tolist()
        totals_l = totals_h.tolist()
        hot_l = (hot_h > 0).tolist()
        from ..search.engine import _cap_bucket_vec

        caps_l = np.maximum(np.minimum(_cap_bucket_vec(totals_h), limit_g),
                            self.CAP_MIN).tolist()
        normal: List[int] = []
        chunks: List[tuple] = []  # (rows, G_c, cap_c, hot)
        heavy: List[int] = []
        for i in order:
            t = totals_l[i]
            if t > self.CAP_MAX:
                results[i] = self._count_host_row(slices, i, sizes[i],
                                                  k_full)
            elif t > limit_g and not cap_pin:
                heavy.append(i)
            else:
                normal.append(i)

        def any_hot(rows):
            return self.hot_starts is not None and any(
                hot_l[i] for i in rows)

        gm = self._g_min()
        for c0 in range(0, len(heavy), gm):
            rows = heavy[c0 : c0 + gm]
            cap_c = min(_next_pow2(max(totals_l[i] for i in rows)),
                        self.CAP_MAX)
            chunks.append((rows, gm, cap_c, any_hot(rows)))
        # the bulk: shared cost-model chunker (engine._plan_normal_chunks)
        def groups_for(cap_c, hot0):
            return self._quantized_groups(cap_c, B, hot0, L)

        def hot_extra_rows():
            H = int(self.hot_starts.shape[1])
            P_pad = int(self.M.shape[2])
            return max(P_pad, L * H) // 5000

        if self.hot_starts is None:
            hot_l = [False] * B
        chunks.extend(_plan_normal_chunks(normal, totals_l, hot_l, caps_l,
                                          cap_pin, groups_for,
                                          hot_extra_rows))

        identity = (len(chunks) == 1 and not results
                    and len(chunks[0][0]) == B_real and chunks[0][1] == B)

        pending = []
        for rows, G_c, cap_c, hot in chunks:
            if identity:
                rows = list(range(B))
            pending.append(
                (rows, self._dispatch_group(wire, n_np, rows, G_c, cap_c,
                                            k_full, L, positions, hot,
                                            identity=identity))
            )
        return (pending, results, sizes, B_real, slices)

    def collect_batch(self, sched, min_top: int = 0):
        if sched is None:
            return []
        pending, results, sizes, B_real, slices = sched
        return _finalize_pending(self._jax, pending, results, sizes, B_real,
                                 slices, self, min_top)

    def _pos_on_device(self, cap: int, k_eff: int, L: int, G: int) -> bool:
        # per-shard bitmap matmul runs over [G/dp, cap, k]; the merged
        # expansion each finalizing device touches is n_shards * cap wide
        return _positions_on_device(cap * self.n_shards, k_eff, L,
                                    max(G // self.dp, 1))

    def _dispatch_group(self, wire, n_np, rows, G: int, cap: int,
                        k_full: int, L: int, positions: bool, hot: bool,
                        identity: bool = False):
        import jax.numpy as jnp

        if identity:
            wire2, n2 = wire, n_np
        else:
            wire2 = np.zeros((G,) + wire.shape[1:], wire.dtype)
            n2 = np.zeros(G, dtype=np.int32)
            wire2[: len(rows)] = wire[rows]
            n2[: len(rows)] = n_np[rows]
        width = L + KMER_SIZE - 1  # residue width (wire.shape[1] is packed)
        k2 = k_full if hot else min(k_full, cap * self.n_shards)
        pos_dev = positions and self._pos_on_device(
            cap, k_full if hot else k2, L, G)
        fn = self._group_fn(cap, k2, width, pos_dev, hot)
        if hot:
            outs = fn(self.tables, self.postings, self.hot_thresh, self.M,
                      self.MT, self.hot_starts, jnp.asarray(wire2),
                      jnp.asarray(n2))
        else:
            outs = fn(self.tables, self.postings, jnp.asarray(wire2),
                      jnp.asarray(n2))
        for arr in outs:
            arr.copy_to_host_async()
        return outs, pos_dev

    # ------------------------------------------------------------------
    # warmup / host fallback
    # ------------------------------------------------------------------

    def warmup(self, batch_sizes=(16, 2048), lengths=(64, 128, 256, 512),
               positions=(False, True), caps=None) -> None:
        """Pre-compile the serving shape grid (same contract as
        SearchEngine.warmup: never touches the adaptive cap hint, best
        effort, ordered most-likely-first)."""
        caps = tuple(caps) if caps else self.WARM_CAPS
        for pos in positions:
            for B in batch_sizes:
                for L in lengths:
                    try:
                        seq = "A" * min(L + KMER_SIZE - 1, 64)
                        seqs = [seq] * B
                        sizes = [len(seq) - KMER_SIZE + 1] * (B - 1) + [L]
                        self.resolve_batch(self.dispatch_batch(
                            seqs, sizes, k=10, positions=pos,
                            cap=self.CAP_MIN, adapt_hint=False))
                    except Exception:
                        pass
        B_max = max(batch_sizes)
        k_full = _next_pow2(max(10, TOPK_MIN))
        hots = (False, True) if self.hot_starts is not None else (False,)
        wire0 = None
        for pos in positions:
            for hot in hots:
                for capv in caps:
                    for L in lengths:
                        for G in self._quantized_groups(capv, B_max, hot, L):
                            try:
                                width = L + KMER_SIZE - 1
                                wire0 = self._pack([""] * G, width)
                                self._dispatch_group(
                                    wire0, np.zeros(G, np.int32),
                                    list(range(G)), G, capv, k_full, L,
                                    pos, hot, identity=True)
                            except Exception:
                                pass

    def _host_bitmaps_np(self, qc, hit_rows):
        """Host position bitmaps; shard-built artifacts aggregate per-shard
        probes (a split set's sub-slices live on every shard: membership is
        the OR over shards).  The global-artifact layout keeps the 1-D
        base-class path (its host probe resolves full sets)."""
        if not getattr(self.art, "index_shards", 0):
            return super()._host_bitmaps_np(qc, hit_rows)
        from ..ops.count import member_np

        hits = np.asarray(list(hit_rows), dtype=np.uint32)
        if hits.size == 0 or qc._n_kmers == 0:
            return {}
        if qc._offs is not None and getattr(qc._offs, "ndim", 1) == 2:
            offs_all, lens_all = qc._offs, qc._lens
        else:
            offs_all = qc._batch.host()[:, qc._row, : qc._n_kmers].astype(
                np.int64)
            starts = self.set_starts_np
            ids = np.searchsorted(starts, offs_all, side="left")
            lens_all = starts[ids + 1] - starts[ids]
        found = None
        for s in range(offs_all.shape[0]):
            f = member_np(self.postings_np, offs_all[s], lens_all[s], hits)
            found = f if found is None else (found | f)
        return {int(h): found[j] for j, h in enumerate(hits)}

    def _count_host_row(self, slices: "_LazyBatchSlices", i: int,
                        n_kmers: int, k: int):
        """Unbounded host fallback (np.bincount) for postings-heavy queries,
        over the GLOBAL artifact (bit-identical to the single-chip one).
        Shard-built artifacts probe per shard (slices.stacked): each k-mer's
        set is the UNION of its per-shard sub-slices (split sets live on
        every shard), so segs accumulate over the shard axis too."""
        if slices.stacked:
            offs = slices.host()[:, i, :n_kmers].astype(np.int64)  # [S, n]
        else:
            offs = slices.host()[i, :n_kmers].astype(np.int64)[None]
        starts = self.set_starts_np
        ids = np.searchsorted(starts, offs, side="left")
        lens = starts[ids + 1] - starts[ids]
        segs = [self.postings_np[int(o): int(o) + int(l)]
                for o, l in zip(offs.ravel(), lens.ravel()) if l > 0]
        if not slices.stacked:  # 1-D contract of the base-class host paths
            offs, lens = offs[0], lens[0]
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


class _ConcatPostings:
    """Read-only virtual concatenation of per-shard postings arrays
    (shard-built artifacts never materialize a global postings array: the
    whole point of index_db(n_shards > 1) is that the global size exceeds
    uint32 addressing / host RAM).  Supports exactly the access patterns of
    the host fallbacks: len(), contiguous slices (a shard-LOCAL postings
    slice -- a whole owned set or one shard's sub-slice of a split set --
    never crosses a shard boundary, index/build.py), and fancy integer
    indexing (ops/count.py:member_np binary search probes)."""

    def __init__(self, parts: List[np.ndarray]):
        self.parts = parts
        self.bases = np.zeros(len(parts) + 1, dtype=np.int64)
        np.cumsum([p.shape[0] for p in parts], out=self.bases[1:])
        self.dtype = parts[0].dtype if parts else np.dtype(np.uint32)

    def __len__(self) -> int:
        return int(self.bases[-1])

    @property
    def shape(self):
        return (len(self),)

    def _shard_of(self, flat_idx: np.ndarray) -> np.ndarray:
        # side="right" skips empty shards (repeated bases) correctly
        s = np.searchsorted(self.bases, flat_idx, side="right") - 1
        return np.clip(s, 0, len(self.parts) - 1)

    def __getitem__(self, key):
        if isinstance(key, slice):
            o = int(key.start or 0)
            e = len(self) if key.stop is None else min(int(key.stop),
                                                       len(self))
            if e <= o:
                return np.empty(0, dtype=self.dtype)
            s = int(self._shard_of(np.asarray([o]))[0])
            base = int(self.bases[s])
            return self.parts[s][o - base : e - base]
        idx = np.asarray(key, dtype=np.int64)
        sh = self._shard_of(idx.ravel())
        local = idx.ravel() - self.bases[sh]
        out = np.empty(idx.size, dtype=self.dtype)
        for s, p in enumerate(self.parts):
            m = sh == s
            if m.any():
                out[m] = p[local[m]]
        return out.reshape(idx.shape)


class _LazyBatchSlices:
    """Per-batch lazy global k-mer -> slice-start resolution for position
    lookups: one vectorized host probe of the global artifact table for the
    whole batch, computed only if some query actually needs position bitmaps
    (mirrors the single-chip engine's lazy device-offs pull).

    Shard-built artifacts have no global table, so every shard table is
    probed and `stacked` is True: host() is then [n_shards, B, L], one row
    of rebased slice starts per shard.  A k-mer can legitimately hit on
    EVERY shard -- long sets split contiguously across all of them
    (mesh.split_set_mask) -- so the per-shard hits must be aggregated, not
    overwritten; consumers sum counts / OR bitmaps over axis 0."""

    def __init__(self, engine: "ShardedSearchEngine", seqs, sizes):
        self._engine = engine
        self._seqs = seqs
        self._sizes = sizes
        self._offs = None
        self.stacked = bool(getattr(engine.art, "index_shards", 0))

    def host(self) -> np.ndarray:
        if self._offs is None:
            from .. import codec
            from ..index.hashtable import CuckooTable, lookup_np

            eng = self._engine
            miss = int(eng.set_starts_np[-1])  # global P -> empty-set id
            L = max(self._sizes) if self._sizes else 1
            width = L + KMER_SIZE - 1
            codes = codec.pad_codes_batch(self._seqs, width)
            kmers = codec.encode_kmers_batch(codes.astype(np.int32))  # [B, L]
            flat = kmers.reshape(-1)
            lane = np.arange(L)[None, :]
            sizes = np.asarray(self._sizes)[:, None]
            in_q = lane < sizes
            if self.stacked:
                if not hasattr(eng, "_ht"):
                    eng._ht = [CuckooTable(table=np.asarray(t),
                                           log2=eng.art.hash_log2)
                               for t in eng.art.shard_tables]
                offs = np.full((len(eng._ht),) + kmers.shape, miss,
                               dtype=np.int64)
                for s, ht in enumerate(eng._ht):
                    st_s, ln_s = lookup_np(ht, flat, miss_start=0)
                    hit = (ln_s > 0).reshape(kmers.shape) & in_q
                    starts = (st_s.astype(np.int64).reshape(kmers.shape)
                              + int(eng._post_bases[s]))
                    offs[s][hit] = starts[hit]
                self._offs = offs
            else:
                if not hasattr(eng, "_ht"):
                    eng._ht = CuckooTable(
                        table=np.asarray(eng.art.hash_table),
                        log2=eng.art.hash_log2,
                    )
                starts, _ = lookup_np(eng._ht, flat, miss_start=miss)
                starts = starts.reshape(kmers.shape).astype(np.int64)
                self._offs = np.where(in_q, starts, np.int64(miss))
        return self._offs
