"""Database build: makedb + indexdb fused into a sort-based pipeline.

The reference builds its database by streaming (kmer -> protein_id) inserts
into a multi-version LSM tree (makedb/inputFASTA.go:245-248) and then runs a
second "index" pass that replays every k-mer's versions to build deduplicated
protein-set records (indexdb.go:68-150, kcomb_store.go:42-85).

Here the same result is produced as one vectorized pipeline over flat arrays:

  1. parse proteins, encode each sequence's sliding-window 7-mers
     (codec.encode_kmers) and collect (kmer<<32 | protein_row) uint64 pairs;
  2. radix-sort the pairs (np.sort) and drop duplicates -- duplicates arise
     when a k-mer occurs twice in one protein, exactly the case the
     reference's RemoveDuplicatesFromSlice handles (kv_store.go:284-305);
  3. group by k-mer; deduplicate identical protein sets (the KComb concept)
     by double-64-bit segment hashing;
  4. build the cuckoo k-mer table with inline (start, len) postings slices
     (hashtable.build_table).

An unindexed build (-noindex) stops after step 2 and persists the sorted
pairs, which keeps split builds mergeable (mergedb semantics).
"""

from __future__ import annotations

import datetime
import os
from typing import Iterable, List, Optional, Tuple

import json
import numpy as np

from .. import codec
from ..io_formats import PARSERS
from ..records import KSettings, KStats, Protein
from . import artifact
from .hashtable import build_table

KMER_SIZE = 7

# A single index's postings array is addressed by uint32 slice starts inline
# in the cuckoo table (hashtable.py) and int32 offsets on device, so one
# index -- the global artifact, or EACH SHARD of a sharded build -- is capped
# here.  Databases above it must be built sharded (index_db n_shards > 1),
# which emits per-shard artifacts with local starts (the reference scales by
# LSM disk instead, kv_stores.go:40-44).
MAX_POSTINGS = 2**31


# Pair volume held in memory before a sorted chunk spills to disk.  The
# build's peak RSS is ~2x this (the chunk plus numpy's sort scratch) plus
# the 64 MB extraction window -- the out-of-core analogue of the reference's
# bounded insert channel + maxsize mode (kv_store.go:77-127,
# kv_stores.go:40-44).  Overridable for tests / small machines via
# KAAMER_BUILD_SPILL_BYTES.
SPILL_BYTES_DEFAULT = 1 << 30


def _spill_budget() -> int:
    return int(os.environ.get("KAAMER_BUILD_SPILL_BYTES",
                              SPILL_BYTES_DEFAULT))


def _kway_merge_u64(spill_files: List[str], out_path: str,
                    block_elems: int = 1 << 20) -> None:
    """Merge sorted uint64 spill files into a .npy at out_path, streaming:
    peak memory is bounded by ~2 * n_files * block_elems * 8 bytes.

    Classic pivot-block merge: hold one block per file, cut every block at
    the smallest block-end value across files (everything <= that pivot is
    globally mergeable), sort the concatenated cut, append to the output.
    At least one full block is consumed per iteration.  All I/O is buffered
    reads/writes, NOT memmaps -- dirty/resident mapped pages would count
    against the process RSS and defeat the memory bound."""
    sizes = [os.path.getsize(f) // 8 for f in spill_files]
    total = sum(sizes)
    fhs = [open(f, "rb") for f in spill_files]
    remaining = list(sizes)
    bufs = [np.empty(0, dtype=np.uint64) for _ in fhs]
    offs = [0] * len(fhs)

    def refill(i: int) -> None:
        if offs[i] == bufs[i].shape[0] and remaining[i]:
            n = min(block_elems, remaining[i])
            bufs[i] = np.fromfile(fhs[i], dtype=np.uint64, count=n)
            remaining[i] -= n
            offs[i] = 0

    w = 0
    with open(out_path, "wb") as out:
        np.lib.format.write_array_header_1_0(
            out, {"descr": "<u8", "fortran_order": False, "shape": (total,)})
        while True:
            for i in range(len(fhs)):
                refill(i)
            alive = [i for i in range(len(fhs)) if offs[i] < bufs[i].shape[0]]
            if not alive:
                break
            pivot = min(bufs[i][-1] for i in alive)
            parts = []
            for i in alive:
                cut = offs[i] + int(np.searchsorted(
                    bufs[i][offs[i]:], pivot, side="right"))
                if cut > offs[i]:
                    parts.append(bufs[i][offs[i]:cut])
                    offs[i] = cut
            merged = parts[0] if len(parts) == 1 else np.sort(
                np.concatenate(parts))
            merged.tofile(out)
            w += merged.shape[0]
    for f in fhs:
        f.close()
    assert w == total


def _collect_proteins_streaming(
    entries: Iterable[Tuple[int, Protein]],
    db_path: str,
    progress: bool = False,
    spill_bytes: int = 0,
) -> KStats:
    """Stream protein columns into the artifact (append-only blob files) and
    (kmer<<32 | protein_row) pairs into sorted on-disk spill chunks, then
    k-way-merge the chunks into <db>/pairs.npy.  Memory stays bounded by the
    spill budget regardless of input size (reference: bounded insert
    channel, kv_store.go:77-127).

    K-mer pair extraction and chunk sorts run through the native C++
    kernels (kaamer_jax/native) when the toolchain is available, with a
    numpy fallback."""
    import shutil

    from .. import native

    spill_bytes = spill_bytes or _spill_budget()
    # each sequence byte becomes one 8-byte pair, so the extraction window
    # must stay well under the spill budget or a single flush overshoots it
    window_bytes = min(64_000_000, max(1 << 20, spill_bytes // 16))
    writer = artifact.StreamWriter(db_path)
    spill_dir = os.path.join(db_path, "_spill")
    os.makedirs(spill_dir, exist_ok=True)
    spill_files: List[str] = []

    pair_chunks: List[np.ndarray] = []
    pair_bytes = 0

    # pending chunk of concatenated sequence bytes for batch extraction
    chunk_seqs: List[bytes] = []
    chunk_base = 0
    chunk_bytes = 0

    count_aa = 0
    count_kmers = 0

    def spill(final: bool) -> Optional[np.ndarray]:
        """Sort the pending pair chunks; write them to a spill file (or, on
        the final call with no prior spills, return them directly)."""
        nonlocal pair_bytes
        if not pair_chunks:
            # nothing pending: only the no-spill empty build needs a result
            return (np.empty(0, dtype=np.uint64)
                    if final and not spill_files else None)
        pairs = np.concatenate(pair_chunks)
        pair_chunks.clear()
        pair_bytes = 0
        pairs = native.sort_u64(pairs)
        if final and not spill_files:
            return pairs  # single-chunk build: no disk round trip
        path = os.path.join(spill_dir, f"chunk{len(spill_files):05d}.bin")
        pairs.tofile(path)
        spill_files.append(path)
        return None

    def flush_chunk():
        nonlocal chunk_seqs, chunk_base, chunk_bytes, pair_bytes
        if not chunk_seqs:
            return
        buf = np.frombuffer(b"".join(chunk_seqs), dtype=np.uint8)
        offs = np.zeros(len(chunk_seqs) + 1, dtype=np.int64)
        np.cumsum([len(s) for s in chunk_seqs], out=offs[1:])
        chunk = native.extract_pairs(buf, offs, chunk_base)
        pair_chunks.append(chunk)
        pair_bytes += chunk.nbytes
        chunk_base += len(chunk_seqs)
        chunk_seqs = []
        chunk_bytes = 0
        if pair_bytes >= spill_bytes:
            spill(final=False)

    for row, (pid, prot) in enumerate(entries):
        seq_b = prot.Sequence.encode("utf-8")
        writer.add(
            pid, prot.Length, prot.EntryId.encode("utf-8"), seq_b,
            json.dumps(prot.Features, separators=(",", ":")).encode("utf-8")
            if prot.Features else b"",
        )
        count_aa += prot.Length
        count_kmers += prot.Length - KMER_SIZE + 1

        chunk_seqs.append(seq_b)
        chunk_bytes += len(seq_b)
        if chunk_bytes >= window_bytes:
            flush_chunk()
        if progress and (row + 1) % 10000 == 0:
            print(f"Processed {row + 1} proteins")

    flush_chunk()
    pairs = spill(final=True)
    writer.finish()

    pairs_path = os.path.join(db_path, "pairs.npy")
    if pairs is not None:
        np.save(pairs_path, pairs)
        del pairs
    else:
        # size merge blocks so one iteration's live parts (n_files blocks +
        # their concatenated sort copy) stay within ~half the spill budget
        block = max(1 << 16, spill_bytes // (32 * max(1, len(spill_files))))
        _kway_merge_u64(spill_files, pairs_path, block_elems=block)
    shutil.rmtree(spill_dir, ignore_errors=True)

    return KStats(
        NumberOfProteins=writer.count,
        NumberOfAA=count_aa,
        NumberOfKmers=count_kmers,
        NumberOfKCombSets=0,
    )


def build_db(
    db_path: str,
    input_path: str,
    input_fmt: str = "fasta",
    offset: int = 0,
    length: Optional[int] = None,
    no_index: bool = False,
    progress: bool = False,
    n_shards: int = 0,
) -> None:
    """makedb equivalent (reference makedb.go:33-82).  n_shards > 1 emits a
    sharded index (see index_db) for databases beyond MAX_POSTINGS."""
    input_fmt = input_fmt.lower()
    if input_fmt not in PARSERS:
        raise ValueError(f"Input format unrecognized: {input_fmt}")
    parser, default_features = PARSERS[input_fmt]

    kwargs = {"offset": offset}
    if length is not None:
        kwargs["length"] = length

    def stream():
        for item in parser(input_path, **kwargs):
            yield item

    # TSV derives the feature list from its header row (inputTSV.go:98,185-190)
    if input_fmt == "tsv":
        from ..io_formats.readers import open_maybe_gzip

        with open_maybe_gzip(input_path) as f:
            header = f.readline().rstrip("\n").split("\t")
        default_features = [h for h in header if h.lower() not in ("entryid", "sequence")]

    stats = _collect_proteins_streaming(stream(), db_path, progress=progress)
    stats.Features = list(default_features or [])

    db_name = os.path.basename(os.path.normpath(db_path))
    settings = KSettings(
        Name=db_name,
        Port=8321,
        CreationDate=datetime.date.today().isoformat(),
        OriginalFile=os.path.basename(input_path),
        DatabaseIndexed=False,
    )
    artifact.write_meta(db_path, stats, settings, indexed=False)

    if not no_index:
        index_db(db_path, progress=progress, n_shards=n_shards)


def dedup_sets(pairs: np.ndarray):
    """Group sorted (kmer<<32|row) pairs by k-mer and deduplicate identical
    protein sets (the KComb construction, kcomb_store.go:42-63, done here as
    vectorized segment hashing instead of per-key xxhash + collision probing).

    Returns (unique_kmers u32[U], set_id_per_kmer u32[U],
             set_offsets u64[S+1], postings u32[P]).
    """
    if pairs.size == 0:
        return (
            np.empty(0, np.uint32),
            np.empty(0, np.uint32),
            np.zeros(1, np.uint64),
            np.empty(0, np.uint32),
        )

    # Drop duplicate (kmer,row) pairs -- same k-mer repeated within a protein.
    # (Memory note: every step below frees its large intermediates as soon as
    # possible; at 1M proteins / 260M pairs the transient working set is the
    # difference between ~12 GB and ~40 GB peak RSS.)
    pairs = pairs[np.concatenate(([True], pairs[1:] != pairs[:-1]))]

    kmers = (pairs >> np.uint64(32)).astype(np.uint32)
    rows = (pairs & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    del pairs
    N = kmers.size

    new_group = np.concatenate(([True], kmers[1:] != kmers[:-1]))
    group_starts = np.flatnonzero(new_group)
    del new_group
    unique_kmers = kmers[group_starts]
    del kmers
    group_lens = np.diff(np.append(group_starts, N))

    # Two independent 64-bit positional segment hashes.  With <=2^32 sets the
    # probability of any 128-bit collision is negligible (<2^-60).  The
    # per-element hash inputs (row, position-in-group) are generated per
    # group chunk, so only ONE full-length uint64 array exists at a time.
    def mix(x: np.ndarray, c1: int, c2: int) -> np.ndarray:
        x = (x ^ (x >> np.uint64(33))) * np.uint64(c1)
        x = (x ^ (x >> np.uint64(29))) * np.uint64(c2)
        return x ^ (x >> np.uint64(32))

    G = group_starts.size
    GCH = 1 << 22
    bounds = np.append(group_starts, N)
    e = np.empty(N, dtype=np.uint64)

    def fill_e(variant: int) -> None:
        for g0 in range(0, G, GCH):
            g1 = min(G, g0 + GCH)
            lo, hi = int(bounds[g0]), int(bounds[g1])
            pos = (
                np.arange(lo, hi, dtype=np.int64)
                - np.repeat(group_starts[g0:g1], group_lens[g0:g1])
            ).astype(np.uint64)
            r64 = rows[lo:hi].astype(np.uint64)
            if variant == 0:
                e[lo:hi] = mix(r64 + (pos << np.uint64(32)),
                               0xFF51AFD7ED558CCD, 0xC4CEB9FE1A85EC53)
            else:
                e[lo:hi] = mix(r64 * np.uint64(0x9E3779B97F4A7C15) + pos,
                               0xC2B2AE3D27D4EB4F, 0x165667B19E3779F9)

    fill_e(0)
    h1 = np.add.reduceat(e, group_starts)
    fill_e(1)
    h2 = np.add.reduceat(e, group_starts)
    del e, bounds
    h1 += group_lens.astype(np.uint64)  # include set length

    # Unique over the 128-bit signature via lexsort (cheaper than np.unique
    # on a structured view, which argsorts void records).  Run boundaries are
    # computed in chunks to avoid full sorted-key copies.
    order = np.lexsort((h2, h1))
    is_new = np.empty(unique_kmers.size, dtype=bool)
    is_new[:1] = True
    CH = 1 << 25
    for c0 in range(1, unique_kmers.size, CH):
        c1 = min(unique_kmers.size, c0 + CH)
        cur = order[c0:c1]
        prv = order[c0 - 1:c1 - 1]
        is_new[c0:c1] = (h1[cur] != h1[prv]) | (h2[cur] != h2[prv])
    del h1, h2
    n_sets = int(is_new.sum())
    set_id_sorted = np.cumsum(is_new, dtype=np.uint32) - np.uint32(1)
    set_id_per_kmer = np.empty(unique_kmers.size, dtype=np.uint32)
    set_id_per_kmer[order] = set_id_sorted
    # lexsort is stable, so run starts carry the lowest original index --
    # the same representative np.unique(return_index=True) would pick
    rep_idx = order[is_new]
    del order, set_id_sorted, is_new

    # CSR for the unique sets, taking each set's representative group.
    rep_starts = group_starts[rep_idx]
    rep_lens = group_lens[rep_idx]
    set_offsets = np.zeros(n_sets + 1, dtype=np.uint64)
    np.cumsum(rep_lens.astype(np.uint64), out=set_offsets[1:])
    total = int(set_offsets[-1])
    postings = np.empty(total, dtype=np.uint32)
    # Vectorized segment copy.
    src = (
        np.repeat(rep_starts.astype(np.int64), rep_lens)
        + (np.arange(total, dtype=np.int64)
           - np.repeat(set_offsets[:-1].astype(np.int64), rep_lens))
    )
    postings[:] = rows[src]

    return unique_kmers, set_id_per_kmer, set_offsets, postings


class _NpyStreamWriter:
    """Append-only .npy writer (buffered file I/O, not memmap -- dirty
    mapped pages count against RSS).  A fixed 128-byte header is patched
    with the final shape on close."""

    _HLEN = 128

    def __init__(self, path: str, descr: str):
        self.path = path
        self.descr = descr
        self.count = 0
        self.f = open(path, "wb")
        self.f.write(b"\x00" * self._HLEN)

    def write(self, arr: np.ndarray) -> None:
        arr.tofile(self.f)
        self.count += arr.shape[0]

    def close(self) -> None:
        head = (f"{{'descr': '{self.descr}', 'fortran_order': False, "
                f"'shape': ({self.count},), }}").encode()
        body = head + b" " * (self._HLEN - 10 - 1 - len(head)) + b"\n"
        self.f.seek(0)
        self.f.write(b"\x93NUMPY\x01\x00")
        self.f.write(np.uint16(len(body)).tobytes())
        self.f.write(body)
        self.f.close()


def _group_end(pairs: np.ndarray, j: int, n: int) -> int:
    """Smallest index >= j where the k-mer changes from pairs[j-1]'s (so a
    range cut never splits a k-mer's group)."""
    key = np.uint64(int(pairs[j - 1]) >> 32)
    B = 1 << 20
    while j < n:
        blk = np.asarray(pairs[j : j + B]) >> np.uint64(32)
        idx = np.flatnonzero(blk != key)
        if idx.size:
            return j + int(idx[0])
        j += blk.shape[0]
    return n


def index_db(db_path: str, progress: bool = False,
             chunk_pairs: int = 0, n_shards: int = 0) -> None:
    """indexdb equivalent (reference indexdb.go:34-66): turn the sorted pair
    representation into the servable hash-table + CSR postings artifact.

    Out-of-core discipline: pairs stream through dedup_sets in k-mer RANGES
    of ~chunk_pairs (default: the spill budget) -- the pairs are k-mer
    sorted, so every group falls entirely inside one range.  Set dedup is
    therefore range-local: a protein set shared by k-mers in different
    ranges is stored once per range (slightly larger artifact, identical
    search results; the reference's global KComb dedup trades the same
    memory for disk the other way, kcomb_store.go:42-63).  Postings and set
    offsets append straight to disk, so peak memory is ~15x the RANGE bytes
    plus the O(unique-kmers) key/value arrays the final hash table needs
    anyway.

    n_shards > 1 emits a SHARDED index -- per-shard cuckoo tables, postings
    and set offsets under <db>/shardNN/, each with shard-LOCAL uint32 slice
    starts -- routed by set identity (parallel/mesh.shard_owner semantics:
    set routing keeps query k-mer runs whole on their owner shard).  This is
    the only way past MAX_POSTINGS: every shard is its own uint32-addressed
    postings space, so a database is buildable and servable as long as each
    SHARD stays under the cap.  Sharded artifacts are served by
    parallel.dist.ShardedSearchEngine on an n_shards-wide mesh.

    Writes the index files in place next to the untouched protein columns
    (the reference likewise swaps in a new kmer_store and leaves the protein
    store alone, indexdb.go:53-55) -- re-materializing the columns here
    would defeat the out-of-core build."""
    db = artifact.load_db(db_path, mmap=True)
    if db.indexed:
        raise ValueError(f"{db_path} is already indexed")
    if progress:
        print("# Creating key combination store")

    pairs = db.pairs
    n = pairs.shape[0]
    chunk = chunk_pairs or max(1 << 20, _spill_budget() // 8)
    S = max(int(n_shards), 1)

    from ..parallel.mesh import shard_owner, split_set_mask

    # per-shard accumulation (S == 1 is the plain global artifact)
    uk_chunks: List[List[np.ndarray]] = [[] for _ in range(S)]
    st_chunks: List[List[np.ndarray]] = [[] for _ in range(S)]
    len_chunks: List[List[np.ndarray]] = [[] for _ in range(S)]
    if S == 1:
        dirs = [db_path]
    else:
        dirs = [os.path.join(db_path, f"shard{s:02d}") for s in range(S)]
        for d in dirs:
            os.makedirs(d, exist_ok=True)
    posts_w = [_NpyStreamWriter(os.path.join(d, "postings.npy.tmp"), "<u4")
               for d in dirs]
    offs_w = [_NpyStreamWriter(os.path.join(d, "set_offsets.npy.tmp"), "<u8")
              for d in dirs]
    for w in offs_w:
        w.write(np.zeros(1, dtype=np.uint64))
    set_base = 0
    post_base = [0] * S
    i = 0
    while i < n:
        j = min(n, i + chunk)
        if j < n:
            j = _group_end(pairs, j, n)
        uk, sid, so, post = dedup_sets(np.asarray(pairs[i:j]))
        n_sets = so.shape[0] - 1
        sid64 = sid.astype(np.int64)
        so64 = so.astype(np.int64)
        if S == 1:
            set_owner = split = None
        else:
            # route each SET (all its k-mers and postings) to one shard --
            # except long sets, which split contiguously across ALL shards
            # for expansion load balance (mesh.split_set_mask; the serving
            # layout in mesh.shard_index_arrays applies the same rule, and
            # tests assert the two layouts are bit-equal)
            set_owner = shard_owner(
                (set_base + np.arange(n_sets)).astype(np.uint32), S)
            split = split_set_mask(so64[1:] - so64[:-1], S)
        for s in range(S):
            if S == 1:
                uk_s, sid_s = uk, sid64
                so_s, post_s = so, post
            else:
                sel_sets = split | (set_owner == s)
                sets_s = np.flatnonzero(sel_sets).astype(np.int64)
                ls_lens = so64[sets_s + 1] - so64[sets_s]
                ls_split = split[sets_s]
                lo = so64[sets_s] + np.where(ls_split, ls_lens * s // S, 0)
                hi = so64[sets_s] + np.where(
                    ls_split, ls_lens * (s + 1) // S, ls_lens)
                lens_s = hi - lo
                ksel = sel_sets[sid64]
                uk_s = uk[ksel]
                # chunk-set id -> shard-local rank (sets_s is sorted)
                sid_s = np.searchsorted(sets_s, sid64[ksel])
                so_s = np.zeros(sets_s.size + 1, dtype=np.uint64)
                np.cumsum(lens_s.astype(np.uint64), out=so_s[1:])
                total = int(so_s[-1])
                src = (np.repeat(lo, lens_s)
                       + np.arange(total, dtype=np.int64)
                       - np.repeat(so_s[:-1].astype(np.int64), lens_s))
                post_s = post[src]
            uk_chunks[s].append(uk_s)
            # the cuckoo table stores each k-mer's (start, len) postings
            # slice inline (hashtable.py layout), so resolve chunk-local set
            # ids to (shard-)global slice coordinates here
            st_chunks[s].append(
                (so_s[sid_s] + np.uint64(post_base[s])).astype(np.uint32))
            len_chunks[s].append((so_s[sid_s + 1] - so_s[sid_s]).astype(np.uint32))
            offs_w[s].write(so_s[1:] + np.uint64(post_base[s]))
            posts_w[s].write(post_s)
            post_base[s] += post_s.shape[0]
        set_base += n_sets
        i = j
        if progress and n:
            print(f"# indexed {i * 100 // n}% of pairs")
    for w in posts_w:
        w.close()
    for w in offs_w:
        w.close()
    if max(post_base) >= MAX_POSTINGS:
        raise ValueError(
            f"postings larger than {MAX_POSTINGS} per index; rebuild with "
            f"more shards (index_db n_shards > {S})" if S > 1 else
            f"postings larger than {MAX_POSTINGS} need a sharded index "
            f"(index_db n_shards > 1)")

    # per-shard cuckoo tables share one row-count log2 so the serving mesh
    # can stack them shape-identically (parallel/mesh.py)
    def _cat(chunks):
        return [np.concatenate(c) if c else np.empty(0, np.uint32)
                for c in chunks]

    uk_all, st_all, ln_all = _cat(uk_chunks), _cat(st_chunks), _cat(len_chunks)
    for lst in (uk_chunks, st_chunks, len_chunks):
        lst.clear()
    common_t = 0
    while True:
        tables = [build_table(uk_all[s], st_all[s], ln_all[s],
                              min_log2=common_t) for s in range(S)]
        t_max = max(t.log2 for t in tables)
        common_t = t_max
        if all(t.log2 == t_max for t in tables):
            break
    del uk_all, st_all, ln_all

    db.stats.NumberOfKCombSets = set_base
    db.settings.DatabaseIndexed = True

    for s, d in enumerate(dirs):
        np.save(os.path.join(d, "hash_table.npy"), tables[s].table)
        for name in ("postings.npy", "set_offsets.npy"):
            os.replace(os.path.join(d, name + ".tmp"),
                       os.path.join(d, name))
    artifact.write_meta(db_path, db.stats, db.settings, indexed=True,
                        hash_log2=common_t,
                        index_shards=S if S > 1 else 0)
    pairs_file = os.path.join(db_path, "pairs.npy")
    db.pairs = None  # drop the memmap before unlinking
    if os.path.exists(pairs_file):
        os.remove(pairs_file)
