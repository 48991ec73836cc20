"""Benchmark harness: search throughput on one chip, on a SKEWED database.

Prints ONE JSON line:
  {"metric": "...", "value": N, "unit": "queries/s", "vs_baseline": N,
   "extra": {...}}

Databases are domain-skewed synthetics: proteins share power-law-popular
"domains", so k-mer postings lists have the heavy-tailed family structure
real UniProt has -- the regime the reference's KComb store exists for
(kcomb_store.go:42-63).  A uniformly random DB (also reported, for
continuity with earlier rounds) flatters the engine: its postings lists are
tiny and the adaptive expansion capacity never grows.

Headline: protein queries/s against the 10k-protein skewed DB.  `extra`
carries {10k, 100k[, 1M]} x {plain, positions} figures, the fastq pipeline
rate, and an alignment rate through the device Smith-Waterman DP.

vs_baseline divides the headline by a MEASURED CPU stand-in
(CPU_BASELINE_r*.json, produced by scripts/cpu_baseline.py): an in-memory
C++ replica of the reference hot-loop shape (search.go:421-436, including
its strconv.Itoa + string-keyed counter increments per posting) minus the
Badger LSM reads and protobuf varint decoding -- strictly FASTER than the
Go reference on the same host, so the multiplier is a lower bound.  No
such record exists for the current machine, so vs_baseline is omitted.

Every run records the device it ran on (platform, device kind, count, and
the card's name and power limit from nvidia-smi) and exits non-zero when
JAX's first device is not a GPU.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

DB_PROTEINS = 10_000
N_QUERIES = 16_384
BATCH = 2048
SEQ_LEN_RANGE = (120, 400)
QUERY_LEN = 250  # uniform bucket so every batch hits one compiled shape


def _cpu_baseline():
    """Latest committed CPU_BASELINE_r*.json (see module docstring), or
    None when never measured (vs_baseline is then omitted, not invented)."""
    import glob
    import re

    best, best_n = None, -1
    here = os.path.dirname(os.path.abspath(__file__))
    for p in glob.glob(os.path.join(here, "CPU_BASELINE_r*.json")):
        m = re.search(r"_r(\d+)", os.path.basename(p))
        if m and int(m.group(1)) > best_n:
            best, best_n = p, int(m.group(1))
    if best is None:
        return None
    with open(best) as f:
        d = json.load(f)
    d["artifact"] = os.path.basename(best)
    return d

# Databases live inside the checkout (gitignored), so a later run finds
# the 1M-protein build again.
CACHE_ROOT = os.environ.get(
    "KAAMER_BENCH_CACHE",
    os.path.join(os.path.dirname(os.path.abspath(__file__)), ".bench_cache"))
# soft wall-clock budget: the uncached 1M build (~10-15 min) is skipped when
# it cannot fit (the cached artifact makes later runs cheap)
BUDGET_S = float(os.environ.get("KAAMER_BENCH_BUDGET_S", "3000"))

AA = np.array(list("ACDEFGHIKLMNPQRSTVWY"))


def build_synthetic_db(path: str, n_proteins: int = DB_PROTEINS) -> None:
    """Uniformly random proteins (the flattering regime; kept for the
    continuity figure)."""
    from kaamer_jax.index.build import build_db

    rng = np.random.default_rng(1234)
    fasta = path + ".fasta"
    with open(fasta, "w") as f:
        for i in range(n_proteins):
            L = int(rng.integers(*SEQ_LEN_RANGE))
            seq = "".join(rng.choice(AA, size=L))
            f.write(f">P{i:06d} synthetic\n{seq}\n")
    build_db(path, fasta, "fasta")
    os.remove(fasta)


def _skew_domains(rng, n_proteins: int) -> list:
    return ["".join(rng.choice(AA, size=int(rng.integers(30, 90))))
            for _ in range(max(64, n_proteins // 50))]


def skewed_domains(n_proteins: int, seed: int = 77) -> list:
    """The domain library build_skewed_db(path, n_proteins, seed) draws
    from, most popular first."""
    return _skew_domains(np.random.default_rng(seed), n_proteins)


def build_skewed_db(path: str, n_proteins: int, seed: int = 77,
                    n_shards: int = 0) -> None:
    """Domain-skewed synthetic: each protein concatenates 1-3 library
    domains (popularity ~ 1/(rank+5): the most popular domain appears in a
    few percent of all proteins) with random linkers.  Consecutive k-mers of
    a shared domain resolve to one postings set whose length scales with the
    domain's popularity -- power-law postings, shared k-mer families, cap
    growth, and host-fallback outliers all get exercised.  n_shards > 1
    builds a per-shard index, as `kaamer-db -make -shards N` does."""
    from kaamer_jax.index.build import build_db

    rng = np.random.default_rng(seed)
    dom_seqs = _skew_domains(rng, n_proteins)
    D = len(dom_seqs)
    pop = 1.0 / (np.arange(D) + 5.0)
    pop /= pop.sum()

    # vectorized draws; linkers slice a shared random pool
    n_dom = rng.integers(1, 4, size=n_proteins)
    dom_idx = rng.choice(D, size=(n_proteins, 3), p=pop)
    pool = "".join(rng.choice(AA, size=1 << 22))
    link_off = rng.integers(0, (1 << 22) - 128, size=(n_proteins, 4))
    link_len = rng.integers(8, 40, size=(n_proteins, 4))

    fasta = path + ".fasta"
    with open(fasta, "w") as f:
        for i in range(n_proteins):
            parts = []
            for d in range(int(n_dom[i])):
                o, l = int(link_off[i, d]), int(link_len[i, d])
                parts.append(pool[o : o + l])
                parts.append(dom_seqs[int(dom_idx[i, d])])
            o, l = int(link_off[i, 3]), int(link_len[i, 3])
            parts.append(pool[o : o + l + 20])
            f.write(f">S{i:07d} skewed\n{''.join(parts)}\n")
    build_db(path, fasta, "fasta", n_shards=n_shards)
    os.remove(fasta)


def make_queries(art, rng, n_queries: int = N_QUERIES) -> list:
    """Queries sampled from DB proteins with point mutations (realistic hit
    profile: high-identity matches plus background)."""
    aa = list("ACDEFGHIKLMNPQRSTVWY")
    n = art.num_proteins
    queries = []
    for _ in range(n_queries):
        row = int(rng.integers(0, n))
        seq = art.sequence(row)
        if len(seq) > QUERY_LEN:
            start = int(rng.integers(0, len(seq) - QUERY_LEN))
            seq = seq[start : start + QUERY_LEN]
        else:
            seq = (seq * (QUERY_LEN // len(seq) + 1))[:QUERY_LEN]
        s = list(seq)
        for _ in range(int(rng.integers(0, 12))):
            p = int(rng.integers(0, len(s)))
            s[p] = aa[int(rng.integers(0, 20))]
        queries.append("".join(s))
    return queries


def ensure_db(path: str, builder, *args):
    from kaamer_jax.index.artifact import load_db

    if os.path.exists(os.path.join(path, "meta.json")):
        try:
            return load_db(path)
        except ValueError:  # stale cache from an older index format
            import shutil

            shutil.rmtree(path, ignore_errors=True)
    builder(path, *args)
    return load_db(path)


def bench_protein(engine, queries, positions: bool, passes: int = 3) -> float:
    """Pipelined protein-search throughput (dispatch every batch before
    resolving any; best-of-N steady-state passes)."""
    sizes = [len(q) - 6 for q in queries]
    n = len(queries)
    # warm: the first dispatches of each shape compile
    for _ in range(2):
        engine.count_batch(queries[:BATCH], sizes[:BATCH], k=10,
                           positions=positions)
    schedule = getattr(engine, "schedule_batch", None)
    collect = getattr(engine, "collect_batch", None)
    if schedule is None or collect is None:
        schedule, collect = (lambda h: h), engine.resolve_batch
    best = None
    for _ in range(passes):
        t0 = time.perf_counter()
        handles = [
            engine.dispatch_batch(queries[i : i + BATCH],
                                  sizes[i : i + BATCH], k=10,
                                  positions=positions)
            for i in range(0, n, BATCH)
        ]
        # schedule all phase-2 work before collecting any: the device queue
        # stays full while the host finalizes earlier batches; prefetch
        # then enqueues certificate re-runs before any collect blocks on
        # them (engine.prefetch_batch)
        scheds = [schedule(h) for h in handles]
        prefetch = getattr(engine, "prefetch_batch", None)
        if prefetch is not None:
            scheds = [prefetch(s) for s in scheds]
        for s in scheds:
            collect(s)
        dt = time.perf_counter() - t0
        best = dt if best is None else min(best, dt)
    return n / best


# one codon per amino acid (table 11) for reverse-translating bench reads
_AA2CODON = {
    "A": "gct", "C": "tgt", "D": "gat", "E": "gaa", "F": "ttt", "G": "ggt",
    "H": "cat", "I": "att", "K": "aaa", "L": "ctt", "M": "atg", "N": "aat",
    "P": "cct", "Q": "caa", "R": "cgt", "S": "tct", "T": "act", "V": "gtt",
    "W": "tgg", "Y": "tat",
}


def bench_fastq(engine, art, rng, tmpdir: str) -> float:
    """Translated-reads throughput through the full fastq pipeline
    (read -> 6-frame ORF scan -> batched device search -> filtering)."""
    from kaamer_jax.search.options import READS, SearchOptions
    from kaamer_jax.search.pipeline import run_search

    n_reads = 8_192
    path = os.path.join(tmpdir, "bench_reads.fq")
    with open(path, "w") as f:
        for i in range(n_reads):
            row = int(rng.integers(0, art.num_proteins))
            seq = art.sequence(row)
            start = int(rng.integers(0, max(len(seq) - 50, 1)))
            frag = seq[start : start + 50]
            dna = "taa" + "".join(_AA2CODON.get(a, "gct") for a in frag) + "taa"
            f.write(f"@r{i}\n{dna}\n+\n{'I' * len(dna)}\n")
    # warm the ORF-length shape buckets (compiles happen here, not in timing)
    warm = os.path.join(tmpdir, "warm.fq")
    with open(warm, "w") as fw, open(path) as fr:
        fw.write("".join(line for _, line in zip(range(4 * 3072), fr)))
    for _ in run_search(engine, SearchOptions(File=warm, SequenceType=READS)):
        pass

    opts = SearchOptions(File=path, SequenceType=READS)
    best = None
    for _ in range(2):
        t0 = time.perf_counter()
        # the lean TSV path yields one bytes chunk per device batch, so
        # count result ROWS (newlines beyond the header), not chunks
        n_out = sum(chunk.count(b"\n") for chunk in
                    run_search(engine, opts)) - 1
        dt = time.perf_counter() - t0
        best = dt if best is None else min(best, dt)
    assert n_out > n_reads // 2, f"fastq bench found too few hits ({n_out})"
    return n_reads / best


def bench_align_e2e(engine, art, rng, tmpdir: str) -> float:
    """End-to-end `-aln` protein serving: full run_search stream with
    Align=True, so alignment pairs accumulate ACROSS queries and flush
    through the device wavefront DP in real batches (the reference pays
    per-hit host DP here, align.go:46-161).  Returns queries/s."""
    from kaamer_jax.search.options import PROTEIN, SearchOptions
    from kaamer_jax.search.pipeline import run_search

    n_q = 1024
    queries = make_queries(art, rng, n_queries=n_q)
    path = os.path.join(tmpdir, "bench_aln.fasta")
    with open(path, "w") as f:
        for i, q in enumerate(queries):
            f.write(f">q{i}\n{q}\n")
    opts = SearchOptions(File=path, SequenceType=PROTEIN, OutFormat="tsv",
                         Align=True, MaxResults=3)
    for _ in run_search(engine, opts):  # compile + warm
        pass
    best = None
    for _ in range(2):
        t0 = time.perf_counter()
        n_out = sum(1 for _ in run_search(engine, opts))
        dt = time.perf_counter() - t0
        best = dt if best is None else min(best, dt)
    assert n_out > n_q // 2
    return n_q / best


def bench_align(engine, art, rng):
    """Alignment throughput through the device Smith-Waterman wavefront
    DP (the per-hit cost the reference pays on every -aln query,
    align.go:46-161).  Returns aligned pairs/s."""
    from kaamer_jax.ops import swalign

    n_pairs = 256
    queries = make_queries(art, rng, n_queries=n_pairs)
    sizes = [len(q) - 6 for q in queries]
    qcs = engine.count_batch(queries, sizes, k=4)
    pairs = []
    for q, qc in zip(queries, qcs):
        if len(qc.hit_rows):
            pairs.append((q, art.sequence(int(qc.hit_rows[0]))))
    assert len(pairs) >= n_pairs // 2

    align = lambda: swalign.align_batch(pairs, art.stats)
    res = align()  # compile + warm
    assert res[0].Length > 0
    best = None
    for _ in range(2):
        t0 = time.perf_counter()
        align()
        dt = time.perf_counter() - t0
        best = dt if best is None else min(best, dt)
    return len(pairs) / best


def main() -> None:
    from kaamer_jax.compile_cache import enable_compile_cache
    from kaamer_jax.device_info import card_name_and_power_limit, require_gpu

    device = require_gpu()
    card = card_name_and_power_limit()
    enable_compile_cache()

    from kaamer_jax.search.engine import SearchEngine

    def note(msg):  # progress on stderr; stdout stays one JSON line
        print(f"# {msg}", file=sys.stderr, flush=True)

    note(f"device {device} card {card}")
    sizes_env = os.environ.get("KAAMER_BENCH_SIZES", "10000,100000,1000000")
    sizes = [int(s) for s in sizes_env.split(",") if s]

    per_db = {}
    skipped = []
    engine10k = art10k = None
    t_start = time.perf_counter()
    for n in sizes:
        path = os.path.join(CACHE_ROOT, f"skew_{n}")
        cached = os.path.exists(os.path.join(path, "meta.json"))
        elapsed = time.perf_counter() - t_start
        if n >= 1_000_000 and not cached and BUDGET_S - elapsed < 1500:
            # an uncached 1M build costs ~10-15 min; skip rather than lose
            # the whole bench to the wall clock (next run finds it cached)
            skipped.append(n)
            note(f"db n={n}: SKIPPED (uncached build does not fit the "
                 f"remaining {BUDGET_S - elapsed:.0f}s budget)")
            continue
        note(f"db n={n}: build/load")
        art = ensure_db(path, build_skewed_db, n)
        engine = SearchEngine(art)
        rng = np.random.default_rng(99)
        nq = {10_000: 8192, 100_000: 4096}.get(n, 2048)
        queries = make_queries(art, rng, n_queries=nq)
        note(f"db n={n}: protein qps ({nq} queries)")
        # the headline figure gets an extra pass
        qps = bench_protein(engine, queries, positions=False,
                            passes=3 if n == DB_PROTEINS else 2)
        note(f"db n={n}: protein qps with positions")
        qps_pos = bench_protein(engine, queries, positions=True, passes=2)
        per_db[str(n)] = {
            "qps": round(qps, 1),
            "qps_positions": round(qps_pos, 1),
            "kmer_lookups_per_s": round(qps * (QUERY_LEN - 6), 1),
            "n_queries": nq,
        }
        note(f"db n={n}: done {per_db[str(n)]} t={time.perf_counter()-t_start:.0f}s")
        if n == DB_PROTEINS:
            engine10k, art10k = engine, art
        else:
            del engine  # free device memory before the next size

    # continuity figure: the uniformly random 10k DB earlier rounds reported
    note("random-db continuity figure")
    rand_path = os.environ.get("KAAMER_BENCH_DB",
                               os.path.join(CACHE_ROOT, "random_10000"))
    art_r = ensure_db(rand_path, build_synthetic_db)
    eng_r = SearchEngine(art_r)
    rng = np.random.default_rng(99)
    q_r = make_queries(art_r, rng, n_queries=8192)
    random_qps = bench_protein(eng_r, q_r, positions=False, passes=2)
    del eng_r

    import tempfile

    fastq_rps = None
    if engine10k is None:
        # KAAMER_BENCH_SIZES without the 10k DB: the fastq/aln sections
        # need the headline engine -- skip them instead of crashing
        os.environ["KAAMER_BENCH_NO_ALIGN"] = "1"
    else:
        note("fastq pipeline")
        rng = np.random.default_rng(7)
        with tempfile.TemporaryDirectory() as td:
            fastq_rps = bench_fastq(engine10k, art10k, rng, td)
        note(f"fastq done t={time.perf_counter()-t_start:.0f}s")

    aligned_qps = None
    aln_e2e_qps = None
    if not os.environ.get("KAAMER_BENCH_NO_ALIGN"):
        aligned_qps = round(bench_align(engine10k, art10k, rng), 1)
        note("end-to-end -aln serving")
        with tempfile.TemporaryDirectory() as td:
            aln_e2e_qps = round(bench_align_e2e(engine10k, art10k, rng, td), 1)

    head = per_db.get(str(DB_PROTEINS)) or next(iter(per_db.values()))
    cpu = _cpu_baseline()
    vs = round(head["qps"] / cpu["queries_per_s"], 2) if cpu else None
    vs_1m = None
    if (cpu and "1000000" in cpu.get("per_db", {})
            and "1000000" in per_db):
        vs_1m = round(per_db["1000000"]["qps"]
                      / cpu["per_db"]["1000000"]["queries_per_s"], 2)
    print(
        json.dumps(
            {
                "metric": (
                    f"protein queries/s (skewed {DB_PROTEINS}-protein DB, "
                    f"{QUERY_LEN}aa queries, 1 chip)"
                ),
                "value": head["qps"],
                "unit": "queries/s",
                "vs_baseline": vs,
                "extra": {
                    "baseline_note": (
                        "vs_baseline = headline / MEASURED in-memory C++ "
                        "stand-in of the reference hot loop "
                        f"({cpu['artifact'] if cpu else 'absent'}; strictly "
                        "faster than Go/Badger, so this is a lower bound)"
                    ),
                    "platform": device["platform"],
                    "device_kind": device["kind"],
                    "device_count": device["count"],
                    "card": card,
                    "cpu_baseline_qps": cpu and cpu["queries_per_s"],
                    "cpu_baseline_1m_qps": (
                        cpu and cpu.get("per_db", {})
                        .get("1000000", {}).get("queries_per_s")),
                    "vs_baseline_1m": vs_1m,
                    "skewed_db": per_db,
                    "random_db_qps_10k": round(random_qps, 1),
                    "fastq_reads_per_s": (fastq_rps and round(fastq_rps, 1)),
                    "aligned_pairs_per_s": aligned_qps,
                    "aln_queries_per_s": aln_e2e_qps,
                    "skipped_dbs": skipped,
                    "batch": BATCH,
                    "query_len": QUERY_LEN,
                },
            }
        )
    )


if __name__ == "__main__":
    main()
