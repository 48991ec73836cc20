#!/usr/bin/env python3
"""Smoke test of the search server on the GPU, against plain references.

    python chip_smoke.py                 # one card: the phases below
    python chip_smoke.py --four-cards    # four cards: sharded serving only

One process owns the card(s); the HTTP server runs in a thread of it.

Single card, phases in order:
  build       the domain-skewed synthetic database of bench.build_skewed_db
              at Swiss-Prot scale (570,000 proteins; --proteins cuts it),
              cached under .bench_cache/
  reference   a numpy brute-force (k-mer -> protein) index taken from the
              database's sequences with codec.encode_kmers only
  serve       server/app.make_server, the code `kaamer-db -server` runs
  protein     64 queries of 100-1,000 aa plus one of >2,048 k-mers that
              repeats a hot domain, plain and with positions=true
  align       16 queries with align=true
  nucleotide  16 genes through six-frame translation, genetic code 11
  fastq       256 reads of 150 bp, JSON and TSV
  kernels     the device Smith-Waterman DP on 256 pairs of 250-1,000 aa
              against the host DP, and the f32 hot contractions at weights
              above 2^11 against numpy

Every route is requested twice: the first answer includes compilation
(cold), the second does not (warm).  Every answer is compared with the
reference: hit ids, counts and position bitmaps exactly (the ranking and
FilterResults of tests/oracle.py), alignments field for field with the host
DP (ops/swalign.py:_smith_waterman).

--four-cards builds the database twice, globally and with `-make -shards 4`,
serves each with n_shards=4 on a (dp=1, shard=4) mesh beside a single-card
server, and requires every answer to be byte-identical across the three and
equal to the reference.

The last line of stdout is {"ok": true, "device": {...}}; any failed phase
or mismatch exits non-zero before it, as does a first device that is not a
GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time
import urllib.parse
import urllib.request

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(HERE, "tests"))

SWISSPROT_PROTEINS = 570_000  # UniProtKB/Swiss-Prot: ~570k reviewed entries
MIN_KMATCH, MIN_KRATIO, MAX_RESULTS = 10, 0.05, 10  # server defaults
AA = "ACDEFGHIKLMNPQRSTVWY"
_CODONS11 = {
    "A": ("GCT", "GCC", "GCA", "GCG"), "C": ("TGT", "TGC"),
    "D": ("GAT", "GAC"), "E": ("GAA", "GAG"), "F": ("TTT", "TTC"),
    "G": ("GGT", "GGC", "GGA", "GGG"), "H": ("CAT", "CAC"),
    "I": ("ATT", "ATC", "ATA"), "K": ("AAA", "AAG"),
    "L": ("TTA", "TTG", "CTT", "CTC", "CTA", "CTG"), "M": ("ATG",),
    "N": ("AAT", "AAC"), "P": ("CCT", "CCC", "CCA", "CCG"),
    "Q": ("CAA", "CAG"), "R": ("CGT", "CGC", "CGA", "CGG", "AGA", "AGG"),
    "S": ("TCT", "TCC", "TCA", "TCG", "AGT", "AGC"),
    "T": ("ACT", "ACC", "ACA", "ACG"), "V": ("GTT", "GTC", "GTA", "GTG"),
    "W": ("TGG",), "Y": ("TAT", "TAC"),
}


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


# ---------------------------------------------------------------------------
# The plain reference
# ---------------------------------------------------------------------------


class KmerReference:
    """Brute-force k-mer counting over a database directory, independent of
    the engine and its index: the database's sequences are read from the
    artifact's sequence blob and cut into k-mers with codec.encode_kmers
    only; only k-mers some query holds are kept (np.isin), as sorted unique
    (k-mer << 32 | row) keys.  count(protein) is the number of query
    positions whose k-mer occurs in the protein, as in tests/oracle.py."""

    def __init__(self, db_path: str, query_kmers: np.ndarray):
        from kaamer_jax import codec

        data = np.fromfile(os.path.join(db_path, "sequences.bin"),
                           dtype=np.uint8)
        off = np.load(os.path.join(db_path, "sequences.off.npy")).astype(
            np.int64)
        self.ids = np.load(os.path.join(db_path, "protein_ids.npy")).astype(
            np.int64)
        kmers = codec.encode_kmers(codec.CHAR_TO_CODE[data])
        # window p belongs to the protein whose sequence holds p .. p+6
        row = np.repeat(np.arange(len(off) - 1, dtype=np.int64), np.diff(off))
        starts = np.arange(kmers.size, dtype=np.int64)
        inside = starts + codec.KMER_SIZE <= off[row[: kmers.size] + 1]
        keep = inside & np.isin(kmers, np.unique(query_kmers))
        keys = (kmers[keep].astype(np.uint64) << np.uint64(32)) | row[
            : kmers.size][keep].astype(np.uint64)
        self.keys = np.unique(keys)

    def search(self, seq: str, size: int, bitmap_ids=()):
        """(hits [(id, count)] ranked count desc then id asc, bitmaps
        {id: bool[size]} for bitmap_ids) for the first `size` k-mers of
        seq."""
        from kaamer_jax import codec

        q = codec.encode_kmers(codec.seq_to_codes(seq))[:size].astype(
            np.uint64)
        lo = np.searchsorted(self.keys, q << np.uint64(32))
        hi = np.searchsorted(self.keys, (q + np.uint64(1)) << np.uint64(32))
        lens = hi - lo
        pos = np.repeat(np.arange(size), lens)
        idx = np.repeat(lo - np.concatenate([[0], np.cumsum(lens)[:-1]]),
                        lens) + np.arange(lens.sum())
        rows = (self.keys[idx] & np.uint64(0xFFFFFFFF)).astype(np.int64)
        ids = self.ids[rows]
        counts = np.bincount(rows)
        nz = np.flatnonzero(counts)
        order = np.lexsort((self.ids[nz], -counts[nz]))
        hits = [(int(self.ids[nz[i]]), int(counts[nz[i]])) for i in order]
        bitmaps = {}
        for pid in bitmap_ids:
            bm = np.zeros(size, dtype=bool)
            bm[pos[ids == pid]] = True
            bitmaps[pid] = bm
        return hits, bitmaps


def filtered(hits, size):
    from oracle import OracleDB

    return OracleDB.filter_hits(hits, size, MIN_KRATIO, MIN_KMATCH,
                                MAX_RESULTS)


# ---------------------------------------------------------------------------
# Workload
# ---------------------------------------------------------------------------


def _mutate(rng, seq: str, rate: float) -> str:
    s = list(seq)
    for p in rng.choice(len(s), size=int(len(s) * rate), replace=False):
        s[p] = AA[int(rng.integers(0, 20))]
    return "".join(s)


def _db_text(rng, seqs, lo: int, hi: int) -> str:
    """A query of lo..hi aa: concatenated database proteins."""
    L = int(rng.integers(lo, hi + 1))
    out = ""
    while len(out) < L:
        out += seqs[int(rng.integers(0, len(seqs)))]
    return out[:L]


def _reverse_translate(rng, prot: str) -> str:
    return "".join(rng.choice(_CODONS11[a]) for a in prot)


def _revcomp(dna: str) -> str:
    return dna[::-1].translate(str.maketrans("ACGT", "TGCA"))


def make_workload(db_path: str, n_proteins: int, seed: int):
    """Protein, long, align, nucleotide and fastq inputs, from a seed."""
    from bench import skewed_domains

    rng = np.random.default_rng(seed)
    data = np.fromfile(os.path.join(db_path, "sequences.bin"), np.uint8)
    off = np.load(os.path.join(db_path, "sequences.off.npy")).astype(
        np.int64)
    picks = rng.choice(len(off) - 1, size=min(4096, len(off) - 1),
                       replace=False)
    seqs = [data[off[i]:off[i + 1]].tobytes().decode() for i in picks]

    protein = [_mutate(rng, _db_text(rng, seqs, 100, 1000), 0.02)
               for _ in range(64)]
    # > 2,048 k-mers, most of them from the most popular (hot) domain: its
    # run weight passes 2^11, the exact range of TF32
    dom = skewed_domains(n_proteins)[0]
    reps = 2100 // (len(dom) - 6) + 2
    long_q = "".join(dom + "".join(rng.choice(list(AA), size=8))
                     for _ in range(reps))
    align = [_mutate(rng, _db_text(rng, seqs, 250, 1000), 0.05)
             for _ in range(16)]

    genes = []
    for g in range(16):
        prot = "M" + _mutate(rng, _db_text(rng, seqs, 250, 1000), 0.03)
        dna = ("".join(rng.choice(list("ACGT"), size=120))
               + _reverse_translate(rng, prot) + "TAA"
               + "".join(rng.choice(list("ACGT"), size=120)))
        genes.append(_revcomp(dna) if g % 2 else dna)
    reads = []
    for r in range(256):
        prot = _db_text(rng, seqs, 60, 60)
        dna = _reverse_translate(rng, prot)
        start = int(rng.integers(0, len(dna) - 150 + 1))
        read = dna[start:start + 150]
        reads.append(_revcomp(read) if r % 2 else read)
    return protein, long_q, align, genes, reads


def fasta(prefix: str, seqs) -> str:
    return "".join(f">{prefix}{i}\n{s}\n" for i, s in enumerate(seqs))


def fastq(reads) -> str:
    return "".join(f"@r{i}\n{s}\n+\n{'I' * len(s)}\n"
                   for i, s in enumerate(reads))


# ---------------------------------------------------------------------------
# Serving and comparison
# ---------------------------------------------------------------------------


def start_server(db_path: str, n_shards: int = 0):
    import tempfile

    from kaamer_jax.server.app import make_server

    httpd, engine = make_server(db_path, port=0, host="127.0.0.1",
                                tmp_folder=tempfile.gettempdir(),
                                n_shards=n_shards, warmup=False)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, f"http://127.0.0.1:{httpd.server_address[1]}"


def post(url: str, route: str, fields: dict) -> bytes:
    data = urllib.parse.urlencode(fields).encode()
    req = urllib.request.Request(url + "/api/search/" + route, data=data)
    with urllib.request.urlopen(req, timeout=1200) as resp:
        check(resp.status == 200, f"{route}: HTTP {resp.status}")
        return resp.read()


def cold_warm(url: str, route: str, fields: dict):
    """(body, cold seconds, warm seconds); both answers must be equal."""
    t0 = time.perf_counter()
    body = post(url, route, fields)
    t1 = time.perf_counter()
    again = post(url, route, fields)
    t2 = time.perf_counter()
    check(body == again, f"{route}: two answers to one request differ")
    return body, t1 - t0, t2 - t1


def compare_protein(body: bytes, queries: dict, ref: KmerReference,
                    positions: bool) -> int:
    """Protein answers vs the reference; returns the number of hits."""
    results = json.loads(body)["results"]
    got = {r["Query"]["Name"]: r for r in results}
    n_hits = 0
    for name, seq in queries.items():
        size = len(seq) - 6
        want = filtered(ref.search(seq, size)[0], size)
        if not want:
            check(name not in got, f"{name}: answered, reference has no hit")
            continue
        check(name in got, f"{name}: no answer, reference has {len(want)}")
        r = got[name]
        check(r["Query"]["SizeInKmer"] == size, f"{name}: SizeInKmer")
        have = [(h["Key"], h["Kmatch"]) for h in r["SearchResults"]["Hits"]]
        check(have == want, f"{name}: hits {have[:4]} != {want[:4]}")
        if positions:
            bms = ref.search(seq, size, [k for k, _ in want])[1]
            pos = r["SearchResults"]["PositionHits"]
            check(sorted(pos) == sorted(str(k) for k, _ in want),
                  f"{name}: position keys")
            for k, _ in want:
                check(pos[str(k)] == bms[k].tolist(), f"{name}: bitmap {k}")
        n_hits += len(have)
    return n_hits


def compare_align(body: bytes, queries: dict, ref: KmerReference,
                  art) -> int:
    """-aln answers: the k-mer hits as a set (alignment re-sorts them by
    bit score), every alignment equal to the host DP's."""
    from kaamer_jax.ops import swalign

    results = json.loads(body)["results"]
    got = {r["Query"]["Name"]: r for r in results}
    n_pairs = 0
    for name, seq in queries.items():
        size = len(seq) - 6
        want = filtered(ref.search(seq, size)[0], size)
        check((name in got) == bool(want), f"{name}: answered != reference")
        if not want:
            continue
        hits = got[name]["SearchResults"]["Hits"]
        check(sorted((h["Key"], h["Kmatch"]) for h in hits) == sorted(want),
              f"{name}: aligned hit set")
        for h in hits:
            subj = art.sequence(art.row_for_id(h["Key"]))
            host = swalign.align(seq, subj, art.stats).to_json_obj()
            check(h["Alignment"] == host,
                  f"{name} vs {h['Key']}: device alignment != host DP")
            n_pairs += 1
    return n_pairs


def compare_translated(body: bytes, path: str, reads: bool,
                       ref: KmerReference) -> int:
    """Nucleotide/FASTQ answers: every ORF of the host six-frame scan is
    counted by the reference; an ORF is answered iff FilterResults keeps a
    hit, with the hits the reference ranks (FilterResults at the answer's
    start-codon-refined SizeInKmer).  ORFs are matched by (record, end
    position, strand), which start-codon refinement leaves unchanged."""
    from kaamer_jax.io_formats.readers import (read_fasta_queries,
                                               read_fastq_queries)
    from kaamer_jax.search.orf import get_orf_tuples_batch

    recs = list(read_fastq_queries(path) if reads
                else read_fasta_queries(path, is_protein=False))
    got = {}
    for r in json.loads(body)["results"]:
        loc = r["Query"]["Location"]
        key = (r["Query"]["Name"], loc["EndPosition"], loc["PlusStrand"])
        check(key not in got, f"{key}: answered twice")
        got[key] = r
    n_hits = 0
    seen = set()
    orfs = get_orf_tuples_batch([r.Sequence for r in recs], 11, min_kmers=1)
    for rec, rec_orfs in zip(recs, orfs):
        for seq, n, _sp, ep, plus, _alts in rec_orfs:
            key = (rec.Name, ep, plus)
            hits = ref.search(seq, n)[0]
            if key not in got:
                check(not filtered(hits, n), f"{key}: reference has hits")
                continue
            seen.add(key)
            r = got[key]
            have = [(h["Key"], h["Kmatch"])
                    for h in r["SearchResults"]["Hits"]]
            want = filtered(hits, r["Query"]["SizeInKmer"])
            check(have == want, f"{key}: hits {have[:4]} != {want[:4]}")
            n_hits += len(have)
    check(seen == set(got), f"answers without an ORF: {set(got) - seen}")
    return n_hits


def tsv_rows_match_json(tsv: bytes, body: bytes, art) -> int:
    """The lean FASTQ TSV path answers the same (read, subject, k-match)
    rows as the JSON path."""
    rows = sorted(tuple(line.split("\t")[i] for i in (0, 1, 4))
                  for line in tsv.decode().splitlines()[1:])
    want = sorted(
        (r["Query"]["Name"], art.entry_id(art.row_for_id(h["Key"])),
         str(h["Kmatch"]))
        for r in json.loads(body)["results"]
        for h in r["SearchResults"]["Hits"])
    check(rows == want, f"fastq TSV rows != JSON rows ({len(rows)} vs "
                        f"{len(want)})")
    return len(rows)


# ---------------------------------------------------------------------------
# Kernel phase
# ---------------------------------------------------------------------------


def kernel_checks(art, seed: int) -> str:
    """The device SW DP at real widths vs the host DP, and the f32 hot
    contractions above TF32's exact range vs numpy."""
    import jax
    import jax.numpy as jnp

    from kaamer_jax.ops import hotset, swalign, swalign_device
    from kaamer_jax.ops.matrices import LETTER_INDEX, get_matrix_scores

    rng = np.random.default_rng(seed)
    scores = get_matrix_scores("blosum62", 11, 1)
    n = art.num_proteins
    pairs = []
    for _ in range(256):
        rows = rng.integers(0, n, size=8)
        text = "".join(art.sequence(int(r)) for r in rows)
        q = text[: int(rng.integers(250, 1001))]
        r = _mutate(rng, q, 0.1)[int(rng.integers(0, 40)):]
        r = (r + text)[: int(rng.integers(250, 1001))]
        pairs.append((q, r))
    codes = [(LETTER_INDEX[np.frombuffer(q.encode(), np.uint8)],
              LETTER_INDEX[np.frombuffer(r.encode(), np.uint8)])
             for q, r in pairs]
    qs, rs = [c[0] for c in codes], [c[1] for c in codes]
    got = swalign_device.sw_batch_device(qs, rs, scores)  # compiles
    for (qa, ra), g in zip(codes, got):
        want = swalign._smith_waterman(qa, ra, scores.sub_matrix,
                                       scores.gap_open, scores.gap_extend)
        check(g == want, "device SW != host DP")
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        swalign_device.sw_batch_device(qs, rs, scores)
        times.append(time.perf_counter() - t0)

    # f32 hot contractions, weights up to 4,095 (TF32 holds 2^11 exactly)
    G, H, P, L = 8, 64, 4096, 4096
    W = rng.integers(0, 4096, size=(G, H)).astype(np.float32)
    W[:, 0] = 4095.0
    M = (rng.random((H, P)) < 0.5).astype(np.float32)
    out = np.asarray(hotset.hot_matmul(jnp.asarray(W), jnp.asarray(M),
                                       max_w=L))
    check(np.array_equal(out.astype(np.float64),
                         W.astype(np.float64) @ M.astype(np.float64)),
          "hot_matmul (f32 M) inexact above 2^11")
    hs = (np.arange(H, dtype=np.int32) + 1) * 1000
    offs = rng.choice(hs, size=(G, L)).astype(np.int32)
    whot = rng.integers(0, 3, size=(G, L)).astype(np.int32)
    whot[:, 0] = 4001
    wref = np.stack([[whot[g][offs[g] == h].sum() for h in hs]
                     for g in range(G)]).astype(np.float64)
    wdev = np.asarray(hotset.hot_weights(jnp.asarray(offs),
                                         jnp.asarray(whot), jnp.asarray(hs)))
    check(np.array_equal(wdev.astype(np.float64), wref),
          "hot_weights (L > 256) inexact above 2^11")
    jax.block_until_ready(wdev)
    return (f"sw 256 pairs 250-1000 aa exact; warm batch "
            f"{min(times) * 1e3:.1f} ms (DP + traceback + decode, best of 3); "
            f"f32 hot_matmul/hot_weights exact at 4095/4001")


# ---------------------------------------------------------------------------
# Runs
# ---------------------------------------------------------------------------


class Phases:
    """Runs named phases, prints one line per phase with its wall time, and
    re-raises any failure after naming the phase."""

    def __init__(self):
        self.t0 = time.perf_counter()
        self.cold = 0.0

    def run(self, name, fn, *args):
        t0 = time.perf_counter()
        try:
            detail = fn(*args)
        except SmokeFailure as e:
            print(f"phase {name}: MISMATCH {e}", flush=True)
            raise
        except Exception as e:
            print(f"phase {name}: FAILED {type(e).__name__}: {e}", flush=True)
            raise
        print(f"phase {name}: ok wall={time.perf_counter() - t0:.1f}s "
              f"{detail}", flush=True)

    def done(self):
        print(f"cold-start compile (sum over requests of cold - warm): "
              f"{self.cold:.1f}s; total wall "
              f"{time.perf_counter() - self.t0:.1f}s", flush=True)


def ensure_db(path: str, n_proteins: int, n_shards: int = 0):
    """Build (once, cached) or load the skewed database; n_shards builds the
    same proteins with a per-shard index (kaamer-db -make -shards N)."""
    import shutil

    from bench import build_skewed_db

    from kaamer_jax.index.artifact import load_db

    if not os.path.exists(os.path.join(path, "meta.json")):
        tmp = path + ".building"
        shutil.rmtree(tmp, ignore_errors=True)
        build_skewed_db(tmp, n_proteins, n_shards=n_shards)
        os.rename(tmp, path)
    return load_db(path)


def prepare(db: str, n_proteins: int, seed: int, state: dict) -> str:
    """The workload and the reference over every k-mer it queries."""
    from kaamer_jax import codec
    from kaamer_jax.search.orf import get_orf_tuples_batch

    protein, long_q, align, genes, reads = make_workload(db, n_proteins, seed)
    state["work"] = (protein, long_q, align, genes, reads)
    orf_seqs = [o[0] for rec in get_orf_tuples_batch(
        genes + reads, 11, min_kmers=1) for o in rec]
    qk = np.concatenate([codec.encode_kmers(codec.seq_to_codes(s))
                         for s in protein + [long_q] + align + orf_seqs])
    state["ref"] = KmerReference(db, qk)
    return f"{state['ref'].keys.size} (k-mer, protein) keys"


def protein_phase(ask, state) -> str:
    """64 protein queries plus the long one, plain and with positions."""
    protein, long_q, _, _, _ = state["work"]
    queries = {f"p{i}": s for i, s in enumerate(protein)}
    queries["long"] = long_q
    text = fasta("p", protein) + f">long\n{long_q}\n"
    n = 0
    for pos in ("false", "true"):
        body = ask("protein", {"type": "string", "sequence": text,
                               "positions": pos, "output-format": "json"})
        n += compare_protein(body, queries, state["ref"], pos == "true")
        check("long" in {r["Query"]["Name"]
                         for r in json.loads(body)["results"]},
              "the long query found no hit")
    return f"{len(queries)} queries (long: {len(long_q) - 6} k-mers), {n} hits"


def translated_phase(ask, state, route: str) -> str:
    """16 genes (nucleotide) or 256 reads (fastq), JSON and lean TSV."""
    import tempfile

    _, _, _, genes, reads = state["work"]
    is_reads = route == "fastq"
    text = fastq(reads) if is_reads else fasta("g", genes)
    body = ask(route, {"type": "string", "sequence": text, "gcode": "11",
                       "output-format": "json"})
    tsv = ask(route, {"type": "string", "sequence": text, "gcode": "11"})
    with tempfile.NamedTemporaryFile("w", suffix=".txt", delete=False) as f:
        f.write(text)
    try:
        n = compare_translated(body, f.name, is_reads, state["ref"])
    finally:
        os.remove(f.name)
    check(n > 0, f"no {route} hit")
    rows = tsv_rows_match_json(tsv, body, state["art"])
    return f"{len(reads) if is_reads else len(genes)} inputs, {n} hits, " \
           f"TSV rows {rows} equal to JSON"


def run_single(n_proteins: int, seed: int, cache: str) -> None:
    ph = Phases()
    db = os.path.join(cache, f"smoke_skew_{n_proteins}")
    state = {}
    log = []

    def ask(route, fields):
        body, cold, warm = cold_warm(state["url"], route, fields)
        ph.cold += cold - warm
        log.append(f"cold={cold:.1f}s warm={warm:.2f}s")
        return body

    def timed(fn, *args):
        log.clear()
        return f"{fn(*args)} [{'; '.join(log)}]"

    def build():
        state["art"] = ensure_db(db, n_proteins)
        return f"{state['art'].num_proteins} proteins at {db}"

    def serve():
        state["httpd"], state["url"] = start_server(db)
        return state["url"]

    def align_phase():
        from kaamer_jax.ops import swalign_device

        align = state["work"][2]
        body = ask("protein", {"type": "string", "sequence": fasta("a", align),
                               "align": "true", "output-format": "json"})
        check(swalign_device._DP_CACHE,
              "the alignments did not run on the device")
        n = compare_align(body, {f"a{i}": s for i, s in enumerate(align)},
                          state["ref"], state["art"])
        return f"{len(align)} queries, {n} alignments equal to the host DP"

    ph.run("build", build)
    ph.run("reference", prepare, db, n_proteins, seed, state)
    ph.run("serve", serve)
    try:
        ph.run("protein", timed, protein_phase, ask, state)
        ph.run("align", timed, align_phase)
        ph.run("nucleotide", timed, translated_phase, ask, state,
               "nucleotide")
        ph.run("fastq", timed, translated_phase, ask, state, "fastq")
        ph.run("kernels", kernel_checks, state["art"], seed)
    finally:
        state["httpd"].shutdown()
        state["httpd"].server_close()
    ph.done()


def run_four(n_proteins: int, seed: int, cache: str) -> None:
    import jax

    check(len(jax.devices()) == 4, f"--four-cards needs 4 devices, found "
                                   f"{len(jax.devices())}")
    ph = Phases()
    db = os.path.join(cache, f"smoke_skew_{n_proteins}")
    sdb = db + "_shards4"
    state = {}

    def ask(route, fields):
        """One request to each server; all three answers byte-identical."""
        bodies = {}
        for name, (_, url) in state["servers"].items():
            body, cold, warm = cold_warm(url, route, fields)
            bodies[name] = body
            ph.cold += cold - warm
        for name, body in bodies.items():
            check(body == bodies["single"],
                  f"{route}: {name} bytes != single card")
        return bodies["single"]

    def build():
        state["art"] = ensure_db(db, n_proteins)
        sart = ensure_db(sdb, n_proteins, n_shards=4)
        check(sart.index_shards == 4, "shard-built database")
        return f"{n_proteins} proteins, global and -shards 4"

    def serve():
        state["servers"] = {
            "single": start_server(db),
            "global x4": start_server(db, n_shards=4),
            "shard-built x4": start_server(sdb),
        }
        return ", ".join(state["servers"])

    ph.run("build", build)
    ph.run("reference", prepare, db, n_proteins, seed, state)
    ph.run("serve", serve)
    try:
        ph.run("protein x3 servers", protein_phase, ask, state)
        for route in ("nucleotide", "fastq"):
            ph.run(f"{route} x3 servers", translated_phase, ask, state,
                   route)
    finally:
        for httpd, _ in state["servers"].values():
            httpd.shutdown()
            httpd.server_close()
    ph.done()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--four-cards", action="store_true",
                   help="run only the sharded-serving path on 4 cards")
    p.add_argument("--proteins", type=int, default=SWISSPROT_PROTEINS,
                   help="database size (default: Swiss-Prot scale)")
    p.add_argument("--seed", type=int, default=1)
    args = p.parse_args(argv)

    from kaamer_jax.compile_cache import enable_compile_cache
    from kaamer_jax.device_info import card_name_and_power_limit, require_gpu

    device = require_gpu()
    print(f"card: {card_name_and_power_limit()}", flush=True)
    print(f"jax: {device}; compile cache {enable_compile_cache()}",
          flush=True)
    cache = os.environ.get("KAAMER_BENCH_CACHE",
                           os.path.join(HERE, ".bench_cache"))
    os.makedirs(cache, exist_ok=True)
    try:
        if args.four_cards:
            run_four(args.proteins, args.seed, cache)
        else:
            run_single(args.proteins, args.seed, cache)
    except Exception as e:
        print(f"chip_smoke: FAILED ({type(e).__name__}: {e})",
              file=sys.stderr, flush=True)
        return 1
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
