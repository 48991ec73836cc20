"""Randomized end-to-end differential fuzz of the nucleotide pipeline.

A pure-Python mirror (Python ORF scanner + dict oracle + the shared
start-codon refinement) predicts every TSV row of run_search over random
genomic sequences with embedded reverse-translated DB fragments.  This
crosses the native ORF scanner, length bucketing/batching, the device search
with device-computed position bitmaps, the MinKMatch top-hit gate
(search_nucleotide.go:116), SetBestStartCodon, filtering, and formatting.
"""

import numpy as np
import pytest

from kaamer_jax.index.build import build_db
from kaamer_jax.index.artifact import load_db
from kaamer_jax.io_formats.readers import QueryRecord, QueryLocation
from kaamer_jax.search.engine import SearchEngine
from kaamer_jax.search.options import NUCLEOTIDE, SearchOptions
from kaamer_jax.search.orf import KMER_SIZE, _get_orfs_py, set_best_start_codon
from kaamer_jax.search.pipeline import run_search
from kaamer_jax.search.results import _f32_pct
from oracle import OracleDB
from tests_codon_helper import encode_protein

AA = "ACDEFGHIKMNPQRSTVWY"  # no L: reverse translation stays start-free


@pytest.fixture(scope="module")
def nt_db(tmp_path_factory):
    rng = np.random.default_rng(55)
    tmp = tmp_path_factory.mktemp("ntfuzz")
    fasta = tmp / "db.fasta"
    seqs = []
    with open(fasta, "w") as f:
        for i in range(30):
            L = int(rng.integers(50, 140))
            s = "M" + "".join(rng.choice(list(AA), size=L))
            seqs.append(s)
            f.write(f">NT{i} prot {i}\n{s}\n")
    dbdir = str(tmp / "db")
    build_db(dbdir, str(fasta), "fasta")
    art = load_db(dbdir)
    oracle = OracleDB(
        [(int(art.protein_ids[i]), art.protein(i)) for i in range(art.num_proteins)]
    )
    return SearchEngine(art), oracle, seqs


def _random_dna(rng, seqs):
    """DNA carrying 1-2 reverse-translated protein fragments on random
    strands, padded with random bases."""
    from kaamer_jax.search.orf import reverse_complement

    parts = ["".join(rng.choice(list("acgt"), size=int(rng.integers(5, 40))))]
    for _ in range(int(rng.integers(1, 3))):
        prot = seqs[int(rng.integers(0, len(seqs)))]
        lo = int(rng.integers(0, max(1, len(prot) - 30)))
        frag = prot[lo : lo + int(rng.integers(25, 70))]
        dna = "atg" + encode_protein(frag) + "taa"
        if rng.integers(0, 2):
            dna = reverse_complement(dna)
        parts.append(dna)
        parts.append("".join(rng.choice(list("acgt"), size=int(rng.integers(5, 40)))))
    return "".join(parts)


def _expected_rows(oracle, dna, name, opts):
    """The pipeline's TSV rows computed entirely in Python."""
    rows = set()
    for orf in _get_orfs_py(dna, opts.GeneticCode):
        n = len(orf.Sequence) - KMER_SIZE + 1
        if orf.Sequence.endswith("*"):
            n -= 1
        if n < 1:
            continue
        hits, positions = oracle.kmer_search(orf.Sequence, n)
        if not hits or hits[0][1] < opts.MinKMatch:
            continue
        q = QueryRecord(
            Sequence=orf.Sequence, Name=name, SizeInKmer=n,
            Location=QueryLocation(
                StartPosition=orf.Location.StartPosition,
                EndPosition=orf.Location.EndPosition,
                PlusStrand=orf.Location.PlusStrand,
                StartsAlternative=list(orf.Location.StartsAlternative),
            ),
        )
        pos = {pid: list(bm) for pid, bm in positions.items()}
        set_best_start_codon(q, hits, pos)
        kept = OracleDB.filter_hits(hits, q.SizeInKmer, opts.MinKRatio,
                                    opts.MinKMatch, opts.MaxResults)
        for pid, c in kept:
            rows.add((
                name,
                oracle.proteins[pid].EntryId,
                _f32_pct(c, q.SizeInKmer),
                str(q.SizeInKmer),
                str(c),
                str(q.Location.StartPosition),
                str(q.Location.EndPosition),
            ))
    return rows


def test_nucleotide_rows_match_python_mirror(nt_db, tmp_path):
    engine, oracle, seqs = nt_db
    rng = np.random.default_rng(91)
    records = {f"g{i}": _random_dna(rng, seqs) for i in range(30)}
    qfile = tmp_path / "genes.fasta"
    with open(qfile, "w") as f:
        for nm, dna in records.items():
            f.write(f">{nm}\n{dna}\n")

    opts = SearchOptions(File=str(qfile), SequenceType=NUCLEOTIDE,
                         OutFormat="tsv", MaxResults=5, MinKMatch=10,
                         MinKRatio=0.05, GeneticCode=11)
    body = b"".join(run_search(engine, opts)).decode()
    got = set()
    for line in body.strip().split("\n")[1:]:
        c = line.split("\t")
        got.add((c[0], c[1], c[2], c[3], c[4], c[6], c[7]))

    want = set()
    for nm, dna in records.items():
        want |= _expected_rows(oracle, dna, nm, opts)

    assert got == want
