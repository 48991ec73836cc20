"""FASTQ/reads search and nucleotide JSON output."""

import json

import numpy as np
import pytest

from kaamer_jax.index.build import build_db
from kaamer_jax.index.artifact import load_db
from kaamer_jax.search.engine import SearchEngine
from kaamer_jax.search.options import NUCLEOTIDE, READS, SearchOptions
from kaamer_jax.search.pipeline import run_search
from tests_codon_helper import encode_protein

AA = "ACDEFGHIKMNPQRSTVWY"  # no L to keep reverse-translation start-free


@pytest.fixture(scope="module")
def db(tmp_path_factory):
    rng = np.random.default_rng(31)
    tmp = tmp_path_factory.mktemp("fqdb")
    fasta = tmp / "db.fasta"
    seqs = []
    with open(fasta, "w") as f:
        for i in range(25):
            L = int(rng.integers(60, 160))
            s = "M" + "".join(rng.choice(list(AA), size=L))
            seqs.append(s)
            f.write(f">FQ{i} prot {i}\n{s}\n")
    dbdir = str(tmp / "db")
    build_db(dbdir, str(fasta), "fasta")
    return SearchEngine(load_db(dbdir)), seqs


def test_fastq_search_finds_source_protein(db, tmp_path):
    engine, seqs = db
    # a "read" covering the first 40 aa of protein 5, with stop flank
    frag = seqs[5][:40]
    read = "taa" + encode_protein(frag) + "taa"
    fq = tmp_path / "reads.fq"
    fq.write_text(f"@r1\n{read}\n+\n{'I' * len(read)}\n")

    opts = SearchOptions(File=str(fq), SequenceType=READS, OutFormat="tsv",
                         MaxResults=2, MinKMatch=10)
    out = b"".join(run_search(engine, opts)).decode()
    lines = out.strip().split("\n")
    assert len(lines) >= 2
    cols = lines[1].split("\t")
    assert cols[0] == "r1"
    assert cols[1] == "FQ5"
    assert int(cols[4]) >= 30  # most of the 34 k-mers


def test_nucleotide_json_location_fields(db, tmp_path):
    engine, seqs = db
    frag = seqs[8][:50]
    gene = "cc" + "tag" + encode_protein(frag) + "tga" + "g"
    qf = tmp_path / "g.fasta"
    qf.write_text(f">contig7 something\n{gene}\n")

    opts = SearchOptions(File=str(qf), SequenceType=NUCLEOTIDE,
                         OutFormat="json", MaxResults=2)
    doc = json.loads(b"".join(run_search(engine, opts)).decode())
    results = [r for r in doc["results"]
               if any(h["Kmatch"] >= 30 for h in r["SearchResults"]["Hits"])]
    assert results
    r = results[0]
    assert r["Query"]["Type"] == "DNA Query"
    assert r["Query"]["Contig"] == "contig7 something"
    assert r["Query"]["Name"] == "contig7 something"
    loc = r["Query"]["Location"]
    # ORF opens at the atg after the tag stop: 1-based position 6
    assert loc["StartPosition"] == 6
    assert loc["EndPosition"] == len(gene) - 1
    assert loc["PlusStrand"] is True
    assert loc["StartsAlternative"] == []
    # translated queries always carry PositionHits (search.go:416)
    assert r["SearchResults"]["PositionHits"]


def test_gcode_option_changes_translation(db, tmp_path):
    engine, seqs = db
    # ctg ... in gcode 11 ctg is a start codon; in gcode 6 it is not a start
    frag = seqs[3][:40]
    gene = "tag" + "ctg" + encode_protein(frag)[3:] + "taa"
    qf = tmp_path / "g2.fasta"
    qf.write_text(f">c\n{gene}\n")

    rows = {}
    for gcode in (11, 6):
        opts = SearchOptions(File=str(qf), SequenceType=NUCLEOTIDE,
                             OutFormat="tsv", MaxResults=2, GeneticCode=gcode,
                             MinKMatch=5)
        out = b"".join(run_search(engine, opts)).decode()
        rows[gcode] = out.strip().split("\n")[1:]
    # table 11 opens an ORF at the ctg; table 6 does not (different QStart
    # or no hit row at all)
    assert rows[11] != rows[6]


def test_lean_tsv_path_byte_identical(db, tmp_path):
    """The plain-TSV translated-read fast path (pipeline.LEAN_NT_TSV) must
    produce byte-identical output to the generic QueryResult path across
    both strands, multi-ORF reads, start-codon refinement (reads with
    internal Met/alt starts) and hit filtering."""
    from kaamer_jax.search import pipeline

    engine, seqs = db
    rng = np.random.default_rng(77)
    reads = []
    for i in range(60):
        src = seqs[int(rng.integers(0, len(seqs)))]
        start = int(rng.integers(0, max(len(src) - 45, 1)))
        # inject Met/Leu so alternative starts exist and refinement runs
        frag = "MV" + src[start : start + 40] + "LM"
        dna = "taa" + encode_protein(frag) + "taa"
        if i % 3 == 0:  # minus strand
            comp = {"a": "t", "t": "a", "g": "c", "c": "g"}
            dna = "".join(comp[c] for c in reversed(dna))
        if i % 5 == 0:  # junk read (gated out)
            dna = "".join(rng.choice(list("acgt"), size=len(dna)))
        reads.append(dna)

    for ext, content in (
        ("fq", "".join(f"@r{i}\n{d}\n+\n{'I' * len(d)}\n"
                       for i, d in enumerate(reads))),
        ("fasta", "".join(f">c{i} nt\n{d}\n" for i, d in enumerate(reads))),
    ):
        p = tmp_path / f"reads.{ext}"
        p.write_text(content)
        opts = SearchOptions(
            File=str(p), OutFormat="tsv", MaxResults=3,
            SequenceType=READS if ext == "fq" else NUCLEOTIDE)
        lean = b"".join(run_search(engine, opts))
        pipeline.LEAN_NT_TSV = False
        try:
            generic = b"".join(run_search(engine, opts))
        finally:
            pipeline.LEAN_NT_TSV = True
        assert lean == generic
        assert lean.count(b"\n") > 10  # real rows compared, not two headers


def test_lean_tsv_path_is_engaged_by_default(db, tmp_path, monkeypatch):
    """The high-volume serving shape (tsv, no positions/annotations/align)
    must actually route through the lean path -- guard against an option
    plumbing change silently falling back to the generic object path."""
    from kaamer_jax.search import pipeline

    engine, seqs = db
    fq = tmp_path / "r.fq"
    read = "taa" + encode_protein(seqs[2][:30]) + "taa"
    fq.write_text(f"@r0\n{read}\n+\n{'I' * len(read)}\n")

    called = []
    orig = pipeline._nucleotide_search_lean_tsv

    def spy(*a, **kw):
        called.append(1)
        return orig(*a, **kw)

    monkeypatch.setattr(pipeline, "_nucleotide_search_lean_tsv", spy)
    out = b"".join(run_search(engine, SearchOptions(
        File=str(fq), SequenceType=READS)))
    assert called, "lean TSV path not engaged for default read search"
    assert out.count(b"\n") >= 2  # header + the hit row
