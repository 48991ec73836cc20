"""Randomized end-to-end differential fuzz: full run_search output (TSV and
JSON) across an options grid must agree with the dict-based oracle on hit
identity, order, Kmatch counts, and position bitmaps."""

import json

import numpy as np
import pytest

from kaamer_jax.index.build import build_db
from kaamer_jax.index.artifact import load_db
from kaamer_jax.search.engine import SearchEngine
from kaamer_jax.search.options import PROTEIN, SearchOptions
from kaamer_jax.search.pipeline import run_search
from kaamer_jax.search.results import format_positions
from oracle import OracleDB

AA = "ACDEFGHIKLMNPQRSTUVWY"


@pytest.fixture(scope="module")
def fuzz_db(tmp_path_factory):
    rng = np.random.default_rng(77)
    seqs = []
    for _ in range(40):
        L = int(rng.integers(40, 160))
        seqs.append("".join(rng.choice(list(AA), size=L)))
    # overlapping families so ties and shared k-mer sets occur
    core = "".join(rng.choice(list(AA), size=30))
    for i in (3, 7, 11):
        seqs[i] = seqs[i][:10] + core + seqs[i][10:]
    seqs[12] = core + core  # duplicate k-mers inside one protein

    tmp = tmp_path_factory.mktemp("fuzzdb")
    fasta = tmp / "in.fasta"
    with open(fasta, "w") as f:
        for i, s in enumerate(seqs):
            f.write(f">FZ{i} fuzz prot {i}\n{s}\n")
    dbdir = str(tmp / "db")
    build_db(dbdir, str(fasta), "fasta")
    art = load_db(dbdir)
    oracle = OracleDB(
        [(int(art.protein_ids[i]), art.protein(i)) for i in range(art.num_proteins)]
    )
    return art, oracle, seqs, tmp


def _make_queries(seqs, rng, n):
    queries = []
    for _ in range(n):
        base = seqs[int(rng.integers(0, len(seqs)))]
        lo = int(rng.integers(0, max(1, len(base) - 15)))
        q = list(base[lo : lo + int(rng.integers(12, 100))])
        for _ in range(int(rng.integers(0, 4))):
            q[int(rng.integers(0, len(q)))] = AA[int(rng.integers(0, len(AA)))]
        if len(q) >= 7:
            queries.append("".join(q))
    return queries


OPTION_GRID = [
    dict(MaxResults=3, MinKMatch=1, MinKRatio=0.0, ExtractPositions=False),
    dict(MaxResults=10, MinKMatch=5, MinKRatio=0.05, ExtractPositions=True),
    dict(MaxResults=1, MinKMatch=1, MinKRatio=0.3, ExtractPositions=True),
    dict(MaxResults=25, MinKMatch=10, MinKRatio=0.05, ExtractPositions=False),
]


@pytest.mark.parametrize("grid", range(len(OPTION_GRID)))
def test_tsv_output_matches_oracle(fuzz_db, grid, tmp_path):
    art, oracle, seqs, _ = fuzz_db
    rng = np.random.default_rng(100 + grid)
    queries = _make_queries(seqs, rng, 25)
    qfile = tmp_path / f"q{grid}.fasta"
    with open(qfile, "w") as f:
        for i, q in enumerate(queries):
            f.write(f">q{i}\n{q}\n")

    engine = SearchEngine(art)
    opts = SearchOptions(File=str(qfile), SequenceType=PROTEIN,
                         OutFormat="tsv", **OPTION_GRID[grid])
    body = b"".join(run_search(engine, opts)).decode()
    lines = [l for l in body.strip().split("\n")[1:] if l]

    # group output rows per query
    got = {}
    for line in lines:
        cols = line.split("\t")
        got.setdefault(cols[0], []).append(cols)

    o = OPTION_GRID[grid]
    for i, q in enumerate(queries):
        size = len(q) - 6
        hits, positions = oracle.kmer_search(q, size)
        kept = oracle.filter_hits(hits, size, o["MinKRatio"], o["MinKMatch"],
                                  o["MaxResults"])
        rows = got.get(f"q{i}", [])
        assert len(rows) == len(kept), f"query q{i} row count"
        for (pid, c), cols in zip(kept, rows):
            assert cols[1] == oracle.proteins[pid].EntryId, f"q{i} hit id"
            assert int(cols[4]) == c, f"q{i} kmatch"
            if o["ExtractPositions"]:
                want = format_positions(positions[pid], False)
                assert cols[-1] == want, f"q{i} positions"


def test_json_output_matches_oracle(fuzz_db, tmp_path):
    art, oracle, seqs, _ = fuzz_db
    rng = np.random.default_rng(200)
    queries = _make_queries(seqs, rng, 20)
    qfile = tmp_path / "qj.fasta"
    with open(qfile, "w") as f:
        for i, q in enumerate(queries):
            f.write(f">q{i}\n{q}\n")

    engine = SearchEngine(art)
    opts = SearchOptions(File=str(qfile), SequenceType=PROTEIN,
                         OutFormat="json", MaxResults=5, MinKMatch=2,
                         MinKRatio=0.01, ExtractPositions=True, Annotations=True)
    body = b"".join(run_search(engine, opts)).decode()
    doc = json.loads(body)
    assert doc["dbProteinFeatures"] == ["ProteinName"]

    by_query = {}
    for r in doc["results"]:
        by_query.setdefault(r["Query"]["Name"], r)

    for i, q in enumerate(queries):
        size = len(q) - 6
        hits, positions = oracle.kmer_search(q, size)
        kept = oracle.filter_hits(hits, size, 0.01, 2, 5)
        r = by_query.get(f"q{i}")
        if not kept:
            assert r is None
            continue
        assert r is not None, f"q{i} missing"
        got_hits = r["SearchResults"]["Hits"]
        assert [(h["Key"], h["Kmatch"]) for h in got_hits] == kept
        pos = r["SearchResults"]["PositionHits"]
        for pid, _ in kept:
            assert pos[str(pid)] == positions[pid], f"q{i} bitmap {pid}"
