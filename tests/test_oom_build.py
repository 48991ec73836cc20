"""Out-of-core build: spill/merge equality, chunked indexing equality, and
the bounded-RSS guarantee (reference analogue: the bounded insert channel +
maxsize mode, kv_store.go:77-127, kv_stores.go:40-44)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from kaamer_jax.index.build import _kway_merge_u64, build_db, index_db
from kaamer_jax.index.artifact import load_db

AA = "ACDEFGHIKLMNPQRSTVWY"


def _write_fasta(path, n, rng, lo=40, hi=120):
    with open(path, "w") as f:
        for i in range(n):
            L = int(rng.integers(lo, hi))
            f.write(f">S{i:06d} synthetic {i}\n"
                    + "".join(rng.choice(list(AA), size=L)) + "\n")


def test_kway_merge_matches_full_sort(tmp_path):
    rng = np.random.default_rng(4)
    chunks = [np.sort(rng.integers(0, 2**63, size=int(rng.integers(1, 9000)),
                                   dtype=np.uint64)) for _ in range(7)]
    files = []
    for i, c in enumerate(chunks):
        p = str(tmp_path / f"c{i}.bin")
        c.tofile(p)
        files.append(p)
    out = str(tmp_path / "merged.npy")
    _kway_merge_u64(files, out, block_elems=513)  # odd block: boundary stress
    got = np.load(out)
    want = np.sort(np.concatenate(chunks))
    np.testing.assert_array_equal(got, want)


def test_spill_build_matches_single_chunk(tmp_path, monkeypatch):
    """A build forced through many tiny spills produces byte-identical pairs
    and an equivalent indexed artifact."""
    rng = np.random.default_rng(12)
    fasta = str(tmp_path / "in.fasta")
    _write_fasta(fasta, 400, rng)

    db_big = str(tmp_path / "db_big")
    build_db(db_big, fasta, "fasta", no_index=True)  # default budget: 1 chunk

    monkeypatch.setenv("KAAMER_BUILD_SPILL_BYTES", "65536")  # ~30 spills
    db_spill = str(tmp_path / "db_spill")
    build_db(db_spill, fasta, "fasta", no_index=True)

    np.testing.assert_array_equal(np.load(db_big + "/pairs.npy"),
                                  np.load(db_spill + "/pairs.npy"))
    for name in ("protein_ids", "protein_lengths"):
        np.testing.assert_array_equal(np.load(f"{db_big}/{name}.npy"),
                                      np.load(f"{db_spill}/{name}.npy"))
    for name in ("entry_ids", "sequences", "features"):
        with open(f"{db_big}/{name}.bin", "rb") as a, \
             open(f"{db_spill}/{name}.bin", "rb") as b:
            assert a.read() == b.read(), name

    # index both; same-chunk indexing must be fully identical
    index_db(db_big)
    index_db(db_spill)
    for name in ("hash_table", "set_offsets", "postings"):
        np.testing.assert_array_equal(np.load(f"{db_big}/{name}.npy"),
                                      np.load(f"{db_spill}/{name}.npy"))


def test_chunked_index_same_results(tmp_path):
    """Range-chunked indexing (set dedup is range-local) must return the
    exact same search results as single-range indexing."""
    from kaamer_jax.search.engine import SearchEngine

    rng = np.random.default_rng(23)
    fasta = str(tmp_path / "in.fasta")
    _write_fasta(fasta, 300, rng)

    db_a = str(tmp_path / "db_a")
    build_db(db_a, fasta, "fasta", no_index=True)
    index_db(db_a)  # single range

    db_b = str(tmp_path / "db_b")
    build_db(db_b, fasta, "fasta", no_index=True)
    index_db(db_b, chunk_pairs=1000)  # dozens of ranges

    art_a, art_b = load_db(db_a), load_db(db_b)
    # range-local dedup may store a shared set once per range
    assert art_b.stats.NumberOfKCombSets >= art_a.stats.NumberOfKCombSets
    eng_a, eng_b = SearchEngine(art_a), SearchEngine(art_b)
    queries = [art_a.sequence(i) for i in (0, 5, 77, 123, 299)]
    sizes = [len(q) - 6 for q in queries]
    res_a = eng_a.count_batch(queries, sizes, k=10, positions=True)
    res_b = eng_b.count_batch(queries, sizes, k=10, positions=True)
    for qa, qb in zip(res_a, res_b):
        np.testing.assert_array_equal(qa.hit_rows, qb.hit_rows)
        np.testing.assert_array_equal(qa.counts, qb.counts)
        rows = [int(r) for r in qa.hit_rows]
        assert eng_a.position_bitmaps(qa, rows) == eng_b.position_bitmaps(qb, rows)


def test_build_rss_stays_bounded(tmp_path):
    """The collect+spill+merge phase must hold peak RSS far below the pair
    volume (the monitor the VERDICT asks for): ~80 MB of pairs built under
    an 8 MB spill budget must not add more than ~100 MB over the import
    baseline, where an in-RAM build needs >= 2x the pair volume."""
    rng = np.random.default_rng(31)
    fasta = str(tmp_path / "big.fasta")
    _write_fasta(fasta, 40_000, rng, lo=200, hi=310)

    probe = (
        "import sys, resource, json;"
        "sys.path.insert(0, %r);"
        "import numpy as np;"
        "from kaamer_jax.index.build import build_db;"
        "base = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss;"
        "build_db(%r, %r, 'fasta', no_index=True);"
        "peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss;"
        "print(json.dumps({'base_kb': base, 'peak_kb': peak}))"
    ) % (os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
         str(tmp_path / "db"), fasta)
    env = dict(os.environ, KAAMER_BUILD_SPILL_BYTES=str(8 << 20))
    out = subprocess.run([sys.executable, "-c", probe], env=env,
                         capture_output=True, text=True, check=True)
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    delta_mb = (rec["peak_kb"] - rec["base_kb"]) / 1024
    pairs = np.load(str(tmp_path / "db" / "pairs.npy"), mmap_mode="r")
    pair_mb = pairs.nbytes / 1e6
    assert pair_mb > 60, pair_mb          # the workload is actually big
    assert delta_mb < 110, (delta_mb, pair_mb)  # and the build stayed bounded
