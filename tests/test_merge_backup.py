"""Split-build -> merge -> index equals single build; backup/restore roundtrip."""

import os

import numpy as np
import pytest

from kaamer_jax.index.artifact import load_db
from kaamer_jax.index.backup import backup_db, gc_db, restore_db
from kaamer_jax.index.build import build_db, index_db
from kaamer_jax.index.merge import merge_dbs
from kaamer_jax.search.engine import SearchEngine

AA = "ACDEFGHIKLMNPQRSTVWY"


def _write_fasta(path, seqs, start=0):
    with open(path, "w") as f:
        for i, s in enumerate(seqs):
            f.write(f">P{start + i}\n{s}\n")


@pytest.fixture(scope="module")
def split_and_whole(tmp_path_factory):
    rng = np.random.default_rng(21)
    seqs = ["".join(rng.choice(list(AA), size=int(rng.integers(40, 120))))
            for _ in range(40)]
    tmp = tmp_path_factory.mktemp("merge")

    whole_fa = tmp / "whole.fasta"
    _write_fasta(whole_fa, seqs)
    whole_db = str(tmp / "whole_db")
    build_db(whole_db, str(whole_fa), "fasta")

    # split build: two halves of the same file via -offset/-length -noindex
    parts = tmp / "parts"
    parts.mkdir()
    build_db(str(parts / "a"), str(whole_fa), "fasta", offset=0, length=20,
             no_index=True)
    build_db(str(parts / "b"), str(whole_fa), "fasta", offset=20, length=100,
             no_index=True)

    merged_db = str(tmp / "merged_db")
    merge_dbs(str(parts), merged_db)
    index_db(merged_db)
    return whole_db, merged_db, seqs, tmp


def test_merge_equals_whole(split_and_whole):
    whole_db, merged_db, seqs, _ = split_and_whole
    whole = load_db(whole_db)
    merged = load_db(merged_db)

    assert merged.stats.NumberOfProteins == whole.stats.NumberOfProteins
    assert merged.stats.NumberOfAA == whole.stats.NumberOfAA
    assert merged.stats.NumberOfKmers == whole.stats.NumberOfKmers
    assert merged.stats.NumberOfKCombSets == whole.stats.NumberOfKCombSets

    e_whole = SearchEngine(whole)
    e_merged = SearchEngine(merged)
    queries = [seqs[3], seqs[25], seqs[39][:50]]
    sizes = [len(q) - 6 for q in queries]
    r1 = e_whole.count_batch(queries, sizes, k=10)
    r2 = e_merged.count_batch(queries, sizes, k=10)
    for a, b in zip(r1, r2):
        ia = [int(whole.protein_ids[r]) for r in a.hit_rows]
        ib = [int(merged.protein_ids[r]) for r in b.hit_rows]
        assert ia == ib
        assert a.counts.tolist() == b.counts.tolist()


def test_merge_rejects_indexed(split_and_whole, tmp_path):
    whole_db, _, _, tmp = split_and_whole
    bad = tmp_path / "bad"
    bad.mkdir()
    os.symlink(whole_db, bad / "whole")
    with pytest.raises(ValueError, match="indexed"):
        merge_dbs(str(bad), str(tmp_path / "out"))


def test_backup_restore_roundtrip(split_and_whole, tmp_path):
    whole_db, _, seqs, _ = split_and_whole
    bkp = str(tmp_path / "bkp")
    rst = str(tmp_path / "rst")
    backup_db(whole_db, bkp)
    restore_db(bkp, rst)

    a = load_db(whole_db)
    b = load_db(rst)
    np.testing.assert_array_equal(np.asarray(a.hash_table), np.asarray(b.hash_table))
    np.testing.assert_array_equal(np.asarray(a.postings), np.asarray(b.postings))
    assert a.stats == b.stats
    assert gc_db(rst) == 0


def test_backup_restore_shard_built(tmp_path):
    """Shard-built artifacts keep their index under <db>/shardNN/; backup
    and restore must carry the subdirectories (a file-only copy silently
    dropped the entire index)."""
    import numpy as np

    from kaamer_jax.index.backup import backup_db, restore_db
    from kaamer_jax.index.build import build_db
    from kaamer_jax.index.artifact import load_db

    rng = np.random.default_rng(4)
    AA = list("ACDEFGHIKLMNPQRSTVWY")
    fasta = tmp_path / "in.fasta"
    with open(fasta, "w") as f:
        for i in range(40):
            s = "".join(rng.choice(AA, size=int(rng.integers(40, 90))))
            f.write(f">B{i} x\n{s}\n")
    dbdir = str(tmp_path / "db")
    build_db(dbdir, str(fasta), "fasta", n_shards=4)

    bdir = str(tmp_path / "bak")
    rdir = str(tmp_path / "restored")
    backup_db(dbdir, bdir)
    restore_db(bdir, rdir)
    art = load_db(rdir)
    assert art.index_shards == 4
    src = load_db(dbdir)
    for s in range(4):
        assert np.array_equal(np.asarray(src.shard_postings[s]),
                              np.asarray(art.shard_postings[s]))
        assert np.array_equal(np.asarray(src.shard_tables[s]),
                              np.asarray(art.shard_tables[s]))
