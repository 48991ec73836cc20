"""Sharded multi-device search must reproduce single-chip results exactly
(every posting lives on exactly one shard; all_to_all merge is lossless)."""

import numpy as np
import pytest

from kaamer_jax.index.build import build_db
from kaamer_jax.index.artifact import load_db
from kaamer_jax.search.engine import SearchEngine
from kaamer_jax.parallel.mesh import (
    make_sharded_search,
    replicate_query_batch,
    shard_index,
)

AA = "ACDEFGHIKLMNPQRSTUVWY"


@pytest.fixture(scope="module")
def db_and_queries(tmp_path_factory):
    rng = np.random.default_rng(11)
    tmp = tmp_path_factory.mktemp("pardb")
    fasta = tmp / "in.fasta"
    seqs = []
    with open(fasta, "w") as f:
        for i in range(80):
            L = int(rng.integers(40, 150))
            s = "".join(rng.choice(list(AA), size=L))
            seqs.append(s)
            f.write(f">p{i}\n{s}\n")
    dbdir = str(tmp / "db")
    build_db(dbdir, str(fasta), "fasta")
    art = load_db(dbdir)

    queries = [seqs[i][: 40 + i % 50] for i in range(0, 80, 5)]
    queries = [q for q in queries if len(q) >= 13][:8]
    return art, queries


def test_sharded_matches_single_chip(db_and_queries):
    import jax
    from jax.sharding import Mesh

    art, queries = db_and_queries
    devices = np.array(jax.devices()[:8]).reshape(2, 4)
    mesh = Mesh(devices, axis_names=("dp", "shard"))

    sizes = [len(q) - 6 for q in queries]
    engine = SearchEngine(art)
    single = engine.count_batch(queries, sizes, k=16)

    sharded = shard_index(art, n_shards=4)
    codes, n_kmers = replicate_query_batch(queries, sizes, batch_mult=8)
    cap = 1 << 14
    fn = make_sharded_search(mesh, sharded.hash_log2, cap=cap, k=32)
    counts, hit_rows, totals = fn(
        sharded.tables, sharded.postings, codes, n_kmers
    )
    counts = np.asarray(counts)
    hit_rows = np.asarray(hit_rows)
    assert int(np.asarray(totals).max()) <= cap

    for i, qc in enumerate(single):
        got = [
            (int(r), int(c)) for r, c in zip(hit_rows[i], counts[i]) if c > 0
        ]
        want = [(int(r), int(c)) for r, c in zip(qc.hit_rows, qc.counts)]
        assert got[: len(want)] == want, f"query {i}"


def test_shard_owner_partitions_kmers(db_and_queries):
    from kaamer_jax.index.hashtable import occupied_entries
    from kaamer_jax.parallel.mesh import shard_owner

    art, _ = db_and_queries
    kmers, _, _ = occupied_entries(np.asarray(art.hash_table))
    owners = shard_owner(kmers, 4)
    assert owners.min() >= 0 and owners.max() < 4
    # every k-mer deterministically owned by exactly one shard, and the
    # distribution is roughly balanced
    counts = np.bincount(owners, minlength=4)
    assert counts.sum() == kmers.size
    assert counts.min() > 0.1 * kmers.size / 4
