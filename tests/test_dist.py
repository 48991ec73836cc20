"""Full search pipeline over the sharded multi-device engine must produce
byte-identical output to the single-chip engine."""

import numpy as np
import pytest

from kaamer_jax.index.build import build_db
from kaamer_jax.index.artifact import load_db
from kaamer_jax.parallel.dist import ShardedSearchEngine, global_mesh
from kaamer_jax.search.engine import SearchEngine
from kaamer_jax.search.options import PROTEIN, SearchOptions
from kaamer_jax.search.pipeline import run_search

AA = "ACDEFGHIKLMNPQRSTVWY"


@pytest.fixture(scope="module")
def db(tmp_path_factory):
    rng = np.random.default_rng(17)
    tmp = tmp_path_factory.mktemp("distdb")
    fasta = tmp / "in.fasta"
    seqs = []
    with open(fasta, "w") as f:
        for i in range(50):
            L = int(rng.integers(50, 140))
            s = "".join(rng.choice(list(AA), size=L))
            seqs.append(s)
            f.write(f">D{i} dist test {i}\n{s}\n")
    dbdir = str(tmp / "db")
    build_db(dbdir, str(fasta), "fasta")
    return load_db(dbdir), seqs, tmp


def test_global_mesh_shape():
    mesh = global_mesh()
    assert set(mesh.axis_names) == {"dp", "shard"}
    assert mesh.size == 8  # conftest forces 8 virtual devices


def test_sharded_pipeline_matches_single(db, tmp_path):
    art, seqs, _ = db
    qf = tmp_path / "q.fasta"
    with open(qf, "w") as f:
        for i in (0, 7, 23, 41):
            f.write(f">q{i}\n{seqs[i]}\n")
        f.write(">mut\n" + seqs[3][:40] + "A" + seqs[3][41:] + "\n")

    opts = SearchOptions(File=str(qf), SequenceType=PROTEIN, OutFormat="tsv",
                         ExtractPositions=True, Annotations=True, MaxResults=3)

    single = b"".join(run_search(SearchEngine(art), opts))
    sharded_engine = ShardedSearchEngine(art, mesh=global_mesh(4))
    sharded = b"".join(run_search(sharded_engine, opts))
    assert single == sharded


def test_sharded_overflow_host_fallback(db, tmp_path):
    """Queries whose shard-local postings volume exceeds CAP_MAX must route
    through the exact host bincount and still match the single-chip engine."""
    art, seqs, _ = db
    queries = [seqs[2], seqs[9][:60], seqs[30]]
    sizes = [len(q) - 6 for q in queries]

    single = SearchEngine(art)
    want = single.count_batch(queries, sizes, k=8)

    eng = ShardedSearchEngine(art, mesh=global_mesh(4))
    # instance overrides: dispatch at cap 2 and make any overflow exceed
    # CAP_MAX, forcing every query through the host bincount
    eng.CAP_MAX = 2
    eng.CAP_MIN = 2
    eng._cap_hint = 2
    got = eng.count_batch(queries, sizes, k=8)

    for qw, qg in zip(want, got):
        assert np.array_equal(qw.hit_rows[:8], qg.hit_rows[:8])
        assert np.array_equal(qw.counts[:8], qg.counts[:8])


def test_sharded_device_rerun_matches_single(db):
    """Queries overflowing the dispatch cap but under CAP_MAX re-run in
    bounded sub-batches on device and must match the single-chip engine."""
    art, seqs, _ = db
    queries = [seqs[2], seqs[9][:60], seqs[30], seqs[44]]
    sizes = [len(q) - 6 for q in queries]

    want = SearchEngine(art).count_batch(queries, sizes, k=8)
    eng = ShardedSearchEngine(art, mesh=global_mesh(4))
    eng.CAP_MIN = 2
    eng._cap_hint = 2  # dispatch at cap 2; totals overflow -> device re-run
    got = eng.count_batch(queries, sizes, k=8)
    for qw, qg in zip(want, got):
        assert np.array_equal(qw.hit_rows[:8], qg.hit_rows[:8])
        assert np.array_equal(qw.counts[:8], qg.counts[:8])


def test_sharded_device_position_bitmaps_match_single(db):
    """positions=True on the sharded engine computes bitmaps on device from
    the all-to-all-merged expansion; they must equal the single-chip ones."""
    art, seqs, _ = db
    queries = [seqs[5], seqs[11][:50], seqs[20]]
    sizes = [len(q) - 6 for q in queries]

    single = SearchEngine(art)
    want_qc = single.count_batch(queries, sizes, k=8, positions=True)
    eng = ShardedSearchEngine(art, mesh=global_mesh(4))
    got_qc = eng.count_batch(queries, sizes, k=8, positions=True)

    for qw, qg in zip(want_qc, got_qc):
        assert qg._bitmaps is not None, "sharded device bitmaps missing"
        rows = [int(r) for r in qw.hit_rows]
        assert eng.position_bitmaps(qg, rows) == single.position_bitmaps(qw, rows)


def test_sharded_fastq_pipeline_matches_single(db, tmp_path):
    """Full fastq (translated reads) pipeline through the sharded engine is
    byte-identical to single-chip serving."""
    from kaamer_jax.search.options import READS

    art, seqs, _ = db
    c = {"A":"gct","C":"tgt","D":"gat","E":"gaa","F":"ttt","G":"ggt","H":"cat",
         "I":"att","K":"aaa","L":"ctt","M":"atg","N":"aat","P":"cct","Q":"caa",
         "R":"cgt","S":"tct","T":"act","V":"gtt","W":"tgg","Y":"tat"}
    fq = tmp_path / "reads.fq"
    rng = np.random.default_rng(8)
    with open(fq, "w") as f:
        for i in range(12):
            src = seqs[int(rng.integers(0, len(seqs)))]
            frag = src[: min(40, len(src))]
            dna = "taa" + "".join(c.get(a, "gct") for a in frag) + "taa"
            f.write(f"@r{i}\n{dna}\n+\n{'I' * len(dna)}\n")

    opts = SearchOptions(File=str(fq), SequenceType=READS, OutFormat="tsv",
                         ExtractPositions=True, MaxResults=3)
    single = b"".join(run_search(SearchEngine(art), opts))
    sharded = b"".join(run_search(
        ShardedSearchEngine(art, mesh=global_mesh(4)), opts))
    assert single == sharded
    assert single.count(b"\n") >= 8  # header + most reads hit


@pytest.fixture(scope="module")
def skew_db(tmp_path_factory):
    """Domain-skewed DB (hot sets + heavy runs): the regime the single-chip
    engine's skew machinery exists for, now required on the sharded engine
    too (VERDICT r2 ask #2)."""
    rng = np.random.default_rng(23)
    domains = ["".join(rng.choice(list(AA), size=int(rng.integers(25, 60))))
               for _ in range(6)]
    seqs = []
    with_dom = []
    for i in range(80):
        parts = []
        for d, dom in enumerate(domains):
            if rng.random() < 1.0 / (d + 2):
                parts.append(dom)
        parts.append("".join(rng.choice(list(AA), size=int(rng.integers(20, 60)))))
        rng.shuffle(parts)
        seqs.append("".join(parts))
    tmp = tmp_path_factory.mktemp("distskew")
    fasta = tmp / "in.fasta"
    with open(fasta, "w") as f:
        for i, s in enumerate(seqs):
            f.write(f">K{i} skew {i}\n{s}\n")
    dbdir = str(tmp / "db")
    build_db(dbdir, str(fasta), "fasta")
    return load_db(dbdir), seqs, domains


def test_sharded_skewed_pipeline_byte_identical(skew_db, tmp_path):
    """Full pipeline (positions on) over a skewed DB: the sharded engine --
    hot dense path, grouped phase 2, run-dedup positions -- must be
    byte-identical to the single-chip engine."""
    art, seqs, domains = skew_db
    qf = tmp_path / "q.fasta"
    with open(qf, "w") as f:
        for i in (0, 9, 33, 61):
            f.write(f">q{i}\n{seqs[i]}\n")
        f.write(">hot\n" + domains[0] + domains[1] + "\n")
        f.write(">mut\n" + seqs[5][:30] + "W" + seqs[5][31:] + "\n")

    opts = SearchOptions(File=str(qf), SequenceType=PROTEIN, OutFormat="tsv",
                         ExtractPositions=True, Annotations=True,
                         MaxResults=5)
    single = b"".join(run_search(SearchEngine(art), opts))
    eng = ShardedSearchEngine(art, mesh=global_mesh(4))
    assert eng.hot_starts is not None  # the dense path is actually on
    sharded = b"".join(run_search(eng, opts))
    assert single == sharded


def test_sharded_hot_groups_dispatched(skew_db):
    """Hot queries on the sharded engine route through the dense-matmul
    group kernel (not just fall back to cold expansion)."""
    art, seqs, domains = skew_db
    eng = ShardedSearchEngine(art, mesh=global_mesh(4))
    assert eng.hot_starts is not None
    queries = [domains[0] + domains[1], seqs[2], seqs[40][:40]]
    sizes = [len(q) - 6 for q in queries]

    seen = []
    orig = eng._group_fn

    def spy(cap, k, width, positions, hot):
        seen.append(hot)
        return orig(cap, k, width, positions, hot)

    eng._group_fn = spy
    got = eng.count_batch(queries, sizes, k=8)
    eng._group_fn = orig
    assert any(seen), "no hot group dispatched"

    want = SearchEngine(art).count_batch(queries, sizes, k=8)
    for qw, qg in zip(want, got):
        assert [int(r) for r in qw.hit_rows] == [int(r) for r in qg.hit_rows]
        assert [int(c) for c in qw.counts] == [int(c) for c in qg.counts]


def test_sharded_expansion_volume_matches_single_chip(skew_db):
    """Set-identity sharding preserves the query-time run-dedup structure:
    the SUM of shard-local deduplicated cold volumes equals the single-chip
    deduplicated volume per query exactly (VERDICT r2 ask #2's virtual-mesh
    check).  K-mer-identity sharding would fragment every run and inflate
    this by ~the mean run length."""
    art, seqs, domains = skew_db
    queries = [seqs[0], domains[0] * 2, seqs[7][:60], seqs[11]]
    sizes = [len(q) - 6 for q in queries]

    single = SearchEngine(art, hot=False)
    h = single.dispatch_batch(queries, sizes, k=8)
    # exact deduplicated cold ELEMENT volume: the single-chip phase 1 now
    # splits it into short elements (outs1[7]) + long-run true lengths
    # (outs1[6], nonzero at long run starts)
    single_totals = (np.asarray(h[0][7])
                     + np.asarray(h[0][6]).sum(axis=1))[: len(queries)]
    single.resolve_batch(h)

    eng = ShardedSearchEngine(art, mesh=global_mesh(4), hot=False)
    hs = eng.dispatch_batch(queries, sizes, k=8)
    tsum = np.asarray(hs[0][1])[: len(queries)]
    eng.resolve_batch(hs)

    assert np.array_equal(tsum, single_totals)


def test_sharded_warmup_does_not_touch_cap_hint(db):
    art, seqs, _ = db
    eng = ShardedSearchEngine(art, mesh=global_mesh(4))
    eng._cap_hint = 320
    eng.warmup(batch_sizes=(8,), lengths=(16,), positions=(False,))
    assert eng._cap_hint == 320


@pytest.fixture(scope="module")
def built_shards(tmp_path_factory):
    """One fasta built twice: global artifact and a 4-shard build-time
    sharded index (index_db n_shards=4 -- the only layout past
    build.MAX_POSTINGS, VERDICT r2 ask #3)."""
    rng = np.random.default_rng(31)
    domains = ["".join(rng.choice(list(AA), size=int(rng.integers(25, 50))))
               for _ in range(5)]
    seqs = []
    tmp = tmp_path_factory.mktemp("shardbuilt")
    fasta = tmp / "in.fasta"
    with open(fasta, "w") as f:
        for i in range(60):
            parts = [d for j, d in enumerate(domains)
                     if rng.random() < 1.0 / (j + 2)]
            parts.append("".join(rng.choice(list(AA),
                                            size=int(rng.integers(30, 70)))))
            rng.shuffle(parts)
            s = "".join(parts)
            seqs.append(s)
            f.write(f">S{i} sharded build {i}\n{s}\n")
    gdir, sdir = str(tmp / "gdb"), str(tmp / "sdb")
    build_db(gdir, str(fasta), "fasta")
    build_db(sdir, str(fasta), "fasta", n_shards=4)
    return load_db(gdir), load_db(sdir), seqs, domains


def test_shard_built_layout_matches_shard_index(built_shards):
    """Build-time set routing (shard_owner over global set ids) must place
    exactly the postings that load-time shard_index() would: per-shard
    postings and local set offsets are bit-equal."""
    from kaamer_jax.parallel.mesh import shard_index

    g, s, _, _ = built_shards
    assert s.index_shards == 4
    assert s.hash_table is None and s.postings is None  # no global arrays
    ref = shard_index(g, 4)
    for i in range(4):
        assert np.array_equal(ref.postings[i, : ref.postings_sizes[i]],
                              np.asarray(s.shard_postings[i]))
        assert np.array_equal(np.asarray(ref.set_offsets[i]),
                              np.asarray(s.shard_set_offsets[i]))


def test_shard_built_pipeline_byte_identical(built_shards, tmp_path):
    """Serving a shard-BUILT artifact (no global arrays anywhere) must be
    byte-identical to the single-chip engine over the global build,
    including hot-path queries and position extraction."""
    g, s, seqs, domains = built_shards
    qf = tmp_path / "q.fasta"
    with open(qf, "w") as f:
        for i in (0, 9, 33):
            f.write(f">q{i}\n{seqs[i]}\n")
        f.write(">hot\n" + domains[0] + domains[1] + "\n")
        f.write(">mut\n" + seqs[5][:30] + "W" + seqs[5][31:] + "\n")
    opts = SearchOptions(File=str(qf), SequenceType=PROTEIN, OutFormat="tsv",
                         ExtractPositions=True, Annotations=True,
                         MaxResults=5)
    single = b"".join(run_search(SearchEngine(g), opts))
    sharded = b"".join(run_search(
        ShardedSearchEngine(s, mesh=global_mesh(4)), opts))
    assert single == sharded


def test_shard_built_host_fallback_and_bitmaps(built_shards):
    """The host bincount fallback and host position bitmaps run over the
    virtual postings concatenation (_ConcatPostings) for shard-built
    artifacts; both must match the single-chip engine."""
    g, s, seqs, domains = built_shards
    queries = [seqs[2], domains[0] + domains[1], seqs[30][:60]]
    sizes = [len(q) - 6 for q in queries]
    want = SearchEngine(g).count_batch(queries, sizes, k=8)

    eng = ShardedSearchEngine(s, mesh=global_mesh(4))
    eng.CAP_MAX = 2
    eng.CAP_MIN = 2
    eng._cap_hint = 2  # force every query through the host bincount
    got = eng.count_batch(queries, sizes, k=8)
    single = SearchEngine(g)
    for qw, qg in zip(want, got):
        assert np.array_equal(qw.hit_rows[:8], qg.hit_rows[:8])
        assert np.array_equal(qw.counts[:8], qg.counts[:8])
        rows = [int(r) for r in qw.hit_rows[:4]]
        assert eng.position_bitmaps(qg, rows) == \
            single.position_bitmaps(qw, rows)


def test_shard_built_engine_guards(built_shards):
    g, s, _, _ = built_shards
    with pytest.raises(ValueError, match="index shards"):
        SearchEngine(s)
    with pytest.raises(ValueError, match="must match"):
        ShardedSearchEngine(s, mesh=global_mesh(2))


def test_postings_cap_forces_sharded_build(built_shards, tmp_path,
                                           monkeypatch):
    """Crossing MAX_POSTINGS: the unsharded index raises the clear error;
    the same data indexes fine sharded (each shard under the cap) and
    serves (the mechanism behind >2^31-postings databases, scaled down)."""
    from kaamer_jax.index import build as build_mod

    g, _, seqs, _ = built_shards
    total = int(np.asarray(g.set_offsets)[-1])
    fasta = tmp_path / "in.fasta"
    with open(fasta, "w") as f:
        for i, s in enumerate(seqs):
            f.write(f">S{i} sharded build {i}\n{s}\n")

    d1 = str(tmp_path / "db1")
    build_db(d1, str(fasta), "fasta", no_index=True)
    monkeypatch.setattr(build_mod, "MAX_POSTINGS", total // 2)
    with pytest.raises(ValueError, match="sharded index"):
        build_mod.index_db(d1)

    d2 = str(tmp_path / "db2")
    build_db(d2, str(fasta), "fasta", no_index=True)
    build_mod.index_db(d2, n_shards=4)  # each shard ~total/4 < total/2
    art = load_db(d2)
    assert art.index_shards == 4
    queries = [seqs[0], seqs[13][:60]]
    sizes = [len(q) - 6 for q in queries]
    want = SearchEngine(g).count_batch(queries, sizes, k=8)
    got = ShardedSearchEngine(art, mesh=global_mesh(4)).count_batch(
        queries, sizes, k=8)
    for qw, qg in zip(want, got):
        assert np.array_equal(qw.hit_rows, qg.hit_rows)
        assert np.array_equal(qw.counts, qg.counts)


def test_encode_kmers_batch_matches_scalar():
    from kaamer_jax import codec

    rng = np.random.default_rng(3)
    codes = rng.integers(-1, codec.N_AA, size=(5, 30)).astype(np.int32)
    batch = codec.encode_kmers_batch(codes)
    for i in range(codes.shape[0]):
        assert np.array_equal(batch[i], codec.encode_kmers(codes[i]))


def test_split_sets_balance_cold_expansion(tmp_path):
    """Long postings sets split contiguously across all shards
    (mesh.split_set_mask): per-query cold expansion balance tsum/(n*tmax)
    must clear 0.5 at 8 shards on a skewed database (whole-set ownership
    measured 0.19 there, SCALING_r03 -> SCALING_r04), while the per-query
    SUM stays equal to the single-chip deduplicated volume.  4000 proteins:
    the balance claim is scale-dependent (smaller DBs have fewer
    split-eligible sets; 800 proteins measures ~0.35)."""
    import bench

    path = str(tmp_path / "baldb")
    bench.build_skewed_db(path, 4000)
    art = load_db(path)
    rng = np.random.default_rng(5)
    queries = [art.sequence(int(r))[:256]
               for r in rng.integers(0, art.num_proteins, size=64)]
    sizes = [len(q) - 6 for q in queries]

    single = SearchEngine(art, hot=False)
    h = single.dispatch_batch(queries, sizes, k=8)
    # exact cold ELEMENT volume = short elements + long-run true lengths
    single_totals = (np.asarray(h[0][7])
                     + np.asarray(h[0][6]).sum(axis=1))[:64].astype(np.int64)
    single.resolve_batch(h)

    eng = ShardedSearchEngine(art, mesh=global_mesh(8), hot=False)
    hs = eng.dispatch_batch(queries, sizes, k=8)
    tmax = np.asarray(hs[0][0])[:64].astype(np.int64)
    tsum = np.asarray(hs[0][1])[:64].astype(np.int64)
    eng.resolve_batch(hs)

    assert np.array_equal(tsum, single_totals)
    nz = single_totals > 0
    balance = (tsum[nz] / (8 * np.maximum(tmax[nz], 1))).mean()
    assert balance >= 0.5, f"8-shard cold expansion balance {balance:.3f}"


def test_shard_built_split_set_host_paths_match_single(tmp_path):
    """Regression (r4 review): on a shard-BUILT artifact a split set's
    k-mer hits on EVERY shard; the host-side probe must aggregate the
    per-shard sub-slices (sum counts, OR bitmaps), not keep the last
    shard's.  Exercises both the exact host-bincount fallback and host
    position bitmaps against the single-chip engine."""
    rng = np.random.default_rng(41)
    dom = "".join(rng.choice(list(AA), size=45))  # shared by most proteins
    seqs = []
    fasta = tmp_path / "in.fasta"
    with open(fasta, "w") as f:
        for i in range(70):
            s = dom + "".join(rng.choice(list(AA),
                                         size=int(rng.integers(20, 50))))
            seqs.append(s)
            f.write(f">B{i} split {i}\n{s}\n")
    gdir, sdir = str(tmp_path / "g"), str(tmp_path / "s")
    build_db(gdir, str(fasta), "fasta")
    build_db(sdir, str(fasta), "fasta", n_shards=4)
    g, s = load_db(gdir), load_db(sdir)
    # the shared-domain set really is split: every shard carries a piece
    import numpy as _np
    lens0 = [_np.diff(_np.asarray(o).astype(_np.int64))
             for o in s.shard_set_offsets]
    assert all((l >= 8).any() for l in lens0)

    queries = [dom + seqs[3][45:60], seqs[10], seqs[33][:52]]
    sizes = [len(q) - 6 for q in queries]
    single = SearchEngine(g)
    want = single.count_batch(queries, sizes, k=8)

    eng = ShardedSearchEngine(s, mesh=global_mesh(4))
    eng.CAP_MAX = 2
    eng.CAP_MIN = 2
    eng._cap_hint = 2  # force every query through the host bincount
    got = eng.count_batch(queries, sizes, k=8)
    for qw, qg in zip(want, got):
        assert np.array_equal(qw.hit_rows[:8], qg.hit_rows[:8])
        assert np.array_equal(qw.counts[:8], qg.counts[:8])
        rows = [int(r) for r in qw.hit_rows[:4]]
        assert eng.position_bitmaps(qg, rows) == \
            single.position_bitmaps(qw, rows)
