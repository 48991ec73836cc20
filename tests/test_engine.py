import os

import numpy as np
import pytest

from kaamer_jax.index.build import build_db
from kaamer_jax.index.artifact import load_db
from kaamer_jax.search.engine import SearchEngine
from oracle import OracleDB

AA = "ACDEFGHIKLMNPQRSTUVWY"


def _random_proteins(rng, n, min_len=30, max_len=120):
    seqs = []
    for _ in range(n):
        L = int(rng.integers(min_len, max_len))
        seqs.append("".join(rng.choice(list(AA), size=L)))
    return seqs


def _write_fasta(path, seqs):
    with open(path, "w") as f:
        for i, s in enumerate(seqs):
            f.write(f">prot{i} synthetic protein {i}\n")
            for j in range(0, len(s), 60):
                f.write(s[j : j + 60] + "\n")


@pytest.fixture(scope="module")
def synth_db(tmp_path_factory):
    rng = np.random.default_rng(42)
    seqs = _random_proteins(rng, 60)
    # add some shared segments so k-mer sets overlap
    shared = "".join(rng.choice(list(AA), size=40))
    seqs[10] = seqs[10][:20] + shared + seqs[10][20:]
    seqs[11] = seqs[11][:5] + shared + seqs[11][5:]
    seqs[12] = shared + shared

    tmp = tmp_path_factory.mktemp("db")
    fasta = str(tmp / "in.fasta")
    dbdir = str(tmp / "db")
    _write_fasta(fasta, seqs)
    build_db(dbdir, fasta, "fasta")

    art = load_db(dbdir)
    from kaamer_jax.records import Protein

    entries = [
        (int(art.protein_ids[i]), art.protein(i)) for i in range(art.num_proteins)
    ]
    oracle = OracleDB(entries)
    return art, oracle, seqs


def test_engine_matches_oracle_exact_queries(synth_db):
    art, oracle, seqs = synth_db
    engine = SearchEngine(art)

    queries = [seqs[0], seqs[10], seqs[11], seqs[12], seqs[30][:50]]
    sizes = [len(s) - 6 for s in queries]
    res = engine.count_batch(queries, sizes, k=10)

    ext = np.asarray(art.protein_ids)
    for q, size, qc in zip(queries, sizes, res):
        got = [(int(ext[int(r)]), int(c)) for r, c in zip(qc.hit_rows, qc.counts)]
        want, _ = oracle.kmer_search(q, size)
        assert got[: len(want[:32])] == want[:32], f"query {q[:20]}..."


def test_engine_matches_oracle_random_queries(synth_db):
    art, oracle, seqs = synth_db
    engine = SearchEngine(art)
    rng = np.random.default_rng(7)

    queries = []
    for _ in range(40):
        base = seqs[int(rng.integers(0, len(seqs)))]
        lo = int(rng.integers(0, max(1, len(base) - 20)))
        hi = min(len(base), lo + int(rng.integers(10, 80)))
        q = list(base[lo:hi])
        # random mutations
        for _ in range(int(rng.integers(0, 5))):
            p = int(rng.integers(0, len(q)))
            q[p] = AA[int(rng.integers(0, len(AA)))]
        qs = "".join(q)
        if len(qs) >= 7:
            queries.append(qs)

    sizes = [len(s) - 6 for s in queries]
    res = engine.count_batch(queries, sizes, k=20)
    ext = np.asarray(art.protein_ids)
    for q, size, qc in zip(queries, sizes, res):
        got = [(int(ext[int(r)]), int(c)) for r, c in zip(qc.hit_rows, qc.counts)]
        want, _ = oracle.kmer_search(q, size)
        assert got == want[: len(got)], f"query {q}"


def test_position_bitmaps_match_oracle(synth_db):
    art, oracle, seqs = synth_db
    engine = SearchEngine(art)

    q = seqs[11]
    size = len(q) - 6
    (qc,) = engine.count_batch([q], [size], k=10)
    ext = np.asarray(art.protein_ids)

    want, want_pos = oracle.kmer_search(q, size)
    rows = [int(r) for r in qc.hit_rows[:5]]
    bitmaps = engine.position_bitmaps(qc, rows)
    for r in rows:
        pid = int(ext[r])
        assert bitmaps[r] == want_pos[pid], f"hit {pid}"


def test_device_position_bitmaps_match_host(synth_db):
    """positions=True computes bitmaps on device (member_bitmap + pack_bits);
    they must equal the host binary-search path bit for bit."""
    art, oracle, seqs = synth_db
    engine = SearchEngine(art)
    rng = np.random.default_rng(3)

    queries = [seqs[10], seqs[11], seqs[12], seqs[0][:40], seqs[5]]
    # a mutated query exercises miss lanes
    q = list(seqs[20])
    for _ in range(6):
        q[int(rng.integers(0, len(q)))] = AA[int(rng.integers(0, len(AA)))]
    queries.append("".join(q))
    sizes = [len(s) - 6 for s in queries]

    res_dev = engine.count_batch(queries, sizes, k=10, positions=True)
    res_host = engine.count_batch(queries, sizes, k=10, positions=False)
    for qc_d, qc_h in zip(res_dev, res_host):
        assert qc_d._bitmaps is not None
        rows = [int(r) for r in qc_h.hit_rows]
        want = engine.position_bitmaps(qc_h, rows)
        got = engine.position_bitmaps(qc_d, rows)
        assert got == want


def test_member_bitmap_binary_search_matches_host():
    """ops.count.member_bitmap (the large-cap binary-search path) against
    the host member_np on random CSR slices."""
    import jax.numpy as jnp
    from kaamer_jax.ops.count import member_bitmap, member_np

    rng = np.random.default_rng(17)
    n_sets, B, K, L = 50, 6, 8, 16
    lens_sets = rng.integers(0, 9, size=n_sets)
    postings = np.sort(rng.integers(0, 200, size=int(lens_sets.sum()))
                       .astype(np.uint32))
    # carve per-set sorted slices out of the sorted pool
    starts = np.zeros(n_sets + 1, dtype=np.int64)
    np.cumsum(lens_sets, out=starts[1:])
    ids = rng.integers(0, n_sets, size=(B, L))
    offs = starts[ids].astype(np.int32)
    lens = (starts[ids + 1] - starts[ids]).astype(np.int32)
    hits = rng.integers(0, 200, size=(B, K)).astype(np.uint32)
    # make some guaranteed members
    for b in range(B):
        l = int(rng.integers(0, L))
        if lens[b, l] > 0:
            hits[b, 0] = postings[offs[b, l]]

    iters = int(np.ceil(np.log2(int(lens_sets.max()) + 1))) + 1
    got = np.asarray(member_bitmap(jnp.asarray(postings), jnp.asarray(offs),
                                   jnp.asarray(lens), jnp.asarray(hits), iters))
    for b in range(B):
        want = member_np(postings, offs[b].astype(np.int64),
                         lens[b].astype(np.int64), hits[b])
        assert np.array_equal(got[b], want), b


def test_queries_with_invalid_residues(synth_db):
    art, oracle, seqs = synth_db
    engine = SearchEngine(art)
    q = seqs[0][:30] + "XXB" + seqs[0][30:60]
    size = len(q) - 6
    (qc,) = engine.count_batch([q], [size], k=10)
    ext = np.asarray(art.protein_ids)
    got = [(int(ext[int(r)]), int(c)) for r, c in zip(qc.hit_rows, qc.counts)]
    want, _ = oracle.kmer_search(q, size)
    assert got == want[: len(got)]


@pytest.fixture(scope="module")
def heavy_db(tmp_path_factory):
    """DB with a hot shared segment: ~400 proteins share a 26-mer, so each
    of its 20 7-mers has ~400 postings and any query containing the segment
    overflows the CAP_MIN=256 expansion bucket (total ~8000)."""
    rng = np.random.default_rng(99)
    shared = "".join(rng.choice(list(AA), size=26))
    seqs = []
    for i in range(400):
        pre = "".join(rng.choice(list(AA), size=int(rng.integers(10, 30))))
        post = "".join(rng.choice(list(AA), size=int(rng.integers(10, 30))))
        seqs.append(pre + shared + post)
    for i in range(50):  # plus background proteins with no shared segment
        seqs.append("".join(rng.choice(list(AA), size=60)))

    tmp = tmp_path_factory.mktemp("heavy")
    fasta = str(tmp / "in.fasta")
    dbdir = str(tmp / "db")
    _write_fasta(fasta, seqs)
    build_db(dbdir, fasta, "fasta")
    art = load_db(dbdir)
    oracle = OracleDB(
        [(int(art.protein_ids[i]), art.protein(i)) for i in range(art.num_proteins)]
    )
    return art, oracle, seqs, shared


def test_grouped_caps_track_totals(heavy_db, monkeypatch):
    """Per-chunk caps track each chunk's own head: with the dispatch cost
    zeroed (so the cost model never coalesces for dispatch economy), heavy
    and light queries land in different chunks with different cap buckets,
    and both resolve exactly (no single-cap batch tax).  At the real
    dispatch cost, 8 tiny queries rightly coalesce into ONE chunk (one
    dispatch beats two at trivial expansion volumes) -- also asserted."""
    from kaamer_jax.search import engine as engine_mod

    art, oracle, seqs, shared = heavy_db
    engine = SearchEngine(art, hot=False)

    heavy = [seqs[0], seqs[1], seqs[2], seqs[3]]   # hot segment, total ~400+
    light = [seqs[-1][:40], seqs[-2][:30], seqs[-3][:40], seqs[-4][:30]]
    queries = (heavy + light) * 4  # 2 full G=16 chunks when split is free
    sizes = [len(q) - 6 for q in queries]

    calls = []
    orig = engine._p2

    def counting_p2(*a, **kw):
        # effective capacity: the tile tier (long runs) pays 128 lanes/row
        calls.append((a[1].shape[0], kw["cap_s"] + 128 * kw["cap_t"]))
        return orig(*a, **kw)

    engine._p2 = counting_p2
    monkeypatch.setattr(engine_mod, "DISPATCH_COST_ROWS", 0)
    res = engine.count_batch(queries, sizes, k=10)
    caps = sorted({cap for _, cap in calls})
    assert len(calls) >= 2 and len(caps) == 2, calls
    assert caps[0] <= 128 and caps[1] >= 512, calls

    # at the real dispatch cost the same tiny batch coalesces
    monkeypatch.setattr(engine_mod, "DISPATCH_COST_ROWS", 1 << 16)
    calls.clear()
    engine.count_batch(queries[:8], sizes[:8], k=10)
    engine._p2 = orig
    assert len(calls) == 1, calls

    ext = np.asarray(art.protein_ids)
    for q, size, qc in zip(queries, sizes, res):
        got = [(int(ext[int(r)]), int(c)) for r, c in zip(qc.hit_rows, qc.counts)]
        want, _ = oracle.kmer_search(q, size)
        assert got == want[: len(got)], q[:20]


def test_hot_path_small_caps_and_exact(heavy_db, monkeypatch):
    """With the hot-set dense path on (the default), the shared segment's
    postings are counted by the W @ M matmul: heavy queries stay at the
    minimum cap (their COLD expansion volume is tiny), route through _p2h,
    and results match the oracle exactly."""
    art, oracle, seqs, shared = heavy_db
    engine = SearchEngine(art)
    assert engine.hot_starts is not None
    monkeypatch.setattr(SearchEngine, "GROUP_B", 4)

    heavy = [seqs[0], seqs[1], seqs[2], seqs[3]]
    light = [seqs[-1][:40], seqs[-2][:30], seqs[-3][:40], seqs[-4][:30]]
    queries = heavy + light + [shared * 3]  # plus a pure-hot query
    sizes = [len(q) - 6 for q in queries]

    calls = {"hot": [], "cold": []}
    orig_h, orig_c = engine._p2h, engine._p2

    def counting_p2h(*a, **kw):
        calls["hot"].append(kw["cap_s"] + 128 * kw["cap_t"])
        return orig_h(*a, **kw)

    def counting_p2(*a, **kw):
        calls["cold"].append(kw["cap_s"] + 128 * kw["cap_t"])
        return orig_c(*a, **kw)

    engine._p2h, engine._p2 = counting_p2h, counting_p2
    res = engine.count_batch(queries, sizes, k=10)
    engine._p2h, engine._p2 = orig_h, orig_c

    assert calls["hot"], calls           # heavy queries used the dense path
    assert all(c <= 256 for c in calls["hot"] + calls["cold"]), calls

    ext = np.asarray(art.protein_ids)
    for q, size, qc in zip(queries, sizes, res):
        got = [(int(ext[int(r)]), int(c)) for r, c in zip(qc.hit_rows, qc.counts)]
        want, _ = oracle.kmer_search(q, size)
        assert got == want[: len(got)], q[:20]


def test_overflow_rerun_positions_match_host(heavy_db):
    """Position bitmaps of re-run (overflowed) queries equal the host path."""
    art, oracle, seqs, shared = heavy_db
    engine = SearchEngine(art)
    q = seqs[1]
    size = len(q) - 6
    (qc_pos,) = engine.count_batch([q], [size], k=10, positions=True)
    engine2 = SearchEngine(art)
    (qc,) = engine2.count_batch([q], [size], k=10)
    rows = [int(r) for r in qc.hit_rows[:5]]
    assert engine.position_bitmaps(qc_pos, rows) == engine2.position_bitmaps(qc, rows)


def test_overflow_beyond_cap_max_host_fallback(heavy_db, monkeypatch):
    """totals > CAP_MAX falls back to the exact host bincount."""
    import kaamer_jax.search.engine as eng_mod

    art, oracle, seqs, shared = heavy_db
    engine = SearchEngine(art)
    monkeypatch.setattr(eng_mod, "CAP_MAX", 1024)
    q = seqs[2]
    size = len(q) - 6
    (qc,) = engine.count_batch([q], [size], k=10)
    ext = np.asarray(art.protein_ids)
    got = [(int(ext[int(r)]), int(c)) for r, c in zip(qc.hit_rows, qc.counts)]
    want, _ = oracle.kmer_search(q, size)
    assert got == want[: len(got)]
    # host-fallback QueryCounts still answer position lookups
    rows = [int(r) for r in qc.hit_rows[:3]]
    bms = engine.position_bitmaps(qc, rows)
    want_rows, want_pos = oracle.kmer_search(q, size)
    for r in rows:
        assert bms[r] == want_pos[int(ext[r])]


def test_warmup_does_not_change_group_caps(heavy_db):
    """Group caps come from each batch's own exact totals, so a warmup's
    junk batches cannot perturb the caps a real workload gets (the round-1
    warmup/cap-hint interference bug class is structurally gone)."""
    art, _, seqs, _ = heavy_db
    engine = SearchEngine(art, hot=False)

    def caps_of(queries):
        calls = []
        orig = engine._p2

        def counting_p2(*a, **kw):
            calls.append(kw["cap_s"] + 128 * kw["cap_t"])
            return orig(*a, **kw)

        engine._p2 = counting_p2
        engine.count_batch(queries, [len(q) - 6 for q in queries], k=10)
        engine._p2 = orig
        return calls

    before = caps_of([seqs[0]])
    engine.warmup(batch_sizes=(16,), lengths=(16,), positions=(False,))
    after = caps_of([seqs[0]])
    assert before == after and before[0] > 256


def test_warmup_precompiles_without_error(synth_db):
    art, _, _ = synth_db
    engine = SearchEngine(art)
    engine.warmup(batch_sizes=(16,), lengths=(16, 32), positions=(False, True))
    # engine still functional afterwards
    q = art.protein(0).Sequence
    (qc,) = engine.count_batch([q], [len(q) - 6], k=5)
    assert qc.counts.size > 0


def test_warmup_precompiles_hot_shapes(heavy_db):
    """On a DB with hot sets, warmup also compiles the _p2h shapes and the
    engine answers hot queries correctly afterwards."""
    art, oracle, seqs, _ = heavy_db
    engine = SearchEngine(art)
    assert engine.hot_starts is not None
    engine.warmup(batch_sizes=(16,), lengths=(16,), positions=(False, True))
    q = seqs[0]
    (qc,) = engine.count_batch([q], [len(q) - 6], k=5)
    ext = np.asarray(art.protein_ids)
    got = [(int(ext[int(r)]), int(c)) for r, c in zip(qc.hit_rows, qc.counts)]
    want, _ = oracle.kmer_search(q, len(q) - 6)
    assert got == want[: len(got)]


def test_warmup_covers_skewed_serving_grid(skew_db):
    """VERDICT r2 ask 7: after warmup, a skewed workload whose length and
    cap buckets sit inside the warmed grid triggers NO new _p2/_p2h
    compiles (the warmup iterates exactly the scheduler's quantized
    (G, L, cap, positions) shapes)."""
    art, _, seqs, domains = skew_db
    engine = SearchEngine(art)
    assert engine.hot_starts is not None

    rng = np.random.default_rng(13)
    queries = []
    for i in range(24):
        q = seqs[i % len(seqs)][: int(rng.integers(20, 70))]
        if len(q) >= 7:
            queries.append(q)
    queries += [domains[0][:38], domains[1][:30] + domains[2][:30]]

    # cap_ts=(0,): this workload's postings sets are all below T_SPLIT, so
    # serving never emits a tile-tier shape -- warming the cap_t ladder
    # here would only triple the test's compile time
    engine.warmup(batch_sizes=(16, 32), lengths=(16, 32, 64),
                  positions=(False, True), cap_ts=(0,))
    c2, c2h = engine._p2._cache_size(), engine._p2h._cache_size()
    for pos in (False, True):
        for i in range(0, len(queries), 16):
            chunk = queries[i : i + 16]
            engine.count_batch(chunk, [len(q) - 6 for q in chunk], k=10,
                               positions=pos)
    assert engine._p2._cache_size() == c2
    assert engine._p2h._cache_size() == c2h


@pytest.fixture(scope="module")
def skew_db(tmp_path_factory):
    """Domain-skewed DB: a few 'conserved domains' shared by many proteins,
    so consecutive query k-mers resolve to one postings slice and the
    weighted run-dedup path (ops/count.py:dedup_runs) is actually hot --
    the k-mer-set-sharing regime KComb exists for (kcomb_store.go:42-63)."""
    rng = np.random.default_rng(7)
    domains = ["".join(rng.choice(list(AA), size=int(rng.integers(25, 60))))
               for _ in range(6)]
    seqs = []
    for i in range(70):
        # Zipf-ish domain choice: domain d appears in ~1/(d+1) of proteins
        parts = []
        for d, dom in enumerate(domains):
            if rng.random() < 1.0 / (d + 2):
                parts.append(dom)
        parts.append("".join(rng.choice(list(AA), size=int(rng.integers(20, 60)))))
        rng.shuffle(parts)
        seqs.append("".join(parts))

    tmp = tmp_path_factory.mktemp("skewdb")
    fasta = str(tmp / "in.fasta")
    dbdir = str(tmp / "db")
    _write_fasta(fasta, seqs)
    build_db(dbdir, fasta, "fasta")
    art = load_db(dbdir)
    from kaamer_jax.records import Protein

    entries = [
        (int(art.protein_ids[i]), art.protein(i)) for i in range(art.num_proteins)
    ]
    return art, OracleDB(entries), seqs, domains


def test_skewed_counts_and_positions_match_oracle(skew_db):
    art, oracle, seqs, domains = skew_db
    engine = SearchEngine(art)

    # queries dominated by popular domains (heavy duplicate-set runs), plus
    # a pure domain concatenation and a mutated domain
    mut = list(domains[0])
    mut[len(mut) // 2] = "W" if mut[len(mut) // 2] != "W" else "Y"
    queries = [seqs[3], seqs[11], domains[0] + domains[1], "".join(mut),
               seqs[20][:40]]
    sizes = [len(q) - 6 for q in queries]
    res = engine.count_batch(queries, sizes, k=16, positions=True)

    ext = np.asarray(art.protein_ids)
    for q, size, qc in zip(queries, sizes, res):
        got = [(int(ext[int(r)]), int(c)) for r, c in zip(qc.hit_rows, qc.counts)]
        want, want_pos = oracle.kmer_search(q, size)
        assert got[: len(want[:16])] == want[:16], f"query {q[:20]}..."
        # position bitmaps for the top hits
        rows = [int(r) for r in qc.hit_rows[:5]]
        bm = engine.position_bitmaps(qc, rows)
        for r in rows:
            assert bm[r] == want_pos[int(ext[r])], f"positions of hit {r}"


def test_skewed_sharded_matches_single(skew_db):
    from kaamer_jax.parallel.dist import ShardedSearchEngine, global_mesh

    art, _, seqs, domains = skew_db
    queries = [seqs[3], domains[0] + domains[1], seqs[11][:60]]
    sizes = [len(q) - 6 for q in queries]
    single = SearchEngine(art).count_batch(queries, sizes, k=12)
    sharded = ShardedSearchEngine(art, mesh=global_mesh(4)).count_batch(
        queries, sizes, k=12)
    for qw, qg in zip(single, sharded):
        assert [int(r) for r in qw.hit_rows] == [int(r) for r in qg.hit_rows]
        assert [int(c) for c in qw.counts] == [int(c) for c in qg.counts]


def test_expansion_budget_escalates_outliers(heavy_db, monkeypatch):
    """Queries above a group's expansion budget (MAX_EXPANSION_ELEMS / G)
    escalate into RERUN_B-wide chunks at the pow2 cap they need; normal
    groups stay within budget and results stay exact."""
    import kaamer_jax.search.engine as eng_mod

    art, oracle, seqs, shared = heavy_db
    # hot=False: with the dense hot path on, the heavy queries' COLD totals
    # are tiny and nothing escalates (test_hot_path_small_caps_and_exact)
    engine = SearchEngine(art, hot=False)
    # budget of 2^12 elements at G=16 -> group cap limit 256, below the
    # heavy queries' ~400+ deduped totals
    monkeypatch.setattr(eng_mod, "MAX_EXPANSION_ELEMS", 1 << 12)

    calls = []
    orig = engine._p2

    def counting_p2(*a, **kw):
        # effective capacity: the tile tier (long runs) pays 128 lanes/row
        calls.append((a[1].shape[0], kw["cap_s"] + 128 * kw["cap_t"]))
        return orig(*a, **kw)

    engine._p2 = counting_p2
    queries = [seqs[0], seqs[-1][:40]]
    sizes = [len(q) - 6 for q in queries]
    res = engine.count_batch(queries, sizes, k=10)
    engine._p2 = orig

    limit = (1 << 12) // 16
    # escalated chunks are narrow (4 or RERUN_B wide, chosen by the
    # dispatch-vs-padding trade) at the pow2 cap the outlier needs
    assert any(G in (4, SearchEngine.RERUN_B) and cap > limit
               for G, cap in calls), calls
    assert any(G * cap <= (1 << 12) for G, cap in calls), calls

    ext = np.asarray(art.protein_ids)
    for q, size, qc in zip(queries, sizes, res):
        got = [(int(ext[int(r)]), int(c)) for r, c in zip(qc.hit_rows, qc.counts)]
        want, _ = oracle.kmer_search(q, size)
        assert got == want[: len(got)], q[:20]


def test_scheduler_coalesces_small_cap_tails(synth_db):
    """Dispatch-count regression: same-hotness small-cap queries must land
    in as few phase-2 groups as the G_QUANTA quantization permits -- tails
    round UP to the next width instead of cascading into G=16 chunks (each
    extra dispatch costs ~2.5-3 ms of fixed cost in production)."""
    art, oracle, seqs = synth_db
    engine = SearchEngine(art, hot=False)
    rng = np.random.default_rng(12)
    queries = [seqs[int(rng.integers(0, len(seqs)))] for _ in range(300)]
    sizes = [len(q) - 6 for q in queries]

    calls = []
    orig = engine._dispatch_group

    def spy(outs1, rows, G, cap_s, cap_t, k_full, L, positions, hot,
            identity=False):
        calls.append((len(rows), G, cap_s + 128 * cap_t))
        return orig(outs1, rows, G, cap_s, cap_t, k_full, L, positions,
                    hot, identity=identity)

    engine._dispatch_group = spy
    res = engine.count_batch(queries, sizes, k=8)
    engine._dispatch_group = orig

    # 300 same-class queries must dispatch as exactly 2 quantized groups
    # (e.g. 256 + a 44-tail in the next width down), never a G=16 cascade
    assert len(calls) == 2, calls
    assert all(G >= 64 for _, G, _ in calls), calls
    assert sum(n for n, _, _ in calls) >= 300

    # and results still match the oracle
    ext = np.asarray(art.protein_ids)
    for q, size, qc in zip(queries[:20], sizes[:20], res[:20]):
        got = [(int(ext[int(r)]), int(c)) for r, c in zip(qc.hit_rows, qc.counts)]
        want, _ = oracle.kmer_search(q, size)
        assert got == want[: len(got)]


def test_prefetch_batch_protocol(heavy_db):
    """prefetch_batch must be idempotent, optional (collect alone works),
    and produce identical results either way -- including min_top gating
    through the prefetch path (the serving loops' staged protocol)."""
    art, oracle, seqs, _ = heavy_db
    engine = SearchEngine(art)
    queries = [seqs[0], seqs[3][:40], seqs[5]]
    sizes = [len(q) - 6 for q in queries]

    direct = engine.collect_batch(
        engine.schedule_batch(engine.dispatch_batch(queries, sizes, k=10)))
    s = engine.schedule_batch(engine.dispatch_batch(queries, sizes, k=10))
    s = engine.prefetch_batch(s)
    s = engine.prefetch_batch(s)  # idempotent
    staged = engine.collect_batch(s)
    for a, b in zip(direct, staged):
        np.testing.assert_array_equal(a.hit_rows, b.hit_rows)
        np.testing.assert_array_equal(a.counts, b.counts)

    s2 = engine.schedule_batch(engine.dispatch_batch(queries, sizes, k=10))
    s2 = engine.prefetch_batch(s2, min_top=5)
    gated = engine.collect_batch(s2, min_top=5)
    for g, b in zip(gated, direct):
        top = int(b.counts[0]) if len(b.counts) else 0
        if top >= 5:
            assert g is not None
            np.testing.assert_array_equal(g.hit_rows, b.hit_rows)
        else:
            assert g is None
