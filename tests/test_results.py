from kaamer_jax.search.results import (
    Hit,
    QueryResult,
    filter_results,
    format_positions,
)
from kaamer_jax.search.options import SearchOptions
from kaamer_jax.io_formats.readers import QueryRecord


def test_format_positions_full_run():
    # matches docs fixture: 264 consecutive matches -> "1-264"
    assert format_positions([True] * 264, False) == "1-264"


def test_format_positions_with_alignment_extends_end():
    assert format_positions([True] * 10, True) == "1-16"


def test_format_positions_interior_run_quirk():
    # run [0..0] followed by a miss at index 1: the reference reports the
    # 1-based position of the miss as the end (search.go:709-717)
    assert format_positions([True, False, True, True], False) == "1-2,3-4"
    assert format_positions([False, True, True, False, False, True], False) == "2-4,6-6"


def test_format_positions_empty():
    assert format_positions([False, False], False) == ""


def _qr(counts, size):
    q = QueryRecord(Sequence="A" * (size + 6), SizeInKmer=size)
    hits = [Hit(Key=i + 1, Kmatch=c) for i, c in enumerate(counts)]
    pos = {h.Key: [True] for h in hits}
    return QueryResult(Query=q, Hits=hits, PositionHits=pos, HitEntries={})


def test_filter_results_ratio_and_min_match():
    opts = SearchOptions(MinKMatch=10, MinKRatio=0.05, MaxResults=10)
    qr = _qr([100, 50, 9, 5], size=200)
    filter_results(qr, opts)
    # 9 fails MinKMatch; suffix dropped
    assert [h.Kmatch for h in qr.Hits] == [100, 50]
    assert set(qr.PositionHits) == {1, 2}


def test_filter_results_max_results_cap():
    opts = SearchOptions(MinKMatch=1, MinKRatio=0.0, MaxResults=2)
    qr = _qr([30, 20, 15, 12], size=100)
    filter_results(qr, opts)
    assert [h.Kmatch for h in qr.Hits] == [30, 20]


def test_filter_results_all_fail():
    opts = SearchOptions(MinKMatch=10, MinKRatio=0.05, MaxResults=10)
    qr = _qr([5], size=200)
    filter_results(qr, opts)
    assert qr.Hits == []
