import math

import numpy as np
import pytest

from kaamer_jax.ops import swalign
from kaamer_jax.ops.matrices import (
    ALL_MATRIX_SCORES,
    LETTER_INDEX,
    get_matrix_scores,
    NoMatrixError,
)
from kaamer_jax.records import KStats

AA = "ACDEFGHIKLMNPQRSTVWY"


def _scalar_gotoh(q, r, mat, gap_open, gap_extend):
    """Reference scalar Gotoh (test oracle for the wavefront DP)."""
    m, n = len(q), len(r)
    NEG = -(10**8)
    H = np.zeros((m + 1, n + 1), dtype=np.int64)
    E = np.full((m + 1, n + 1), NEG, dtype=np.int64)
    F = np.full((m + 1, n + 1), NEG, dtype=np.int64)
    for i in range(1, m + 1):
        for j in range(1, n + 1):
            E[i, j] = max(H[i, j - 1] - gap_open, E[i, j - 1] - gap_extend)
            F[i, j] = max(H[i - 1, j] - gap_open, F[i - 1, j] - gap_extend)
            H[i, j] = max(0, H[i - 1, j - 1] + mat[q[i - 1], r[j - 1]],
                          E[i, j], F[i, j])
    return H


def test_wavefront_matches_scalar():
    rng = np.random.default_rng(0)
    scores = get_matrix_scores("blosum62", 11, 1)
    for _ in range(10):
        q = LETTER_INDEX[
            np.frombuffer("".join(rng.choice(list(AA), size=int(rng.integers(10, 60)))).encode(), np.uint8)]
        r = LETTER_INDEX[
            np.frombuffer("".join(rng.choice(list(AA), size=int(rng.integers(10, 60)))).encode(), np.uint8)]
        H, _, _ = swalign._dp_matrices(q, r, scores.sub_matrix, 11, 1)
        H_ref = _scalar_gotoh(q, r, scores.sub_matrix, 11, 1)
        np.testing.assert_array_equal(H, H_ref)


def test_self_alignment_perfect():
    seq = "MELPNIMHPVAKLSTALAAALMLSGCMPGEIRPTIGQQME"
    stats = KStats(NumberOfAA=1_000_000)
    a = swalign.align(seq, seq, stats)
    assert a.Identity == 100.0
    assert a.Mismatches == 0
    assert a.GapOpenings == 0
    assert a.Length == len(seq)
    assert a.QueryStart == 1 and a.QueryEnd == len(seq)
    assert a.SubjectStart == 1 and a.SubjectEnd == len(seq)
    # raw = sum of diagonal BLOSUM62 scores
    raw = sum(int(swalign.LETTER_INDEX[ord(c)] >= 0) and
              int(ALL_MATRIX_SCORES["blosum62_11_1"].sub_matrix[
                  swalign.LETTER_INDEX[ord(c)], swalign.LETTER_INDEX[ord(c)]])
              for c in seq)
    assert a.Raw == raw
    # bit score formula (align.go:136)
    lam, K = 0.267, 0.041
    assert a.BitScore == pytest.approx((lam * raw - math.log(K)) / math.log(2))
    assert a.EValue == pytest.approx(
        len(seq) * 1_000_000 / 2 ** a.BitScore, rel=1e-9
    )


def test_gap_alignment():
    stats = KStats(NumberOfAA=1000)
    q = "MELPNIMHPVAKLSTAL"
    r = "MELPNIMHP" + "GGG" + "VAKLSTAL"  # 3-residue insertion in subject
    a = swalign.align(q, r, stats)
    assert a.GapOpenings == 1
    assert a.Mismatches == 0
    assert a.Length == len(q) + 3
    # raw = matches - (open + 2*extend)
    m62 = ALL_MATRIX_SCORES["blosum62_11_1"].sub_matrix
    diag = sum(int(m62[swalign.LETTER_INDEX[ord(c)], swalign.LETTER_INDEX[ord(c)]]) for c in q)
    assert a.Raw == diag - (11 + 2 * 1)


def test_mismatch_counting_and_similarity():
    stats = KStats(NumberOfAA=1000)
    q = "MELPNIMHPVAKLSTAL"
    r = "MELPNIMHPVAKLSTAI"  # L->I at the end: positive BLOSUM62 score (2)
    a = swalign.align(q, r, stats)
    assert a.Mismatches == 1
    assert a.Identity < 100.0
    assert a.Similarity == 100.0  # I/L scores positive


def test_u_replaced_by_star():
    stats = KStats(NumberOfAA=1000)
    a = swalign.align("MELPNIUHPVAKLSTAL", "MELPNIUHPVAKLSTAL", stats)
    assert a.Identity == 100.0
    assert "U" not in a.AlnString


def test_unknown_matrix_raises():
    with pytest.raises(NoMatrixError):
        get_matrix_scores("blosum62", 99, 9)


def test_all_82_parameter_sets_present():
    assert len(ALL_MATRIX_SCORES) == 82
    for key, ms in ALL_MATRIX_SCORES.items():
        assert ms.sub_matrix.shape == (24, 24)
        assert ms.lam > 0 and ms.K > 0
