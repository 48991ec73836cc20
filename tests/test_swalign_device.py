"""Device wavefront SW (ops/swalign_device.py) vs the host DP.

On the CPU backend the DP kernel runs in Pallas interpret mode: the same
kernel, arithmetic and padding as on the GPU, where chip_smoke.py's kernel
phase compares the compiled kernel with the host DP at real widths."""

import numpy as np
import pytest

from kaamer_jax.ops import swalign, swalign_device
from kaamer_jax.ops.matrices import LETTER_INDEX, get_matrix_scores
from kaamer_jax.ops.swalign_device import align_pairs

AA = "ACDEFGHIKLMNPQRSTVWY"


def _host(q, r, scores):
    qa = LETTER_INDEX[np.frombuffer(q.encode(), np.uint8)]
    ra = LETTER_INDEX[np.frombuffer(r.encode(), np.uint8)]
    return swalign._smith_waterman(qa, ra, scores.sub_matrix,
                                   scores.gap_open, scores.gap_extend)


def _assert_matches_host(pairs, scores):
    got = align_pairs(pairs, scores)
    for (q, r), (score, q_ops, r_ops) in zip(pairs, got):
        h_score, h_qops, h_rops = _host(q, r, scores)
        assert score == h_score, (q, r)
        # identical alignment path under identical tie-breaking
        assert q_ops == h_qops, (q, r)
        assert r_ops == h_rops, (q, r)


def _mutate(rng, seq, n_sub, indels=()):
    s = list(seq)
    for _ in range(n_sub):
        p = int(rng.integers(0, len(s)))
        s[p] = AA[int(rng.integers(0, 20))]
    for lo, hi, ins in indels:
        s[lo:hi] = list(ins)
    return "".join(s)


def _rand(rng, n):
    return "".join(rng.choice(list(AA), size=n))


def test_device_matches_host_dp():
    rng = np.random.default_rng(3)
    scores = get_matrix_scores("blosum62", 11, 1)

    pairs = []
    for _ in range(6):
        base = _rand(rng, int(rng.integers(30, 90)))
        # related pair: mutate/delete a bit
        mutated = list(base)
        for _ in range(int(rng.integers(0, 6))):
            p = int(rng.integers(0, len(mutated)))
            mutated[p] = AA[int(rng.integers(0, 20))]
        if rng.random() < 0.5 and len(mutated) > 20:
            del mutated[5:9]
        pairs.append((base, "".join(mutated)))
    # one unrelated pair
    pairs.append((_rand(rng, 40), _rand(rng, 55)))
    _assert_matches_host(pairs, scores)


@pytest.mark.parametrize("m,n", [(127, 128), (128, 127), (129, 300),
                                 (255, 256), (300, 129)])
def test_device_lengths_across_lane_buckets(m, n):
    """Lengths on both sides of the power-of-two buckets of W and the
    128-multiple buckets of n_pad, in one batch with shorter pairs (padding
    lanes and diagonals stay inert)."""
    rng = np.random.default_rng(m * 1000 + n)
    scores = get_matrix_scores("blosum62", 11, 1)
    base = _rand(rng, max(m, n))
    pairs = [
        (base[:m], _mutate(rng, base[:n], 8)),
        (_mutate(rng, base[:m], 20), base[:n]),
        (base[: m // 3], base[:n]),
        (_rand(rng, m), _rand(rng, n)),
    ]
    _assert_matches_host(pairs, scores)


@pytest.mark.parametrize("gap_open,gap_extend", [(11, 1), (6, 2), (2, 1)])
def test_device_gap_heavy(gap_open, gap_extend):
    """Pairs whose best alignments open and extend several gaps, in both
    sequences, under expensive and cheap gap models (2/1 is not a served
    model; it makes gaps nearly free, so the paths are all gaps)."""
    rng = np.random.default_rng(gap_open * 10 + gap_extend)
    scores = get_matrix_scores("blosum62", 11, 1)._replace(
        gap_open=gap_open, gap_extend=gap_extend)
    pairs = []
    for k in range(6):
        base = _rand(rng, 160)
        # long insertions in the reference, deletions from it, and both
        ref = _mutate(rng, base, 6, indels=[(20, 20, _rand(rng, 9 + k)),
                                            (70, 84, ""),
                                            (120, 121, _rand(rng, 3))])
        pairs.append((base, ref) if k % 2 else (ref, base))
    _assert_matches_host(pairs, scores)


def test_device_perfect_self_alignment():
    scores = get_matrix_scores("blosum62", 11, 1)
    seq = "MELPNIMHPVAKLSTALAAALMLSGCMPGEIRPTIGQQME"
    ((score, q_ops, r_ops),) = align_pairs([(seq, seq)], scores)
    assert q_ops == list(range(len(seq)))
    assert r_ops == list(range(len(seq)))
    m62 = scores.sub_matrix
    want = sum(int(m62[LETTER_INDEX[ord(c)], LETTER_INDEX[ord(c)]]) for c in seq)
    assert score == want


def test_device_no_hit():
    scores = get_matrix_scores("blosum62", 11, 1)
    # force an all-negative substitution outcome: W vs P mismatches only
    ((score, q_ops, _),) = align_pairs([("WWWW", "PPPP")], scores)
    assert score == 0 and q_ops == []


def test_pad_shape_buckets():
    # W: power of two >= m + 1 (min 128); n_pad: multiple of 128; B: pow2
    assert swalign_device.pad_shape(127, 1, 3) == (16, 128, 128)
    assert swalign_device.pad_shape(128, 129, 17) == (32, 256, 256)
    assert swalign_device.pad_shape(1023, 1000, 256) == (256, 1024, 1024)
    assert swalign_device.pad_shape(1024, 2048, 257) == (512, 2048, 2048)


def _boom(*args, **kwargs):
    raise RuntimeError("device alignment failed")


def test_device_failure_raises_instead_of_host_fallback(monkeypatch):
    monkeypatch.setattr(swalign_device, "sw_batch_dispatch", _boom)
    pairs = [("MKTAYIAKQRQISFVKSHFSRQ", "MKTAYIAKQRQISFVKSHFSRQ")] * 8
    with pytest.raises(RuntimeError, match="device alignment failed"):
        swalign.align_batch(pairs, _stats())


def test_small_batches_route_to_host_by_design(monkeypatch):
    """Below DEVICE_MIN_PAIRS the host DP is the documented route, not a
    fallback: the device path is never entered."""
    monkeypatch.setattr(swalign_device, "sw_batch_dispatch", _boom)
    pairs = [("MKTAYIAKQRQISFVKSHFSRQ", "MKTAYIAKQRQISFVKSHFSRQ")] * (
        swalign.DEVICE_MIN_PAIRS - 1)
    res = swalign.align_batch(pairs, _stats())
    assert all(r.Length == len(pairs[0][0]) for r in res)


def _stats():
    from kaamer_jax.records import KStats

    st = KStats()
    st.NumberOfAA = 10**6
    return st
