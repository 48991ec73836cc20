"""Smith-Waterman affine-gap local alignment with traceback.

Capability match for reference pkg/align/align.go:46-161 (which delegates the
DP to biogo SWAffine).  Output fields, identity/similarity/mismatch
accounting (align.go:82-101), raw-score gap adjustment (116-132), bit score
S' = (lambda*S - ln K)/ln 2 (136) and E-value m*n/2^S' with n = database AA
count (141) are reproduced formula-for-formula.

Gap model: a run of g gap columns costs gapOpen + (g-1)*gapExtend, matching
the reference's raw-score reconstruction (align.go:127-131).

Two deliberate deviations from reference quirks, both documented:
- the reference hard-codes the DP matrix to BLOSUM62 with open -11 even when
  the user selects another matrix (align.go:62-65) and then re-scores the
  BLOSUM62-optimal alignment; we run the DP with the selected matrix/gaps;
- traceback tie-breaking may differ from biogo's, which can produce a
  different-but-equal-scoring alignment string in degenerate cases.

Selenocysteine handling matches: 'U'/'u' is replaced by '*' before alignment
(align.go:38, 53-55).
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np

from ..records import KStats
from .matrices import LETTER_INDEX, MatrixScores, NoMatrixError, get_matrix_scores
from ..search.results import AlignmentResult

NEG_INF = np.int32(-(10**8))

# Batches smaller than this, or with a sequence longer than DEVICE_MAX_LEN,
# align with the host DP by design: a handful of pairs costs less on the
# host than a device dispatch, and the device DP's [B, D, W] direction
# tensor grows with the square of the longest sequence.
DEVICE_MIN_PAIRS = 4
DEVICE_MAX_LEN = 2048


def _dp_matrices(q, r, mat, gap_open, gap_extend):
    """Wavefront (anti-diagonal) Gotoh DP: every anti-diagonal is a fully
    vectorized update, so the Python loop count is m+n rather than m*n.
    Returns the filled (H, E, F) matrices."""
    m, n = len(q), len(r)
    H = np.zeros((m + 1, n + 1), dtype=np.int32)
    E = np.full((m + 1, n + 1), NEG_INF, dtype=np.int32)  # gap in query (left)
    F = np.full((m + 1, n + 1), NEG_INF, dtype=np.int32)  # gap in ref (up)
    sub = mat[q][:, r]  # [m, n] substitution scores

    for d in range(2, m + n + 1):  # cells with i+j == d, 1<=i<=m, 1<=j<=n
        i_lo = max(1, d - n)
        i_hi = min(m, d - 1)
        if i_lo > i_hi:
            continue
        i = np.arange(i_lo, i_hi + 1)
        j = d - i
        e = np.maximum(H[i, j - 1] - gap_open, E[i, j - 1] - gap_extend)
        f = np.maximum(H[i - 1, j] - gap_open, F[i - 1, j] - gap_extend)
        h = np.maximum(
            np.maximum(0, H[i - 1, j - 1] + sub[i - 1, j - 1]),
            np.maximum(e, f),
        )
        E[i, j] = e
        F[i, j] = f
        H[i, j] = h
    return H, E, F


def _smith_waterman(
    q: np.ndarray, r: np.ndarray, mat: np.ndarray, gap_open: int, gap_extend: int
) -> Tuple[int, list, list]:
    """Gotoh local alignment.  q, r: LETTER_INDEX arrays.  Returns
    (best_score, q_aln_ops, r_aln_ops) where ops are index lists with -1 for
    gap columns, covering the local alignment region only."""
    m, n = len(q), len(r)
    H, E, F = _dp_matrices(q, r, mat, gap_open, gap_extend)
    sub = mat[q][:, r]

    best = int(H.max())
    if best <= 0:
        return 0, [], []
    i, j = np.unravel_index(int(H.argmax()), H.shape)
    i, j = int(i), int(j)

    q_ops: list = []
    r_ops: list = []
    state = "H"
    while i > 0 and j > 0:
        if state == "H":
            h = H[i, j]
            if h == 0:
                break
            if h == H[i - 1, j - 1] + sub[i - 1, j - 1]:
                q_ops.append(i - 1)
                r_ops.append(j - 1)
                i -= 1
                j -= 1
            elif h == E[i, j]:
                state = "E"
            elif h == F[i, j]:
                state = "F"
            else:  # pragma: no cover - defensive
                break
        elif state == "E":
            q_ops.append(-1)
            r_ops.append(j - 1)
            if E[i, j] == H[i, j - 1] - gap_open:
                state = "H"
            j -= 1
        else:  # state == "F"
            q_ops.append(i - 1)
            r_ops.append(-1)
            if F[i, j] == H[i - 1, j] - gap_open:
                state = "H"
            i -= 1
    q_ops.reverse()
    r_ops.reverse()
    return best, q_ops, r_ops


def align(
    query_seq: str,
    ref_seq: str,
    db_stats: KStats,
    sub_matrix: str = "blosum62",
    gap_open: int = 11,
    gap_extend: int = 1,
) -> AlignmentResult:
    scores: MatrixScores = get_matrix_scores(sub_matrix, gap_open, gap_extend)

    query_seq = query_seq.replace("U", "*").replace("u", "*")
    ref_seq = ref_seq.replace("U", "*").replace("u", "*")

    q = LETTER_INDEX[np.frombuffer(query_seq.encode("latin-1"), dtype=np.uint8)]
    r = LETTER_INDEX[np.frombuffer(ref_seq.encode("latin-1"), dtype=np.uint8)]

    _, q_ops, r_ops = _smith_waterman(
        q, r, scores.sub_matrix, scores.gap_open, scores.gap_extend
    )
    return result_from_ops(query_seq, ref_seq, scores, q_ops, r_ops, db_stats)


def align_batch(
    pairs,
    db_stats: KStats,
    sub_matrix: str = "blosum62",
    gap_open: int = 11,
    gap_extend: int = 1,
    use_device: bool = True,
):
    """Align many (query, ref) pairs; the DP runs on the device
    (ops/swalign_device.py) unless the batch is small or holds a very long
    sequence (DEVICE_MIN_PAIRS, DEVICE_MAX_LEN).  Returns a list of
    AlignmentResult."""
    return align_batch_resolve(align_batch_dispatch(
        pairs, db_stats, sub_matrix, gap_open, gap_extend,
        use_device=use_device))


def align_batch_dispatch(
    pairs,
    db_stats: KStats,
    sub_matrix: str = "blosum62",
    gap_open: int = 11,
    gap_extend: int = 1,
    use_device: bool = True,
):
    """Asynchronously dispatch the device DP for a pair batch; returns a
    handle for align_batch_resolve.  JAX dispatch is async, so the serving
    stream can keep collecting search results (and dispatching further
    search batches) while a flushed alignment batch runs; the reference
    aligns synchronously per hit inside its result handler
    (align.go:46-161).  Raises NoMatrixError like align_batch; a device
    error propagates -- it is never answered by the host DP."""
    scores = get_matrix_scores(sub_matrix, gap_open, gap_extend)
    pairs = [
        (q.replace("U", "*").replace("u", "*"),
         r.replace("U", "*").replace("u", "*"))
        for q, r in pairs
    ]

    dev = None
    if use_device and len(pairs) >= DEVICE_MIN_PAIRS and max(
        max(len(q), len(r)) for q, r in pairs
    ) <= DEVICE_MAX_LEN:
        from .swalign_device import sw_batch_dispatch

        qs = [LETTER_INDEX[np.frombuffer(q.encode("latin-1"), np.uint8)]
              for q, _ in pairs]
        rs = [LETTER_INDEX[np.frombuffer(r.encode("latin-1"), np.uint8)]
              for _, r in pairs]
        dev = sw_batch_dispatch(qs, rs, scores)
    return (pairs, scores, db_stats, dev)


def align_batch_resolve(handle):
    """Finish an align_batch_dispatch: fetch the device op streams (or run
    the host DP for batches routed there) and build AlignmentResults."""
    pairs, scores, db_stats, dev = handle
    if dev is not None:
        from .swalign_device import sw_batch_resolve

        ops = sw_batch_resolve(dev)
    else:
        ops = []
        for q, r in pairs:
            qa = LETTER_INDEX[np.frombuffer(q.encode("latin-1"), np.uint8)]
            ra = LETTER_INDEX[np.frombuffer(r.encode("latin-1"), np.uint8)]
            ops.append(_smith_waterman(qa, ra, scores.sub_matrix,
                                       scores.gap_open, scores.gap_extend))

    return [
        result_from_ops(q, r, scores, q_ops, r_ops, db_stats)
        for (q, r), (_, q_ops, r_ops) in zip(pairs, ops)
    ]


def result_from_ops(
    query_seq: str, ref_seq: str, scores: MatrixScores,
    q_ops, r_ops, db_stats: KStats,
) -> AlignmentResult:
    """Build the reference-formula result fields from an alignment path."""
    if not q_ops:
        return AlignmentResult()
    qb = np.frombuffer(query_seq.encode("latin-1"), dtype=np.uint8)
    rb = np.frombuffer(ref_seq.encode("latin-1"), dtype=np.uint8)
    q = LETTER_INDEX[qb]
    r = LETTER_INDEX[rb]
    qo = np.asarray(q_ops, dtype=np.int64)
    ro = np.asarray(r_ops, dtype=np.int64)

    # one vectorized pass replaces three per-character Python loops: the
    # -aln serving stream finalizes thousands of pairs per second, and
    # ~300 iterations/pair was its dominant host term
    GAP = np.uint8(ord("-"))
    a_bytes = np.where(qo >= 0, qb[np.maximum(qo, 0)], GAP)
    b_bytes = np.where(ro >= 0, rb[np.maximum(ro, 0)], GAP)
    a_string = a_bytes.tobytes().decode("latin-1")
    b_string = b_bytes.tobytes().decode("latin-1")

    # identity / similarity / mismatches (align.go:82-101); the reference
    # accumulates float32 1.0s -- exact integers, so integer counts cast
    # through float32 are bit-identical
    mat = scores.sub_matrix
    eq = a_bytes == b_bytes
    both = (a_bytes != GAP) & (b_bytes != GAP)
    mismatches = int((~eq & both).sum())
    positive = mat[LETTER_INDEX[b_bytes], LETTER_INDEX[a_bytes]] > 0
    n_id = int(eq.sum())
    n_sim = n_id + int((~eq & positive).sum())
    match_bytes = np.where(eq, b_bytes,
                           np.where(positive, np.uint8(ord("+")),
                                    np.uint8(ord(" "))))
    nb_pos = np.float32(len(a_string))
    identity = float(np.float32(n_id) / nb_pos * np.float32(100))
    similarity = float(np.float32(n_sim) / nb_pos * np.float32(100))
    aln_string = (f"{a_string}\n"
                  f"{match_bytes.tobytes().decode('latin-1')}\n{b_string}")

    # raw score + gap openings (align.go:105-132 semantics): every gapped
    # column costs gap_extend except the first of each run (gap_open)
    gap = ~both
    gap_start = gap & ~np.concatenate([[False], gap[:-1]])
    gap_openings = int(gap_start.sum())
    n_gap = int(gap.sum())
    raw = int(mat[q[qo[both]], r[ro[both]]].sum(dtype=np.int64))
    raw -= gap_openings * scores.gap_open + (n_gap - gap_openings) * scores.gap_extend

    bitscore = (scores.lam * raw - math.log(scores.K)) / math.log(2)
    evalue = float(len(query_seq)) * float(db_stats.NumberOfAA) / math.pow(2, bitscore)

    q_idx = qo[qo >= 0]
    r_idx = ro[ro >= 0]

    return AlignmentResult(
        Identity=identity,
        Similarity=similarity,
        Length=len(a_string),
        Mismatches=mismatches,
        GapOpenings=gap_openings,
        Raw=raw,
        BitScore=bitscore,
        EValue=evalue,
        AlnString=aln_string,
        QueryStart=int(q_idx[0]) + 1 if q_idx.size else 0,
        QueryEnd=int(q_idx[-1]) + 1 if q_idx.size else 0,
        SubjectStart=int(r_idx[0]) + 1 if r_idx.size else 0,
        SubjectEnd=int(r_idx[-1]) + 1 if r_idx.size else 0,
    )
