"""Batched Smith-Waterman on the device.

The DP is a Pallas kernel for the GPU (backend="triton"): one program per
(query, ref) pair loops over the anti-diagonals of the DP matrix with the
whole diagonal [W] in registers, W the query length rounded up to a power
of two.  On diagonal d, lane i holds cell (i, d - i); its left neighbour
sits at lane i of diagonal d-1, its upper neighbour at lane i-1 of d-1 and
its diagonal neighbour at lane i-1 of d-2.  The lane shift (lane i <- lane
i-1) goes through a small per-pair row buffer in device memory: the new H
and F rows are stored one lane to the right, a block barrier makes them
visible, and the next diagonal loads them back.  The buffer is
double-buffered by diagonal parity, so one barrier per diagonal suffices.
Substitution scores are read from the score table at the lane's query code
and the reference code of a sliding window over the reversed reference, so
no [B, m, n] score tensor is materialized.  Off the GPU (the CPU test
backend) the same kernel runs in Pallas interpret mode.

Per pair the kernel emits:
  dirs uint8[D, W]  packed traceback decisions in diagonal layout, cell
                    (i, j) at [i + j, i]
                    (bits 0-1: H origin 0=stop 1=diag 2=E 3=F;
                     bit 2: E continued from E; bit 3: F continued from F)
  best int32[2, W]  per-lane running best score and its diagonal
A device traceback (_build_traceback) walks the packed directions for all
pairs in lockstep, so only the short op streams travel to the host.

Scores/semantics match ops/swalign.py's host DP exactly (same gap model: a
run of g gap columns costs open + (g-1)*extend) and are differentially
tested against it.  The endpoint is the row-major-first best cell, as on the
host, so the traceback walks the same path.
"""

from __future__ import annotations

from functools import partial
from typing import List, Tuple

import numpy as np

from .matrices import LETTER_INDEX, MatrixScores

NEG = -(10**8)


def _kernel(q_ref, rev_ref, ql_ref, rl_ref, mat_ref, hb_in, fb_in,
            dirs_ref, best_ref, hbuf, fbuf, *, W: int, n_pad: int, K: int,
            gap_open: int, gap_extend: int, interpret: bool):
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import triton as pltriton

    del hb_in, fb_in  # aliased to hbuf/fbuf (initialized by the caller)
    b = pl.program_id(0)
    D = W + n_pad
    lane = jax.lax.broadcasted_iota(jnp.int32, (W,), 0)
    qlen = ql_ref[b]
    rlen = rl_ref[b]
    qrow = q_ref[b, pl.ds(0, W)] * K

    def step(d, carry):
        h_prev, e_prev, hs2, best_v, best_d = carry
        par = d & 1
        hs = hbuf[b, par, pl.ds(0, W)]     # shift1(h_prev), lane 0 = 0
        fs = fbuf[b, par, pl.ds(0, W)]     # shift1(f_prev), lane 0 = NEG
        r_at = rev_ref[b, pl.ds(W + n_pad - d, W)]
        sub = mat_ref[qrow + r_at]
        valid = ((lane >= 1) & (lane <= qlen)
                 & (d - lane >= 1) & (d - lane <= rlen))
        e = jnp.maximum(h_prev - gap_open, e_prev - gap_extend)
        f = jnp.maximum(hs - gap_open, fs - gap_extend)
        h0 = hs2 + sub
        h = jnp.maximum(jnp.maximum(0, h0), jnp.maximum(e, f))
        e = jnp.where(valid, e, NEG)
        f = jnp.where(valid, f, NEG)
        h = jnp.where(valid, h, 0)
        hdir = jnp.where(h == 0, 0,
                         jnp.where(h == h0, 1, jnp.where(h == e, 2, 3)))
        edir = (e != h_prev - gap_open).astype(jnp.int32)
        fdir = (f != hs - gap_open).astype(jnp.int32)
        dirs_ref[b, d, pl.ds(0, W)] = (
            hdir | (edir << 2) | (fdir << 3)).astype(jnp.uint8)
        hbuf[b, 1 - par, pl.ds(1, W)] = h
        fbuf[b, 1 - par, pl.ds(1, W)] = f
        if not interpret:  # the interpreter runs the block sequentially
            pltriton.debug_barrier()
        better = h > best_v
        best_v = jnp.where(better, h, best_v)
        best_d = jnp.where(better, d, best_d)
        return h, e, hs, best_v, best_d

    zeros = jnp.zeros((W,), jnp.int32)
    init = (zeros, jnp.full((W,), NEG, jnp.int32), zeros, zeros, zeros)
    _, _, _, best_v, best_d = jax.lax.fori_loop(0, D, step, init)
    best_ref[b, 0, pl.ds(0, W)] = best_v
    best_ref[b, 1, pl.ds(0, W)] = best_d


def _build_dp(B: int, W: int, n_pad: int, gap_open: int, gap_extend: int,
              interpret: bool):
    """Jitted DP: (qcodes int32[B, W-1], rcodes int32[B, n_pad], qlens
    int32[B], rlens int32[B], mat int32[K, K]) -> (dirs uint8[B, D, W],
    best int32[B, 2, W]) with D = W + n_pad diagonals."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import triton as pltriton

    D = W + n_pad

    def dp(qcodes, rcodes, qlens, rlens, mat):
        K = mat.shape[0]
        q = jnp.pad(qcodes, ((0, 0), (1, 0)))   # lane i <- query residue i-1
        # rev[W + n_pad - d + i] == rcodes[d - 1 - i]: a W-wide window whose
        # start slides by one per diagonal
        rev = jnp.pad(rcodes[:, ::-1], ((0, 0), (W, W)))
        hb = jnp.zeros((B, 2, W + 1), jnp.int32)
        fb = jnp.full((B, 2, W + 1), NEG, jnp.int32)
        call = pl.pallas_call(
            partial(_kernel, W=W, n_pad=n_pad, K=K, gap_open=gap_open,
                    gap_extend=gap_extend, interpret=interpret),
            grid=(B,),
            out_shape=[
                jax.ShapeDtypeStruct((B, D, W), jnp.uint8),
                jax.ShapeDtypeStruct((B, 2, W), jnp.int32),
                jax.ShapeDtypeStruct((B, 2, W + 1), jnp.int32),
                jax.ShapeDtypeStruct((B, 2, W + 1), jnp.int32),
            ],
            input_output_aliases={5: 2, 6: 3},
            backend="triton",
            compiler_params=pltriton.CompilerParams(
                num_warps=max(1, min(8, W // 256)), num_stages=1),
            interpret=interpret,
            name="sw_wavefront",
        )
        dirs, best, _, _ = call(q, rev, qlens, rlens, mat.reshape(-1), hb, fb)
        return dirs, best

    return jax.jit(dp)


def _build_traceback(B: int, d_pad: int, W: int):
    """Device-side traceback: a lax.scan over at most 2*d_pad steps that
    walks the packed direction bytes for all B pairs in lockstep and emits
    per-step (q_op, r_op, emit) streams.  Keeps the [B, d_pad, W] dirs
    tensor on device -- only the op streams (a few hundred KB) come back.

    State machine identical to ops/swalign.py:_smith_waterman's traceback."""
    import jax
    import jax.numpy as jnp

    S = 2 * d_pad  # every emit moves i or j; non-emit steps only enter E/F

    def traceback(dirs, best, qlens):
        lane = jnp.arange(W, dtype=jnp.int32)[None, :]
        bv = jnp.where(lane <= qlens[:, None], best[:, 0, :], -1)
        score = bv.max(axis=1)
        i0 = jnp.argmax(bv, axis=1).astype(jnp.int32)  # first max: lowest i
        d0 = jnp.take_along_axis(best[:, 1, :], i0[:, None], axis=1)[:, 0]
        j0 = (d0 - i0).astype(jnp.int32)
        dirs_flat = dirs.reshape(B, -1)

        H, E, F = 0, 1, 2

        def step(carry, _):
            i, j, st, done = carry
            alive = (~done) & (i > 0) & (j > 0)
            idx = (i + j) * W + i
            byte = jnp.take_along_axis(
                dirs_flat, idx[:, None].astype(jnp.int32), axis=1
            )[:, 0].astype(jnp.int32)
            hdir = byte & 3
            isH, isE, isF = st == H, st == E, st == F
            stopping = isH & (hdir == 0)
            emit = alive & ~stopping & ((isH & (hdir == 1)) | isE | isF)
            qv = jnp.where(isE, -1, i - 1).astype(jnp.int16)
            rv = jnp.where(isF, -1, j - 1).astype(jnp.int16)
            dec_i = alive & ((isH & (hdir == 1)) | isF)
            dec_j = alive & ((isH & (hdir == 1)) | isE)
            new_st = jnp.where(
                isH,
                jnp.where(hdir == 2, E, jnp.where(hdir == 3, F, H)),
                jnp.where(isE,
                          jnp.where(byte & 4, E, H),
                          jnp.where(byte & 8, F, H)),
            )
            new_done = done | stopping | (i <= 0) | (j <= 0)
            return (
                (jnp.where(dec_i, i - 1, i), jnp.where(dec_j, j - 1, j),
                 jnp.where(alive, new_st, st), new_done),
                (qv, rv, emit),
            )

        init = (i0, j0, jnp.zeros(B, jnp.int32), score <= 0)
        # 8 steps per loop iteration: XLA's GPU while loop pays a fixed
        # cost per iteration, which otherwise dominates this tiny step
        _, (q_steps, r_steps, emits) = jax.lax.scan(step, init, None, length=S,
                                                    unroll=8)
        return score, q_steps, r_steps, emits

    return jax.jit(traceback)


def pad_shape(m_max: int, n_max: int, B_real: int) -> Tuple[int, int, int]:
    """(B, W, n_pad) buckets for a pair batch: the lane axis W >= m_max + 1
    is a power of two (min 128; the kernel's block shape), n_pad a multiple
    of 128 and B a power of two (min 16), so arbitrary lengths reuse a
    handful of compiled shapes.  Padded pairs have zero lengths and produce
    no alignment."""
    W = max(128, 1 << int(m_max).bit_length())
    n_pad = ((max(2, n_max) + 127) // 128) * 128
    B = max(16, 1 << int(np.ceil(np.log2(max(B_real, 1)))))
    return B, W, n_pad


_DP_CACHE = {}
_TB_CACHE = {}


def sw_batch_device(
    qs: List[np.ndarray], rs: List[np.ndarray], scores: MatrixScores,
) -> List[Tuple[int, list, list]]:
    """Align pairs of LETTER_INDEX arrays on device; returns per pair
    (best_score, q_ops, r_ops) like swalign._smith_waterman."""
    return sw_batch_resolve(sw_batch_dispatch(qs, rs, scores))


def sw_batch_dispatch(
    qs: List[np.ndarray], rs: List[np.ndarray], scores: MatrixScores,
):
    """Asynchronously dispatch the device DP + traceback for a pair batch
    and start the device->host copies; sw_batch_resolve finishes.  Split so
    serving can keep collecting search results while a flushed alignment
    batch runs (JAX dispatch is async; the handle holds device arrays)."""
    import jax
    import jax.numpy as jnp

    B_real = len(qs)
    B, W, n_pad = pad_shape(max(len(q) for q in qs),
                            max(len(r) for r in rs), B_real)
    qcodes = np.zeros((B, W - 1), dtype=np.int32)
    rcodes = np.zeros((B, n_pad), dtype=np.int32)
    qlens = np.zeros(B, dtype=np.int32)
    rlens = np.zeros(B, dtype=np.int32)
    for b, (q, r) in enumerate(zip(qs, rs)):
        qcodes[b, : len(q)] = q
        rcodes[b, : len(r)] = r
        qlens[b] = len(q)
        rlens[b] = len(r)

    # the kernel is compiled for the GPU; any other backend interprets it
    interpret = jax.default_backend() != "gpu"
    key = (B, W, n_pad, scores.gap_open, scores.gap_extend, interpret)
    if key not in _DP_CACHE:
        _DP_CACHE[key] = _build_dp(*key)
    qlens_d = jnp.asarray(qlens)
    dirs, best = _DP_CACHE[key](
        jnp.asarray(qcodes), jnp.asarray(rcodes), qlens_d,
        jnp.asarray(rlens), jnp.asarray(scores.sub_matrix, dtype=jnp.int32),
    )

    tkey = (B, W + n_pad, W)
    if tkey not in _TB_CACHE:
        _TB_CACHE[tkey] = _build_traceback(*tkey)
    score_d, q_steps_d, r_steps_d, emits_d = _TB_CACHE[tkey](
        dirs, best, qlens_d)
    for arr in (score_d, q_steps_d, r_steps_d, emits_d):
        arr.copy_to_host_async()
    return (B_real, score_d, q_steps_d, r_steps_d, emits_d)


def sw_batch_resolve(handle) -> List[Tuple[int, list, list]]:
    """Finish a sw_batch_dispatch: fetch the op streams and decode them."""
    import jax

    B_real, score_d, q_steps_d, r_steps_d, emits_d = handle
    score, q_steps, r_steps, emits = jax.device_get(
        (score_d, q_steps_d, r_steps_d, emits_d)
    )

    out = []
    for b in range(B_real):
        s = int(score[b])
        if s <= 0:
            out.append((0, [], []))
            continue
        mask = emits[:, b]
        # steps run from the alignment end backwards; reverse for forward order
        q_ops = q_steps[mask, b][::-1].tolist()
        r_ops = r_steps[mask, b][::-1].tolist()
        out.append((s, q_ops, r_ops))
    return out


def align_pairs(pairs: List[Tuple[str, str]], scores: MatrixScores):
    """String-level convenience wrapper (U->* handled by callers)."""
    qs = [LETTER_INDEX[np.frombuffer(q.encode("latin-1"), np.uint8)]
          for q, _ in pairs]
    rs = [LETTER_INDEX[np.frombuffer(r.encode("latin-1"), np.uint8)]
          for _, r in pairs]
    return sw_batch_device(qs, rs, scores)
