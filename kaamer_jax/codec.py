"""The kAAmer 7-mer <-> uint32 codec, vectorized.

Semantics match the reference Go codec exactly (reference
pkg/kvstore/k_store.go:39-145):

- Alphabet: 21 amino acids INCLUDING selenocysteine 'U':
  A C D E F G H I K L M N P Q R S T U V W Y  (k_store.go:41).
- A 7-mer packs into exactly 32 bits as three amino-acid *pairs* at 9 bits
  each plus the last single residue at 5 bits:
      bits 31-23 : pair(aa0, aa1)   code = 22 + idx(aa0)*21 + idx(aa1)
      bits 22-14 : pair(aa2, aa3)
      bits 13-5  : pair(aa4, aa5)
      bits  4-0  : idx(aa6)         codes 0..20
  (pair codes start at 22, k_store.go:46-60; shifts at k_store.go:91-117;
  decode masks at k_store.go:123-126).
- Quirk preserved: a pair containing a character outside the alphabet encodes
  as 0 (Go zero-value for a missing map key) and an invalid final residue
  encodes as 0 (aliasing 'A').  Both the DB build and the query path use the
  same fallback, exactly like the reference, so lookups stay consistent.

Everything here is vectorized numpy (host) or jax.numpy (device); the scalar
helpers exist for tests and debugging only.
"""

from __future__ import annotations

import numpy as np

KMER_SIZE = 7
AA_ALPHABET = "ACDEFGHIKLMNPQRSTUVWY"  # 21 symbols, k_store.go:41
N_AA = len(AA_ALPHABET)

# 0xFFFFFFFF can never be produced by the encoder (max pair code 462 < 512 and
# max last code 20 < 31), so it is safe as an "empty slot" / padding sentinel.
EMPTY_KMER = np.uint32(0xFFFFFFFF)

# byte value -> residue index 0..20, or -1 if not in the alphabet
CHAR_TO_CODE = np.full(256, -1, dtype=np.int32)
for _i, _c in enumerate(AA_ALPHABET):
    CHAR_TO_CODE[ord(_c)] = _i


CHAR_TO_CODE_I8 = CHAR_TO_CODE.astype(np.int8)


def seq_to_codes(seq: str) -> np.ndarray:
    """Residue indices (int32, -1 for unknown chars) for an ASCII sequence."""
    raw = np.frombuffer(seq.encode("latin-1"), dtype=np.uint8)
    return CHAR_TO_CODE[raw]


def pad_codes_batch(seqs, width: int) -> np.ndarray:
    """Residue-code matrix int8[B, width] for a batch of sequences, padded
    with -1.  One joined buffer + LUT + boolean-mask assignment instead of a
    Python per-string loop; the mask form avoids the index-vector np.repeat
    construction, which dominated host time at large batches (~9us/query)."""
    B = len(seqs)
    out = np.full((B, width), -1, dtype=np.int8)
    if B == 0:
        return out
    clipped = [s[:width] for s in seqs]
    buf = "".join(clipped).encode("latin-1")
    lens = np.fromiter((len(s) for s in clipped), count=B, dtype=np.int64)
    raw = np.frombuffer(buf, dtype=np.uint8)
    if raw.size == 0:
        return out
    codes = CHAR_TO_CODE_I8[raw]
    # row-major boolean mask selects, per row in order, exactly the first
    # lens[b] slots -- matching the concatenation layout of `codes`
    mask = np.arange(width, dtype=np.int64)[None, :] < lens[:, None]
    out[mask] = codes
    return out


def _pair_code(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Pair code 22 + a*21 + b, or 0 when either residue is invalid."""
    valid = (a >= 0) & (b >= 0)
    return np.where(valid, 22 + a * N_AA + b, 0).astype(np.uint32)


def _single_code(c: np.ndarray) -> np.ndarray:
    return np.where(c >= 0, c, 0).astype(np.uint32)


def encode_kmers(codes: np.ndarray) -> np.ndarray:
    """All sliding-window 7-mer codes of a residue-index array.

    codes: int32[L] (from seq_to_codes). Returns uint32[max(L-6, 0)].
    Vectorized equivalent of the reference's per-window EncodeKmer loop
    (inputFASTA.go:245-248 + k_store.go:91-117).
    """
    L = codes.shape[0]
    n = L - KMER_SIZE + 1
    if n <= 0:
        return np.empty(0, dtype=np.uint32)
    p1 = _pair_code(codes[0:n], codes[1 : n + 1])
    p2 = _pair_code(codes[2 : n + 2], codes[3 : n + 3])
    p3 = _pair_code(codes[4 : n + 4], codes[5 : n + 5])
    last = _single_code(codes[6 : n + 6])
    return (p1 << 23) | (p2 << 14) | (p3 << 5) | last


def encode_kmers_batch(codes: np.ndarray) -> np.ndarray:
    """encode_kmers over a batch: int32[B, L+6] -> uint32[B, L]."""
    L = codes.shape[1] - KMER_SIZE + 1
    p1 = _pair_code(codes[:, 0:L], codes[:, 1 : L + 1])
    p2 = _pair_code(codes[:, 2 : L + 2], codes[:, 3 : L + 3])
    p3 = _pair_code(codes[:, 4 : L + 4], codes[:, 5 : L + 5])
    last = _single_code(codes[:, 6 : L + 6])
    return (p1 << 23) | (p2 << 14) | (p3 << 5) | last


def encode_kmer(kmer: str) -> int:
    """Scalar encode of one 7-mer (tests/debug only)."""
    assert len(kmer) == KMER_SIZE
    return int(encode_kmers(seq_to_codes(kmer))[0])


def decode_kmer(value: int) -> str:
    """Inverse of encode_kmer for valid codes (k_store.go:120-145)."""
    aa = (value >> 23) & 0x1FF
    bb = (value >> 14) & 0x1FF
    cc = (value >> 5) & 0x1FF
    dd = value & 0x1F

    def pair(code: int) -> str:
        if code < 22:
            return "??"
        code -= 22
        return AA_ALPHABET[code // N_AA] + AA_ALPHABET[code % N_AA]

    return pair(aa) + pair(bb) + pair(cc) + AA_ALPHABET[dd]


def query_num_kmers(seq: str) -> int:
    """SizeInKmer of a query: L-6, minus one if the sequence ends with '*'
    (reference search.go:290-293)."""
    n = len(seq) - KMER_SIZE + 1
    if seq.endswith("*"):
        n -= 1
    return n


# ---------------------------------------------------------------------------
# Wire packing for host->device query upload: the query matrix is packed
# base-22 (21 residues + 1 in-band pad code) and unpacked on device:
#   pack_codes3: 3 residues/uint16 (22^3 = 10648 < 2^16)  -- 5.33 bits/residue
#   pack_codes7: 7 residues/uint32 (22^7 ~ 2.49e9 < 2^32) -- 4.57 bits/residue
# pack_codes7 is the serving wire format; pack_codes3 is kept for tests and
# as the simpler reference packing.
# ---------------------------------------------------------------------------

PAD3 = 21  # in-band padding residue for the packed wire format


def pack_codes3(codes: np.ndarray) -> np.ndarray:
    """int8[B, W] residue codes (-1 = pad) -> uint16[B, ceil(W/3)]."""
    B, W = codes.shape
    W3 = -(-W // 3) * 3
    c = np.full((B, W3), PAD3, dtype=np.uint16)
    c[:, :W] = np.where(codes >= 0, codes, PAD3).astype(np.uint16)
    c = c.reshape(B, W3 // 3, 3)
    return c[:, :, 0] * 484 + c[:, :, 1] * 22 + c[:, :, 2]


def unpack_codes3_jnp(packed, width: int):
    """Device inverse of pack_codes3: uint16[B, ceil(W/3)] -> int32[B, width]."""
    import jax.numpy as jnp

    p = packed.astype(jnp.int32)
    d = jnp.stack([p // 484, (p // 22) % 22, p % 22], axis=-1)
    c = d.reshape(p.shape[0], -1)[:, :width]
    return jnp.where(c == PAD3, -1, c)


def pack_codes7(codes: np.ndarray) -> np.ndarray:
    """int8[B, W] residue codes (-1 = pad) -> uint32[B, ceil(W/7)].

    Base-22 positional packing, most-significant residue first:
    word = sum_i c[i] * 22^(6-i); max value 22^7 - 1 < 2^32, and every
    partial product stays below 2^32, so the whole accumulation runs in
    uint32 (u64 temporaries tripled the host cost of this hot function)."""
    B, W = codes.shape
    W7 = -(-W // 7) * 7
    c = np.full((B, W7), PAD3, dtype=np.uint32)
    np.copyto(c[:, :W], codes, casting="unsafe", where=codes >= 0)
    out = c[:, 0::7] * np.uint32(22**6)
    for i in range(1, 7):
        w = np.uint32(22 ** (6 - i))
        if w == 1:
            out += c[:, i::7]
        else:
            out += c[:, i::7] * w
    return out


def unpack_codes7_jnp(packed, width: int):
    """Device inverse of pack_codes7: uint32[B, ceil(W/7)] -> int32[B, width].

    Division by powers of 22 is exact unsigned 32-bit arithmetic (values stay
    below 2^32); XLA lowers the constant divisions to multiply-high."""
    import jax.numpy as jnp

    p = packed.astype(jnp.uint32)
    digits = []
    for k in range(6, 0, -1):
        d = p // np.uint32(22**k)
        digits.append(d % np.uint32(22) if k < 6 else d)
        # (the first quotient is already < 22; later ones need the mod)
    digits.append(p % np.uint32(22))
    c = jnp.stack(digits, axis=-1).astype(jnp.int32)
    c = c.reshape(p.shape[0], -1)[:, :width]
    return jnp.where(c == PAD3, -1, c)


# ---------------------------------------------------------------------------
# Device-side encoding (jax.numpy) -- same semantics as encode_kmers, for use
# inside jit when query batches are encoded on device.
# ---------------------------------------------------------------------------


def encode_kmers_jnp(codes, n_kmers: int):
    """codes: int32[L] device array; returns uint32[n_kmers] (static length).

    Caller is responsible for masking windows that fall past the true
    sequence length (padding residues should be -1 so they encode via the
    0-fallback; the mask, not the value, decides validity).
    """
    import jax.numpy as jnp

    def pair(a, b):
        valid = (a >= 0) & (b >= 0)
        return jnp.where(valid, 22 + a * N_AA + b, 0).astype(jnp.uint32)

    n = n_kmers
    p1 = pair(codes[0:n], codes[1 : n + 1])
    p2 = pair(codes[2 : n + 2], codes[3 : n + 3])
    p3 = pair(codes[4 : n + 4], codes[5 : n + 5])
    last = jnp.where(codes[6 : n + 6] >= 0, codes[6 : n + 6], 0).astype(jnp.uint32)
    return (p1 << 23) | (p2 << 14) | (p3 << 5) | last
