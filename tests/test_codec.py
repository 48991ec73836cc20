import numpy as np
import pytest

from kaamer_jax import codec


def test_pack_layout_known_value():
    # AA indices: A=0, C=1, D=2, E=3, F=4, G=5, H=6
    # pairs: (A,C) = 22 + 0*21 + 1 = 23; (D,E) = 22 + 2*21 + 3 = 67;
    # (F,G) = 22 + 4*21 + 5 = 111; last H = 6
    expected = (23 << 23) | (67 << 14) | (111 << 5) | 6
    assert codec.encode_kmer("ACDEFGH") == expected


def test_roundtrip_all_starts():
    rng = np.random.default_rng(0)
    for _ in range(200):
        kmer = "".join(rng.choice(list(codec.AA_ALPHABET), size=7))
        assert codec.decode_kmer(codec.encode_kmer(kmer)) == kmer


def test_vectorized_matches_scalar():
    rng = np.random.default_rng(1)
    seq = "".join(rng.choice(list(codec.AA_ALPHABET), size=100))
    codes = codec.seq_to_codes(seq)
    vec = codec.encode_kmers(codes)
    assert len(vec) == 94
    for i in range(94):
        assert int(vec[i]) == codec.encode_kmer(seq[i : i + 7])


def test_invalid_chars_fallback():
    # Unknown pair encodes 0; unknown last char encodes 0 (aliasing 'A'),
    # matching the Go map zero-value quirk (k_store.go:103,110).
    v_bad_pair = codec.encode_kmer("XZDEFGH")
    v_ref = codec.encode_kmer("AADEFGH")  # pair (A,A)=22 differs
    assert (v_bad_pair >> 23) == 0
    assert (v_ref >> 23) == 22
    assert (v_bad_pair & 0x7FFFFF) == (v_ref & 0x7FFFFF)
    assert codec.encode_kmer("ACDEFGX") == codec.encode_kmer("ACDEFGA")


def test_u_selenocysteine_in_alphabet():
    assert "U" in codec.AA_ALPHABET
    v = codec.encode_kmer("UUUUUUU")
    assert codec.decode_kmer(v) == "UUUUUUU"


def test_empty_kmer_sentinel_unreachable():
    # max pair code 22 + 20*21 + 20 = 462 < 512; max last = 20 < 31
    max_code = codec.encode_kmer("YYYYYYY")
    assert max_code < 0xFFFFFFFF
    assert (max_code >> 23) == 462


def test_query_num_kmers():
    assert codec.query_num_kmers("A" * 10) == 4
    assert codec.query_num_kmers("A" * 9 + "*") == 3


def test_jnp_encode_matches_numpy():
    import jax.numpy as jnp

    rng = np.random.default_rng(2)
    seq = "".join(rng.choice(list(codec.AA_ALPHABET), size=64))
    codes = codec.seq_to_codes(seq)
    n = len(seq) - 6
    dev = np.asarray(codec.encode_kmers_jnp(jnp.asarray(codes), n))
    host = codec.encode_kmers(codes)
    np.testing.assert_array_equal(dev, host)


def test_pack_codes3_roundtrip():
    """Wire packing (3 residues/uint16) roundtrips through the device unpack
    for every width mod 3, including -1 padding and unknown chars."""
    import numpy as np
    from kaamer_jax import codec

    rng = np.random.default_rng(5)
    for width in (1, 2, 3, 7, 62, 63, 64, 262):
        codes = rng.integers(-1, codec.N_AA, size=(4, width)).astype(np.int8)
        packed = codec.pack_codes3(codes)
        assert packed.dtype == np.uint16
        assert packed.shape == (4, -(-width // 3))
        out = np.asarray(codec.unpack_codes3_jnp(packed, width))
        assert out.shape == (4, width)
        assert np.array_equal(out, codes.astype(np.int32)), width


def test_pack_codes7_roundtrip():
    """Serving wire packing (7 residues/uint32, base-22) roundtrips through
    the device unpack for every width mod 7, including the extreme words
    (all code 21 -> 22^7 - 1, near the uint32 limit)."""
    import numpy as np
    from kaamer_jax import codec

    rng = np.random.default_rng(6)
    for width in (1, 6, 7, 8, 62, 63, 64, 262):
        codes = rng.integers(-1, codec.N_AA, size=(4, width)).astype(np.int8)
        codes[0, :] = codec.N_AA - 1   # max residue everywhere
        codes[1, :] = -1               # all padding (packs to 22^7 - 1)
        packed = codec.pack_codes7(codes)
        assert packed.dtype == np.uint32
        assert packed.shape == (4, -(-width // 7))
        out = np.asarray(codec.unpack_codes7_jnp(packed, width))
        assert out.shape == (4, width)
        assert np.array_equal(out, codes.astype(np.int32)), width


def test_pad_codes_batch_matches_scalar():
    import numpy as np
    from kaamer_jax import codec

    seqs = ["ACDEFGH", "", "MKTAYIAKQRQISFVKSHFSRQ", "XX*1aC", "Y" * 300]
    width = 40
    got = codec.pad_codes_batch(seqs, width)
    for i, s in enumerate(seqs):
        want = np.full(width, -1, dtype=np.int8)
        c = codec.seq_to_codes(s)[:width]
        want[: c.shape[0]] = c
        assert np.array_equal(got[i], want), s
