"""Native C++ kernels vs numpy reference implementations."""

import numpy as np
import pytest

from kaamer_jax import codec, native


@pytest.fixture(scope="module")
def lib_available():
    if not native.available():
        pytest.skip("native toolchain unavailable")


def test_extract_pairs_matches_codec(lib_available):
    rng = np.random.default_rng(0)
    aa = list(codec.AA_ALPHABET) + ["X"]  # include invalid chars
    seqs = ["".join(rng.choice(aa, size=int(rng.integers(3, 200))))
            for _ in range(100)]
    buf = np.frombuffer("".join(seqs).encode(), dtype=np.uint8)
    offs = np.zeros(len(seqs) + 1, dtype=np.int64)
    np.cumsum([len(s) for s in seqs], out=offs[1:])

    got = native.extract_pairs(buf, offs, row_base=7)

    expected = []
    for i, s in enumerate(seqs):
        kmers = codec.encode_kmers(codec.seq_to_codes(s))
        expected.append((kmers.astype(np.uint64) << np.uint64(32))
                        | np.uint64(7 + i))
    want = np.concatenate(expected)
    np.testing.assert_array_equal(got, want)


def test_sort_u64(lib_available):
    rng = np.random.default_rng(1)
    arr = rng.integers(0, 2**63, size=300_000, dtype=np.uint64)
    want = np.sort(arr.copy())
    got = native.sort_u64(arr.copy())
    np.testing.assert_array_equal(got, want)


def test_parse_fasta_bytes(lib_available):
    data = (b">P1 first protein\nMELPni mhpv\nAKLS\n"
            b">P2 second\r\nMELPNIM\n\n>P3\nMEL\n")
    out = native.parse_fasta_bytes(data)
    assert out is not None
    seq_buf, seq_off, headers = out
    assert headers == ["P1 first protein", "P2 second", "P3"]
    seqs = [bytes(seq_buf[seq_off[i]:seq_off[i + 1]]).decode()
            for i in range(3)]
    assert seqs == ["MELPNIMHPVAKLS", "MELPNIM", "MEL"]


def test_build_uses_native_and_matches(lib_available, tmp_path):
    from kaamer_jax.index.build import build_db
    from kaamer_jax.index.artifact import load_db

    rng = np.random.default_rng(2)
    fa = tmp_path / "in.fasta"
    with open(fa, "w") as f:
        for i in range(50):
            s = "".join(rng.choice(list(codec.AA_ALPHABET), size=80))
            f.write(f">Q{i}\n{s}\n")
    build_db(str(tmp_path / "db"), str(fa), "fasta")
    art = load_db(str(tmp_path / "db"))
    assert art.stats.NumberOfProteins == 50


def test_pack_queries_matches_python_path():
    """kt_pack_queries must reproduce pad_codes_batch + pack_codes7 exactly,
    including invalid characters, clipping, and empty sequences."""
    from kaamer_jax import codec, native

    if not native.available():
        import pytest

        pytest.skip("native library unavailable")
    rng = np.random.default_rng(4)
    aa = list("ACDEFGHIKLMNPQRSTUVWYxz*-")
    for width in (7, 8, 62, 64, 262):
        seqs = ["".join(rng.choice(aa, size=int(rng.integers(0, width + 30))))
                for _ in range(17)] + [""]
        want = codec.pack_codes7(codec.pad_codes_batch(seqs, width))
        got = native.pack_queries(seqs, width)
        assert np.array_equal(got, want), width
