import numpy as np

from kaamer_jax.search.orf import get_orfs, get_frame, reverse_complement

# codon map for building test genes (table 11)
CODON = {
    "M": "atg", "A": "gct", "C": "tgt", "D": "gat", "E": "gaa", "F": "ttt",
    "G": "ggt", "H": "cat", "I": "atc", "K": "aaa", "L": "cta", "N": "aat",
    "P": "cct", "Q": "caa", "R": "cgt", "S": "tct", "T": "act", "V": "gta",
    "W": "tgg", "Y": "tat",
}


def encode_protein(prot: str) -> str:
    return "".join(CODON[a] for a in prot)


def test_reverse_complement():
    assert reverse_complement("atgc") == "gcat"
    assert reverse_complement("AATT") == "aatt"


def test_get_frame_truncates_to_codons():
    assert get_frame(1, "atgcatg") == "atgcat"
    assert get_frame(2, "atgcatg") == "tgcatg"
    assert get_frame(3, "atgcatg") == "gca"


def test_simple_plus_strand_orf():
    prot = "MAKVLDEGHTRWYQNSPICF" + "AAKL"  # 24 aa incl leading M
    gene = "taa" + encode_protein(prot) + "taa"
    orfs = get_orfs(gene, 11)
    seqs = [o.Sequence for o in orfs]
    match = [o for o in orfs if o.Sequence == prot + "*"]
    assert match, seqs
    orf = match[0]
    assert orf.Location.PlusStrand
    # ORF starts right after the leading stop (1-based 4), ends at the last
    # base of the trailing stop codon
    assert orf.Location.StartPosition == 4
    assert orf.Location.EndPosition == len(gene)
    assert orf.Location.StartsAlternative[0] == 0


def test_minus_strand_orf():
    prot = "MAKVLDEGHTRWYQNSPICF" + "AAKL"
    plus_gene = "taa" + encode_protein(prot) + "taa"
    gene = reverse_complement(plus_gene)
    orfs = get_orfs(gene, 11)
    match = [o for o in orfs if o.Sequence == prot + "*"]
    assert match
    orf = match[0]
    assert not orf.Location.PlusStrand
    # minus-strand coordinates: Start > End, mapping back to the plus gene
    assert orf.Location.StartPosition == len(gene) - 3
    assert orf.Location.EndPosition == 1


def test_alternative_starts_recorded():
    # two in-frame atg: alt starts at aa 0 and 3 (no I elsewhere -- our helper
    # encodes I as atc, itself a table-11 start codon)
    prot = "MKVMAKVLDEGHTRWYQNSPCFA"
    gene = "tag" + encode_protein(prot) + "tga"
    orfs = get_orfs(gene, 11)
    match = [o for o in orfs if o.Sequence == prot + "*"]
    assert match
    assert match[0].Location.StartsAlternative == [0, 3]


def test_short_orfs_dropped():
    gene = "taa" + encode_protein("MAKVL") + "taa"  # 5 aa < 21
    orfs = get_orfs(gene, 11)
    assert all("MAKVL" + "*" != o.Sequence for o in orfs)


def test_orfs_sorted_by_position():
    p1 = "MAKVLDEGHTRWYQNSPICFAAKL"
    p2 = "MHTRWYQNSPICFAKVLDEGAAKL"
    gene = "taa" + encode_protein(p1) + "taataa" + encode_protein(p2) + "taa"
    orfs = get_orfs(gene, 11)
    keyed = [
        o.Location.EndPosition if o.Location.PlusStrand else o.Location.StartPosition
        for o in orfs
    ]
    assert keyed == sorted(keyed)


def test_native_orf_scan_matches_python():
    """The native kt_get_orfs scanner must replicate _get_orfs_py exactly
    (sequences, coordinates, strands, StartsAlternative, ordering)."""
    import numpy as np
    from kaamer_jax import native
    from kaamer_jax.search.orf import _get_orfs_py, get_orfs_batch

    if not native.available():
        import pytest
        pytest.skip("native library unavailable")

    rng = np.random.default_rng(11)
    bases = np.array(list("acgt"))
    seqs = []
    for L in [0, 1, 2, 3, 62, 63, 64, 65, 150, 151, 152, 300, 1000, 5000]:
        seqs.append("".join(rng.choice(bases, size=L)))
    # mixed case + ambiguous bases + a known multi-ORF construct
    seqs.append("ATGaaaNNNtttTAGatg" + "gca" * 30 + "taa")
    seqs.append("atg" + "aaa" * 25 + "tag" + "ccc" * 10 + "atg" + "ggg" * 30)
    for gcode in (11, 1, 4):
        batch = get_orfs_batch(seqs, gcode)
        assert batch is not None
        for s, got in zip(seqs, batch):
            want = _get_orfs_py(s, gcode)
            assert len(got) == len(want), (gcode, s[:40])
            for a, b in zip(got, want):
                assert a.Sequence == b.Sequence
                assert a.Location.StartPosition == b.Location.StartPosition
                assert a.Location.EndPosition == b.Location.EndPosition
                assert a.Location.PlusStrand == b.Location.PlusStrand
                assert a.Location.StartsAlternative == b.Location.StartsAlternative
