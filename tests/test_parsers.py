import gzip
import textwrap

import pytest

from kaamer_jax.io_formats.readers import (
    parse_embl,
    parse_fasta,
    parse_gbk,
    parse_tsv,
    read_fasta_queries,
    read_fastq_queries,
)

EMBL_ENTRY = """\
ID   BLAN1_KLEPN             Reviewed;         270 AA.
AC   C7C422;
DE   RecName: Full=Metallo-beta-lactamase type 2 {ECO:0000305};
DE            EC=3.5.2.6 {ECO:0000269|PubMed:19770275};
DE   AltName: Full=Beta-lactamase NDM-1;
GN   Name=blaNDM-1 {ECO:0000303|PubMed:19770275};
OS   Klebsiella pneumoniae.
OC   Bacteria; Proteobacteria; Gammaproteobacteria; Enterobacterales;
OC   Enterobacteriaceae; Klebsiella.
OX   NCBI_TaxID=573 {ECO:0000312|EMBL:CAZ39946.1};
DR   KEGG; ag:CAZ39946; -.
DR   GO; GO:0042597; C:periplasmic space; IEA:UniProtKB-SubCell.
DR   GO; GO:0008800; F:beta-lactamase activity; IEA:UniProtKB-EC.
DR   HAMAP; MF_01234; Test; 1.
DR   BioCyc; MetaCyc:MONOMER-16305; -.
SQ   SEQUENCE   270 AA;  28458 MW;  5CB4B2A66F3475C2 CRC64;
     MELPNIMHPV AKLSTALAAA LMLSGCMPGE IRPTIGQQME TGDQRFGDLV FRQLAPNVWQ
     HTSYLDMPGF GAVASNGLIV RDGGRVLVVD TAWTDDQTAQ ILNWIKQEIN LPVALAVVTH
     AHQDKMGGMD ALHAAGIATY ANALSNQLAP QEGMVAAQHS LTFAANGWVE PATAPNFGPL
     KVFYPGPGHT SDNITVGIDG TDIAFGGCLI KDSKAKSLGN LGDADTEHYA ASARAFGAAF
     PKASMIVMSH SAPDSRAAIT HTARMADKLR
//
"""

EMBL_FRAGMENT = """\
ID   FRAG_TEST               Unreviewed;       50 AA.
DE   SubName: Full=Some fragment;
DE   Flags: Fragment;
SQ   SEQUENCE   50 AA;  5000 MW;  ABCDEF CRC64;
     MELPNIMHPV AKLSTALAAA LMLSGCMPGE IRPTIGQQME TGDQRFGDLV
//
"""


def test_parse_embl(tmp_path):
    f = tmp_path / "test.dat"
    f.write_text(EMBL_ENTRY + EMBL_FRAGMENT)
    entries = list(parse_embl(str(f)))
    # fragment skipped (inputEMBL.go:224-227)
    assert len(entries) == 1
    pid, prot = entries[0]
    assert pid == 1
    assert prot.EntryId == "BLAN1_KLEPN"
    assert prot.Length == 270
    assert len(prot.Sequence) == 270
    assert prot.Sequence.startswith("MELPNIMHPV")
    fts = prot.Features
    assert fts["ProteinName"] == "Metallo-beta-lactamase type 2"
    assert fts["EC"] == "3.5.2.6"
    assert fts["GeneName"] == "blaNDM-1"
    assert fts["Organism"] == "Klebsiella pneumoniae"
    assert fts["TaxId"] == "573"
    assert fts["KEGG_ID"] == "ag:CAZ39946"
    assert fts["GO"] == "GO:0042597;GO:0008800"
    assert fts["HAMAP"] == "MF_01234"
    assert fts["BioCyc_ID"] == "MetaCyc:MONOMER-16305"
    assert "Bacteria; Proteobacteria" in fts["FullTaxonomy"]


GBK_ENTRY = """\
LOCUS       WP_000000001             45 aa            linear   BCT 01-JAN-2019
DEFINITION  class B metallo-beta-lactamase NDM-1 [Klebsiella pneumoniae].
ACCESSION   WP_000000001
VERSION     WP_000000001.1
KEYWORDS    RefSeq.
SOURCE      Klebsiella pneumoniae
  ORGANISM  Klebsiella pneumoniae
            Bacteria; Proteobacteria; Gammaproteobacteria; Enterobacterales;
            Enterobacteriaceae; Klebsiella.
FEATURES             Location/Qualifiers
     source          1..45
                     /organism="Klebsiella pneumoniae"
ORIGIN
        1 melpnimhpv aklstalaaa lmlsgcmpge irptigqqme tgdqr
//
"""


def test_parse_gbk(tmp_path):
    f = tmp_path / "test.gbk"
    f.write_text(GBK_ENTRY)
    entries = list(parse_gbk(str(f)))
    assert len(entries) == 1
    pid, prot = entries[0]
    assert pid == 1
    assert prot.EntryId == "WP_000000001.1"
    assert prot.Sequence == "MELPNIMHPVAKLSTALAAALMLSGCMPGEIRPTIGQQMETGDQR"
    assert prot.Length == 45
    assert "metallo-beta-lactamase" in prot.Features["ProteinName"]
    assert prot.Features["Organism"] == "Klebsiella pneumoniae"
    assert "Enterobacteriaceae" in prot.Features["FullTaxonomy"]


def test_parse_tsv(tmp_path):
    f = tmp_path / "test.tsv"
    f.write_text(
        "EntryID\tOrganism\tSequence\n"
        "P1\tE. coli\tMELPNIMHPVAKLSTAL\n"
        "P2\tE. coli\tSHORT\n"          # dropped: < 7 aa
        "P3\t\tMELPNIMHPVAKLSTALAAA\n"
    )
    entries = list(parse_tsv(str(f)))
    assert [(pid, p.EntryId) for pid, p in entries] == [(0, "P1"), (1, "P3")]
    assert entries[0][1].Features == {"Organism": "E. coli"}


def test_parse_fasta_gzip(tmp_path):
    f = tmp_path / "test.fasta.gz"
    with gzip.open(f, "wt") as g:
        g.write(">A1 first protein\nMELPNIMHPV\n>A2 x, partial\nMELPNIMHPV\n>A3\nMEL\n>A4 ok\nMELPNIMHPVA\n")
    entries = list(parse_fasta(str(f)))
    # A2 (partial) and A3 (short) skipped; ids keep file order
    assert [(pid, p.EntryId) for pid, p in entries] == [(1, "A1"), (4, "A4")]


def test_parse_fasta_offset_length(tmp_path):
    f = tmp_path / "t.fasta"
    f.write_text("".join(f">P{i}\nMELPNIMHPV\n" for i in range(1, 8)))
    entries = list(parse_fasta(str(f), offset=3, length=2))
    assert [p.EntryId for _, p in entries] == ["P3", "P4"]


def test_fastq_reader(tmp_path):
    f = tmp_path / "reads.fq"
    f.write_text(
        "@read1\nATGCATGCATGCATGCATGCA\n+\nIIIIIIIIIIIIIIIIIIIII\n"
        "@read2\nATGCATGCATGCATG\n+\nIIIIIIIIIIIIIII\n"
    )
    reads = list(read_fastq_queries(str(f)))
    assert [r.Name for r in reads] == ["read1", "read2"]
    assert reads[0].SizeInKmer == 15
    assert reads[1].Sequence == "ATGCATGCATGCATG"


def test_fasta_query_reader_star(tmp_path):
    f = tmp_path / "q.fasta"
    f.write_text(">q one two\nMELPNIMHPV*\n")
    (q,) = list(read_fasta_queries(str(f), is_protein=True))
    assert q.Name == "q one two"
    assert q.SizeInKmer == 4  # 11 - 7 + 1 - 1 (trailing '*')
    assert q.Location.EndPosition == 11
