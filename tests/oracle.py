"""Dict-based oracle: a deliberately naive reimplementation of the reference
search semantics (build: inputFASTA.go:245-248 + indexdb.go:92-132; search:
search.go:414-440) used for differential testing of the vectorized engine."""

from __future__ import annotations

from typing import Dict, List, Tuple

from kaamer_jax.codec import encode_kmer
from kaamer_jax.records import Protein

KMER_SIZE = 7


class OracleDB:
    def __init__(self, entries: List[Tuple[int, Protein]]):
        self.proteins: Dict[int, Protein] = dict(entries)
        self.index: Dict[int, set] = {}
        for pid, p in entries:
            for i in range(len(p.Sequence) - KMER_SIZE + 1):
                code = encode_kmer(p.Sequence[i : i + KMER_SIZE])
                self.index.setdefault(code, set()).add(pid)

    def kmer_search(self, seq: str, size_in_kmer: int):
        """Returns (hits, positions): hits sorted by count desc then id asc."""
        counts: Dict[int, int] = {}
        positions: Dict[int, List[bool]] = {}
        for k in range(size_in_kmer):
            ids = self.index.get(encode_kmer(seq[k : k + KMER_SIZE]))
            if ids:
                for pid in ids:
                    counts[pid] = counts.get(pid, 0) + 1
                    positions.setdefault(pid, [False] * size_in_kmer)[k] = True
        hits = sorted(counts.items(), key=lambda kv: (-kv[1], kv[0]))
        return hits, positions

    @staticmethod
    def filter_hits(hits, size_in_kmer, min_kratio, min_kmatch, max_results):
        """FilterResults semantics (search.go:189-220)."""
        kept = []
        for pid, c in hits:
            if (c / size_in_kmer) < min_kratio or c < min_kmatch:
                break
            kept.append((pid, c))
        return kept[:max_results]
