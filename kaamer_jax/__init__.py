"""kaamer-jax: a protein identification engine on an accelerator.

A from-scratch JAX/XLA re-design of the capabilities of zorino/kaamer:
exact k-mer search of protein and 6-frame
translated nucleotide queries against a kmerized protein database, with
optional Smith-Waterman alignment refinement.

Architecture (a re-design, not a port):

- The reference's Badger LSM-tree KV store (reference pkg/kvstore) is replaced
  by an immutable flat-array index: an open-addressing hash table mapping
  32-bit k-mer codes to protein-set ids, plus CSR postings arrays, all
  memory-mapped from disk and resident in device memory at serve time.
- The reference's per-k-mer pointer-chase hot loop (search.go:414-440) becomes
  a batched, static-shaped device pipeline: vectorized hash probe -> CSR
  postings gather -> per-query sort + run-length-encode -> lax.top_k.
- The reference's goroutine worker pools become data-parallel query batches
  over a jax.sharding.Mesh, with the index optionally sharded by k-mer hash
  across devices (shard_map + collectives).
"""

__version__ = "0.1.0"

KMER_SIZE = 7  # fixed, as in reference (makedb.go:30, search.go:45)
