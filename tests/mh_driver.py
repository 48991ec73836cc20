"""Subprocess driver for test_multihost.py: one process of a 2-process
jax.distributed job over CPU devices.

Reads KAAMER_COORDINATOR / KAAMER_NUM_PROCESSES / KAAMER_PROCESS_ID from the
environment (the init_distributed env-var contract, parallel/dist.py),
builds the global (dp, shard) mesh, asserts the dp axis spans processes,
runs one whole-batch sharded search step on deterministic synthetic inputs,
and dumps THIS process's addressable output rows to an .npz for the parent
to check against its single-process reference run.

Usage: python mh_driver.py <out.npz>
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 4)

from kaamer_jax.parallel.dist import init_distributed, global_mesh

init_distributed()  # env-var path: KAAMER_COORDINATOR / NUM_PROCESSES / ID
assert jax.process_count() == 2, jax.process_count()
assert jax.local_device_count() == 4 and jax.device_count() == 8

mesh = global_mesh()  # shard axis = local devices, dp spans processes
devs = np.asarray(mesh.devices)
assert devs.shape == (2, 4), devs.shape
row_procs = [sorted({d.process_index for d in row}) for row in devs]
# each dp row lives on ONE process; the dp axis crosses the process boundary
assert row_procs[0] != row_procs[1] and all(len(r) == 1 for r in row_procs), \
    row_procs

from jax.sharding import NamedSharding, PartitionSpec as P

from __graft_entry__ import _query_arrays, _synthetic_index
from kaamer_jax.parallel.mesh import make_sharded_search, shard_index_arrays

ht, set_offsets, postings, seqs = _synthetic_index()
sharded = shard_index_arrays(ht.table, set_offsets, postings, n_shards=4)

B, L, CAP, K = 16, 64, 1024, 16
codes, n_kmers = _query_arrays(seqs, B, L)


def garr(arr, spec):
    return jax.make_array_from_callback(
        arr.shape, NamedSharding(mesh, spec), lambda idx: arr[idx])


fn = make_sharded_search(mesh, sharded.hash_log2, cap=CAP, k=K)
counts, hit_rows, totals = fn(
    garr(sharded.tables, P("shard", None, None)),
    garr(sharded.postings, P("shard", None)),
    garr(codes, P("dp", None)),
    garr(n_kmers, P("dp")),
)

rows_idx, c_parts, h_parts = [], [], []
for sh in counts.addressable_shards:
    rows_idx.append(sh.index[0].start or 0)
    c_parts.append(np.asarray(sh.data))
for sh in hit_rows.addressable_shards:
    h_parts.append(np.asarray(sh.data))

np.savez(sys.argv[1],
         process_index=jax.process_index(),
         row_starts=np.asarray(rows_idx),
         counts=np.stack(c_parts),
         hit_rows=np.stack(h_parts))
print(f"p{jax.process_index()} OK", flush=True)
