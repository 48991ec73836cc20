"""Measure the CPU stand-in baseline (scripts/cpu_baseline.cpp) on the
skewed 10k bench database and record CPU_BASELINE_r{N}.json.

The reference publishes no queries/s and this image has no Go toolchain,
so bench.py's vs_baseline multiplier needs a MEASURED denominator.  The
stand-in replicates the reference hot-loop shape (search.go:421-436) as an
in-memory hash map + per-posting counter loop -- strictly faster than
Go/Badger (no LSM reads, no protobuf unmarshal, no HTTP), so the resulting
queries/s is a conservative upper bound on the reference and the
multiplier a lower bound.

Run: python scripts/cpu_baseline.py [round=5] [threads=2]
"""

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import jax

jax.config.update("jax_platforms", "cpu")

from bench import (CACHE_ROOT, QUERY_LEN, build_skewed_db, ensure_db,
                   make_queries)
from kaamer_jax import codec

ROUND = int(sys.argv[1]) if len(sys.argv) > 1 else 5
THREADS = int(sys.argv[2]) if len(sys.argv) > 2 else os.cpu_count() or 2

exe = os.path.join(tempfile.gettempdir(), "kaamer_cpu_baseline")
src = os.path.join(REPO, "scripts", "cpu_baseline.cpp")
subprocess.run(["g++", "-O3", "-march=native", "-pthread", "-o", exe, src],
               check=True)


def measure(n_proteins: int, n_queries: int, reps: int = 3) -> dict:
    art = ensure_db(os.path.join(CACHE_ROOT, f"skew_{n_proteins}"),
                    build_skewed_db, n_proteins)
    # (kmer, start, len) triples straight out of the serving cuckoo table
    # ([k0,s0,l0,k1,s1,l1] rows, EMPTY=0xFFFFFFFF -- ops/probe.py)
    tab = np.asarray(art.hash_table).reshape(-1, 3)
    real = tab[:, 0] != 0xFFFFFFFF
    keys, starts, lens = tab[real, 0], tab[real, 1], tab[real, 2]
    postings = np.asarray(art.postings)

    rng = np.random.default_rng(99)
    queries = make_queries(art, rng, n_queries=n_queries)
    L = QUERY_LEN - 6
    qk = np.zeros((len(queries), L), np.uint32)
    for i, q in enumerate(queries):
        qk[i] = codec.encode_kmers_batch(
            codec.pad_codes_batch([q], len(q)))[0][:L]

    with tempfile.NamedTemporaryFile(suffix=".bin", delete=False) as f:
        dump = f.name
        for v in (len(keys), len(postings), len(queries), L):
            f.write(np.uint64(v).tobytes())
        for a in (keys, starts, lens, postings, qk):
            f.write(np.ascontiguousarray(a, dtype=np.uint32).tobytes())
    modes = {}
    for mode, name in ((0, "idealized"), (1, "reference_shape")):
        best = None
        for _ in range(reps):
            out = subprocess.run([exe, dump, str(THREADS), str(mode)],
                                 check=True, capture_output=True,
                                 text=True).stdout
            r = json.loads(out)
            if best is None or r["queries_per_s"] > best["queries_per_s"]:
                best = r
        modes[name] = best["queries_per_s"]
        print(f"# n={n_proteins} mode {name}: "
              f"{best['queries_per_s']:.0f} q/s", file=sys.stderr)
    os.unlink(dump)
    return {"queries_per_s": modes["reference_shape"],
            "idealized_queries_per_s": modes["idealized"],
            "n_queries": n_queries}


per_db = {"10000": measure(10_000, 8192)}
if os.path.exists(os.path.join(CACHE_ROOT, "skew_1000000", "meta.json")):
    per_db["1000000"] = measure(1_000_000, 2048, reps=2)

result = {
    # the vs_baseline denominator (headline 10k DB): the reference's
    # per-element WORK (string-keyed counter increments, per-k-mer set
    # allocation) minus its storage engine -- strictly faster than
    # Go/Badger on this host
    "queries_per_s": per_db["10000"]["queries_per_s"],
    # upper bound on ANY CPU port of the reference algorithm (uint32 keys,
    # flat local counters, zero-copy postings)
    "idealized_queries_per_s": per_db["10000"]["idealized_queries_per_s"],
    "per_db": per_db,
    "threads": THREADS,
    "query_len": QUERY_LEN,
    "host_cores": os.cpu_count(),
    "note": (
        "in-memory C++ stand-in for the Go/Badger pipeline "
        "(search.go:421-436 hot-loop shape incl. strconv.Itoa + "
        "string-keyed counters and per-k-mer set allocation, minus LSM "
        "reads and protobuf varint decoding) -- strictly FASTER than the "
        "reference on this host, so vs_baseline computed against "
        "queries_per_s is a lower bound; idealized_queries_per_s bounds "
        "any CPU port of the same algorithm"),
    "captured_unix": int(time.time()),
}
path = os.path.join(REPO, f"CPU_BASELINE_r{ROUND:02d}.json")
with open(path, "w") as f:
    json.dump(result, f, indent=1)
print(json.dumps(result))
print(f"wrote {path}", file=sys.stderr)
