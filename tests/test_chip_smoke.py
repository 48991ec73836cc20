"""chip_smoke.py on the CPU: its numpy reference against tests/oracle.py,
and its refusal to run without a GPU."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import chip_smoke  # noqa: E402
from oracle import OracleDB  # noqa: E402


@pytest.fixture(scope="module")
def small_db(tmp_path_factory):
    from bench import build_skewed_db

    from kaamer_jax.index.artifact import load_db

    path = str(tmp_path_factory.mktemp("smoke") / "db")
    build_skewed_db(path, 400, seed=3)
    return path, load_db(path)


def test_kmer_reference_matches_oracle(small_db):
    path, art = small_db
    oracle = OracleDB([(int(art.protein_ids[i]), art.protein(i))
                       for i in range(art.num_proteins)])
    rng = np.random.default_rng(0)
    queries = [chip_smoke._mutate(rng, art.sequence(int(r)), 0.05)
               for r in rng.integers(0, art.num_proteins, size=12)]
    queries.append(art.sequence(0) + art.sequence(1))
    queries.append("W" * 40)  # no hit
    from kaamer_jax import codec

    qk = np.concatenate([codec.encode_kmers(codec.seq_to_codes(q))
                         for q in queries])
    ref = chip_smoke.KmerReference(path, qk)
    n_hits = 0
    for q in queries:
        size = len(q) - 6
        want, want_pos = oracle.kmer_search(q, size)
        hits, bms = ref.search(q, size, [pid for pid, _ in want[:10]])
        assert hits == want
        for pid, bm in bms.items():
            assert bm.tolist() == want_pos[pid]
        assert chip_smoke.filtered(hits, size) == OracleDB.filter_hits(
            want, size, 0.05, 10, 10)
        n_hits += len(hits)
    assert n_hits > 0


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_exits_nonzero_without_gpu(where, tmp_path):
    """On the CPU the device check fails before any phase; alone (no repo
    beside it) the script cannot import the program.  Neither prints a
    result line."""
    script = os.path.join(REPO, "chip_smoke.py")
    if where == "alone":
        script = shutil.copy(script, tmp_path / "chip_smoke.py")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               KAAMER_BENCH_CACHE=str(tmp_path / "cache"))
    proc = subprocess.run([sys.executable, str(script)], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert not (tmp_path / "cache").exists()
