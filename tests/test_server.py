"""HTTP API end-to-end: in-process server + urllib client."""

import json
import threading
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest

from kaamer_jax.index.build import build_db
from kaamer_jax.index.artifact import load_db
from kaamer_jax.search.engine import SearchEngine
from kaamer_jax.server.app import make_handler
from kaamer_jax.server import client as cli_client

AA = "ACDEFGHIKLMNPQRSTVWY"


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    rng = np.random.default_rng(5)
    tmp = tmp_path_factory.mktemp("srvdb")
    fasta = tmp / "db.fasta"
    seqs = []
    with open(fasta, "w") as f:
        for i in range(30):
            L = int(rng.integers(60, 150))
            s = "".join(rng.choice(list(AA), size=L))
            seqs.append(s)
            f.write(f">SP{i} test protein {i}\n{s}\n")
    dbdir = str(tmp / "db")
    build_db(dbdir, str(fasta), "fasta")
    engine = SearchEngine(load_db(dbdir))

    handler = make_handler(engine, str(tmp), {})
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    port = httpd.server_address[1]
    yield f"http://127.0.0.1:{port}", seqs, tmp
    httpd.shutdown()


def test_dbinfo(server):
    url, seqs, _ = server
    with urllib.request.urlopen(url + "/api/dbinfo") as resp:
        info = json.loads(resp.read())
    assert info["NumberOfProteins"] == 30
    assert info["Features"] == ["ProteinName"]


def _post_form(url, fields):
    data = urllib.parse.urlencode(fields).encode()
    req = urllib.request.Request(
        url, data=data,
        headers={"Content-Type": "application/x-www-form-urlencoded"},
    )
    return urllib.request.urlopen(req)


def test_protein_search_string(server):
    import urllib.parse

    url, seqs, _ = server
    with _post_form(
        url + "/api/search/protein",
        {"type": "string", "sequence": ">q1\n" + seqs[3], "max-results": "2"},
    ) as resp:
        body = resp.read().decode()
    lines = body.strip().split("\n")
    assert lines[0].startswith("QueryId\tSubjectId")
    cols = lines[1].split("\t")
    assert cols[0] == "q1" and cols[1] == "SP3"
    assert cols[2] == "100.00"


def test_protein_search_json(server):
    import urllib.parse

    url, seqs, _ = server
    with _post_form(
        url + "/api/search/protein",
        {"type": "string", "sequence": ">q\n" + seqs[7],
         "output-format": "json", "annotations": "true"},
    ) as resp:
        doc = json.loads(resp.read())
    assert doc["dbProteinFeatures"] == ["ProteinName"]
    assert doc["results"][0]["SearchResults"]["Hits"][0]["Kmatch"] == len(seqs[7]) - 6


def test_concurrent_requests(server):
    """The engine is shared across ThreadingHTTPServer threads (the
    reference serves every request from one read-only store, api/server.go:65);
    simultaneous searches must all return their own correct top hit."""
    url, seqs, _ = server
    results = {}
    errors = []

    def worker(i):
        try:
            with _post_form(
                url + "/api/search/protein",
                {"type": "string", "sequence": f">q{i}\n" + seqs[i],
                 "max-results": "1"},
            ) as resp:
                results[i] = resp.read().decode()
        except Exception as e:  # pragma: no cover
            errors.append((i, e))

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors
    for i in range(8):
        line = results[i].strip().split("\n")[1].split("\t")
        assert line[0] == f"q{i}" and line[1] == f"SP{i}" and line[2] == "100.00"


def test_sharded_engine_serves(server, tmp_path):
    """-shards N serving: the HTTP handler over a ShardedSearchEngine returns
    the same bytes as single-device serving."""
    import urllib.parse

    url, seqs, tmp = server
    from kaamer_jax.parallel.dist import ShardedSearchEngine, global_mesh

    engine = ShardedSearchEngine(load_db(str(tmp / "db")), mesh=global_mesh(4))
    handler = make_handler(engine, str(tmp_path), {})
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        sharded_url = f"http://127.0.0.1:{httpd.server_address[1]}"
        fields = {"type": "string", "sequence": ">q\n" + seqs[4],
                  "max-results": "3", "positions": "true"}
        with _post_form(sharded_url + "/api/search/protein", fields) as resp:
            sharded_body = resp.read()
        with _post_form(url + "/api/search/protein", fields) as resp:
            single_body = resp.read()
        assert sharded_body == single_body
        assert sharded_body.decode().strip().split("\n")[1].split("\t")[1] == "SP4"
    finally:
        httpd.shutdown()


def test_shard_built_db_auto_serves_sharded(server, tmp_path):
    """A shard-BUILT database (index_db n_shards > 1) has no global index;
    serve() must auto-select sharded serving and answer identically."""
    import urllib.parse  # noqa: F401

    url, seqs, tmp = server
    from kaamer_jax.parallel.dist import ShardedSearchEngine, global_mesh

    dbdir = str(tmp_path / "sdb")
    build_db(dbdir, str(tmp / "db.fasta"), "fasta", n_shards=4)
    art = load_db(dbdir)
    assert art.index_shards == 4
    engine = ShardedSearchEngine(art, mesh=global_mesh(art.index_shards))
    handler = make_handler(engine, str(tmp_path), {})
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        surl = f"http://127.0.0.1:{httpd.server_address[1]}"
        fields = {"type": "string", "sequence": ">q\n" + seqs[7],
                  "max-results": "3", "positions": "true"}
        with _post_form(surl + "/api/search/protein", fields) as resp:
            sharded_body = resp.read()
        with _post_form(url + "/api/search/protein", fields) as resp:
            single_body = resp.read()
        assert sharded_body == single_body
    finally:
        httpd.shutdown()


def test_missing_type_is_400(server):
    import urllib.error

    url, _, _ = server
    try:
        _post_form(url + "/api/search/protein", {"sequence": "x"})
        assert False, "expected 400"
    except urllib.error.HTTPError as e:
        assert e.code == 400


def test_disconnect_poller_detects_eof():
    import socket as sk

    from kaamer_jax.server.app import _disconnect_poller

    a, b = sk.socketpair()
    try:
        cancelled = _disconnect_poller(a)
        assert cancelled() is False          # peer alive, nothing to read
        b.close()
        assert cancelled() is True           # peer gone -> EOF readable
    finally:
        a.close()


def test_mid_search_cancellation_stops_dispatching(server, tmp_path, monkeypatch):
    """Dropping the client mid-stream must stop the engine from consuming
    further batches (reference: cancelQuery polling, search.go:157-166)."""
    import socket as sk
    import time

    import kaamer_jax.search.pipeline as pl

    url, seqs, tmp = server
    engine = SearchEngine(load_db(str(tmp / "db")))
    calls = {"dispatch": 0}
    orig_dispatch = engine.dispatch_batch
    orig_resolve = engine.resolve_batch

    def counting_dispatch(*a, **kw):
        calls["dispatch"] += 1
        return orig_dispatch(*a, **kw)

    def slow_resolve(h):
        time.sleep(0.15)  # stretch the search so the disconnect lands mid-run
        return orig_resolve(h)

    engine.dispatch_batch = counting_dispatch
    engine.resolve_batch = slow_resolve
    monkeypatch.setattr(pl, "BATCH_MAX", 2)  # 64 queries -> 32 batches

    handler = make_handler(engine, str(tmp_path), {})
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        body = "".join(f">q{i}\n{seqs[i % len(seqs)]}\n" for i in range(64))
        payload = urllib.parse.urlencode(
            {"type": "string", "sequence": body, "max-results": "1"}
        ).encode()
        s = sk.create_connection(("127.0.0.1", httpd.server_address[1]))
        s.sendall(
            b"POST /api/search/protein HTTP/1.1\r\nHost: x\r\n"
            b"Content-Type: application/x-www-form-urlencoded\r\n"
            b"Content-Length: %d\r\n\r\n" % len(payload) + payload
        )
        s.recv(256)  # response started streaming
        s.close()    # drop the connection mid-search

        # dispatching must stop well short of the 32 batches
        deadline = time.time() + 20
        last = -1
        while time.time() < deadline:
            time.sleep(0.4)
            if calls["dispatch"] == last:
                break  # plateaued
            last = calls["dispatch"]
        assert calls["dispatch"] < 20, calls
    finally:
        httpd.shutdown()


def test_client_file_upload(server, tmp_path, capsys):
    url, seqs, _ = server
    qf = tmp_path / "q.fasta"
    qf.write_text(">query\n" + seqs[0] + "\n")
    import io

    out = io.StringIO()
    cli_client.search_request(
        url, str(qf), sequence_type=1, input_type="file", output=out
    )
    lines = out.getvalue().strip().split("\n")
    assert lines[1].split("\t")[1] == "SP0"


def test_client_path_mode(server, tmp_path):
    url, seqs, _ = server
    qf = tmp_path / "q2.fasta"
    qf.write_text(">query\n" + seqs[1] + "\n")
    import io

    out = io.StringIO()
    cli_client.search_request(
        url, str(qf), sequence_type=1, input_type="path", output=out
    )
    assert "SP1" in out.getvalue()
