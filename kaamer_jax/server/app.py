"""HTTP API server.

Route and form-field compatible with the reference chi server
(api/server.go:118-315):

  POST /api/search/protein
  POST /api/search/nucleotide
  POST /api/search/fastq
  GET  /api/dbinfo              -> KStats JSON (Go field names, omitempty)
  GET  /                        -> 302 /web/
  GET  /docs/*, /web/*          -> static (when the directories exist)

Form fields: type (string|file|path), sequence, file, max-results, gcode,
output-format, positions, annotations, align, minkmatch, minkratio,
sub-matrix, gap-open, gap-extend -- defaults per api/server.go:139-207.
Responses stream chunk-by-chunk as query results finish, like the
reference's streaming writer.
"""

from __future__ import annotations

import email.parser
import email.policy
import json
import os
import select
import socket
import socketserver
import tempfile
import threading
import time
import urllib.parse
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ..index.artifact import load_db
from ..search.engine import SearchEngine
from ..search.options import NUCLEOTIDE, PROTEIN, READS, SearchOptions
from ..search.pipeline import run_search


def _parse_form(handler: BaseHTTPRequestHandler):
    """Parse urlencoded or multipart form bodies into ({field: value},
    {field: bytes})."""
    length = int(handler.headers.get("Content-Length") or 0)
    body = handler.rfile.read(length) if length else b""
    ctype = handler.headers.get("Content-Type", "")

    fields = {}
    files = {}
    if ctype.startswith("multipart/form-data"):
        raw = (
            b"Content-Type: " + ctype.encode() + b"\r\nMIME-Version: 1.0\r\n\r\n" + body
        )
        msg = email.parser.BytesParser(policy=email.policy.HTTP).parsebytes(raw)
        for part in msg.iter_parts():
            name = part.get_param("name", header="content-disposition")
            if name is None:
                continue
            payload = part.get_payload(decode=True) or b""
            filename = part.get_filename()
            if filename is not None:
                files[name] = payload
            else:
                fields[name] = payload.decode("utf-8", errors="replace")
    elif ctype.startswith("application/x-www-form-urlencoded"):
        for k, v in urllib.parse.parse_qsl(body.decode("utf-8", errors="replace")):
            fields[k] = v
    return fields, files


def parse_search_options(
    opts: SearchOptions, fields: dict, files: dict, tmp_folder: str
):
    """parseSearchOptions equivalent (api/server.go:220-315).  Returns an
    error string or None."""
    input_type = fields.get("type", "")
    opts.InputType = input_type
    if input_type == "string":
        path = os.path.join(tmp_folder, uuid.uuid4().hex + ".fasta")
        with open(path, "w") as f:
            f.write(fields.get("sequence", ""))
        opts.File = path
    elif input_type == "file":
        if "file" not in files:
            return "no file uploaded"
        path = os.path.join(tmp_folder, uuid.uuid4().hex + ".fasta")
        with open(path, "wb") as f:
            f.write(files["file"])
        opts.File = path
    elif input_type == "path":
        f = fields.get("file", "")
        if f:
            if not os.path.exists(f):
                return "File does not exist!"
            opts.File = f
    else:
        return "Need request type (string|file|path)"

    def _int(name, default):
        try:
            return int(fields.get(name, ""))
        except ValueError:
            return default

    def _float(name, default):
        try:
            return float(fields.get(name, ""))
        except ValueError:
            return default

    if fields.get("max-results", ""):
        opts.MaxResults = _int("max-results", opts.MaxResults)
    opts.GeneticCode = _int("gcode", opts.GeneticCode)
    if fields.get("output-format", "").lower() == "json":
        opts.OutFormat = "json"
    if fields.get("positions", "").lower() == "true":
        opts.ExtractPositions = True
    if fields.get("annotations", "").lower() == "true":
        opts.Annotations = True
    if fields.get("align", "").lower() == "true":
        opts.Align = True
    opts.MinKMatch = _int("minkmatch", opts.MinKMatch)
    opts.MinKRatio = _float("minkratio", opts.MinKRatio)
    if fields.get("sub-matrix", "").lower() not in ("", "blosum62"):
        opts.SubMatrix = fields["sub-matrix"].lower()
    opts.GapOpen = _int("gap-open", opts.GapOpen)
    opts.GapExtend = _int("gap-extend", opts.GapExtend)
    return None


def _disconnect_poller(conn: socket.socket):
    """Zero-timeout liveness check on the client socket: after the request
    body is consumed, the connection becoming readable with EOF (or an
    error) means the client went away.  The pipeline polls this between
    device batches -- the reference instead polls the request context every
    3 seconds during a search (search.go:157-166); per-batch polling reacts
    faster at negligible cost (one select syscall per batch)."""

    def cancelled() -> bool:
        try:
            r, _, _ = select.select([conn], [], [], 0)
            if r:
                return conn.recv(1, socket.MSG_PEEK) == b""
        except (OSError, ValueError):
            return True
        return False

    return cancelled


def _default_options(seq_type: int) -> SearchOptions:
    return SearchOptions(
        GeneticCode=11,
        SequenceType=seq_type,
        OutFormat="tsv",
        MaxResults=10,
        ExtractPositions=False,
        MinKMatch=10,
        MinKRatio=0.05,
        SubMatrix="blosum62",
        GapOpen=11,
        GapExtend=1,
    )


def make_handler(engine: SearchEngine, tmp_folder: str, web_dirs: dict):
    db_stats = engine.art.stats

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # quiet, like the disabled
            pass                            # Badger loggers (kv_stores.go:52)

        def do_GET(self):
            path = urllib.parse.urlparse(self.path).path
            if path == "/":
                self.send_response(302)
                self.send_header("Location", "/web/")
                self.send_header("Content-Length", "0")
                self.end_headers()
                return
            if path == "/api/dbinfo":
                data = json.dumps(db_stats.to_json_obj()).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)
                return
            for prefix, root in web_dirs.items():
                if path.startswith(prefix):
                    return self._serve_static(root, path[len(prefix):])
            self.send_error(404)

        def _serve_static(self, root, rel):
            rel = rel.lstrip("/") or "index.html"
            full = os.path.realpath(os.path.join(root, rel))
            if not full.startswith(os.path.realpath(root)) or not os.path.isfile(full):
                self.send_error(404)
                return
            with open(full, "rb") as f:
                data = f.read()
            self.send_response(200)
            ext = os.path.splitext(full)[1]
            ctype = {
                ".html": "text/html", ".js": "application/javascript",
                ".css": "text/css", ".json": "application/json",
                ".md": "text/markdown",
            }.get(ext, "application/octet-stream")
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_POST(self):
            path = urllib.parse.urlparse(self.path).path
            routes = {
                "/api/search/protein": PROTEIN,
                "/api/search/nucleotide": NUCLEOTIDE,
                "/api/search/fastq": READS,
            }
            if path not in routes:
                self.send_error(404)
                return
            fields, files = _parse_form(self)
            opts = _default_options(routes[path])
            err = parse_search_options(opts, fields, files, tmp_folder)
            if err:
                data = (err + "\n").encode()
                self.send_response(400)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)
                return

            ctype = (
                "application/json" if opts.OutFormat == "json"
                else "text/plain;charset=UTF-8"
            )
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()
            cancel = _disconnect_poller(self.connection)
            try:
                # cancel stops the pipeline from reading/dispatching further
                # batches once the client disconnects, even between writes
                # (the reference's cancelQuery flag, search.go:157-166)
                for chunk in run_search(engine, opts, cancel=cancel):
                    if chunk:
                        self.wfile.write(b"%x\r\n" % len(chunk))
                        self.wfile.write(chunk)
                        self.wfile.write(b"\r\n")
                self.wfile.write(b"0\r\n\r\n")
            except (BrokenPipeError, ConnectionResetError):
                pass  # client cancelled mid-write
            finally:
                if opts.InputType != "path" and opts.File:
                    try:
                        os.remove(opts.File)
                    except OSError:
                        pass

    return Handler


def make_server(db_path: str, port: int = 8321, tmp_folder: str = "/tmp/",
                n_shards: int = 0, warmup: bool = True, host: str = ""):
    """NewServer equivalent (api/server.go:47-116): load the database, build
    the engine and bind the HTTP server.  Returns (httpd, engine); the
    caller runs httpd.serve_forever() (port 0 binds a free port, see
    httpd.server_address).

    n_shards > 1 serves from a k-mer-hash-sharded index over a (dp, shard)
    device mesh (parallel/dist.ShardedSearchEngine); results are bit-identical
    to single-device serving (tests/test_dist.py).

    warmup=True pre-compiles the interactive shape grid in a background
    thread (engine.warmup), so a first query with a fresh shape does not
    stall on its compile."""
    if not os.path.isdir(tmp_folder):
        tmp_folder = tempfile.gettempdir()

    print(" + Opening kAAmer Database.. ", end="", flush=True)
    t0 = time.time()
    art = load_db(db_path)
    if getattr(art, "index_shards", 0) and n_shards <= 1:
        # shard-BUILT artifacts (index_db n_shards > 1) have no global
        # index; they can only be served sharded, so auto-select it
        n_shards = art.index_shards
        print(f"[shard-built index: serving sharded x{n_shards}] ",
              end="", flush=True)
    if n_shards > 1:
        from ..parallel.dist import ShardedSearchEngine, global_mesh

        engine = ShardedSearchEngine(art, mesh=global_mesh(n_shards))
        # global_mesh reduces the shard count to a divisor of the device
        # count; report what actually happened, not what was asked for
        if engine.n_shards != n_shards:
            print(f"[sharded x{engine.n_shards}; {n_shards} requested but "
                  f"only divisors of the device count are possible] ",
                  end="", flush=True)
        else:
            print(f"[sharded x{engine.n_shards}] ", end="", flush=True)
    else:
        engine = SearchEngine(art)
    print(f"done [{int(time.time() - t0) // 60:02d}m{int(time.time() - t0) % 60:02d}s]")

    web_dirs = {}
    pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    docs = os.path.join(os.path.dirname(pkg_root), "docs")
    if os.path.isdir(docs):
        web_dirs["/docs"] = docs
    web = os.path.join(os.path.dirname(pkg_root), "web", "public")
    if os.path.isdir(web):
        web_dirs["/web"] = web

    if warmup and hasattr(engine, "warmup"):
        threading.Thread(target=engine.warmup, daemon=True).start()

    handler = make_handler(engine, tmp_folder, web_dirs)
    httpd = ThreadingHTTPServer((host, port), handler)
    return httpd, engine


def serve(db_path: str, port: int = 8321, nb_threads: int = 0,
          tmp_folder: str = "/tmp/", n_shards: int = 0):
    """Run the server until interrupted (kaamer-db -server)."""
    httpd, _ = make_server(db_path, port, tmp_folder, n_shards)
    print(f" + kaamer-jax server listening on port {httpd.server_address[1]}")
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        httpd.shutdown()
