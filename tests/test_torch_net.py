"""The port's HTTP(S) byte source (libnyquist_torch.net) against the JAX
package's, on the CPU, with the cases of tests/test_net.py over in-repo
content (that file skips as a whole without its reference corpus).

Every case runs against an in-process 127.0.0.1 server implementing
RFC 7233 single-range requests with keep-alive, and switchable
misbehaviours: no Range support, chunked bodies, redirects and a
redirect loop, a lying Content-Range start or total, a lying
Content-Length or chunk size, and 404. Where both packages' HTTPSource
run the same case, the port's ``requests`` and ``bytes_fetched`` equal
the JAX package's; reads over HTTP equal the local reader's bit for bit.
"""

import http.server
import shutil
import socket
import ssl
import subprocess
import threading

import numpy as np
import pytest
import torch

import libnyquist_torch as nqt
from libnyquist_torch import net as P
from libnyquist_torch.streaming import seek_reader
from libnyquist_tpu import net as J

from .test_torch_streaming import content, tool


class _RangeHandler(http.server.BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def log_message(self, *a):
        pass

    def do_GET(self):
        cfg = self.server.cfg
        self.server.hits += 1
        # redirect chain: /r/<n>/<path> -> /r/<n-1>/<path> -> ... /<path>
        if self.path.startswith("/r/"):
            _, _, n, rest = self.path.split("/", 3)
            n = int(n)
            loc = f"/{rest}" if n <= 1 else f"/r/{n - 1}/{rest}"
            self.send_response(302)
            self.send_header("Location", loc)
            self.send_header("Content-Length", "0")
            self.end_headers()
            return
        if self.path == "/missing":
            self.send_response(404)
            self.send_header("Content-Length", "9")
            self.end_headers()
            self.wfile.write(b"not found")
            return
        if self.path == "/loop":
            self.send_response(302)
            self.send_header("Location", "/loop")
            self.send_header("Content-Length", "0")
            self.end_headers()
            return
        body = self.server.payload
        rng = self.headers.get("Range")
        if rng and cfg.get("ranges", True):
            spec = rng.split("=", 1)[1].split(",")[0].strip()
            lo_s, hi_s = spec.split("-", 1)
            lo = int(lo_s)
            hi = int(hi_s) if hi_s else len(body) - 1
            hi = min(hi, len(body) - 1)
            if lo >= len(body):
                self.send_response(416)
                self.send_header("Content-Range", f"bytes */{len(body)}")
                self.send_header("Content-Length", "0")
                self.end_headers()
                return
            part = body[lo : hi + 1]
            self.send_response(206)
            start = lo + cfg.get("range_lie", 0)
            total = cfg.get("total_lie", len(body))
            self.send_header("Content-Range", f"bytes {start}-{hi}/{total}")
            self.send_header("Content-Length", str(len(part)))
            self.end_headers()
            self.wfile.write(part)
            return
        self.send_response(200)
        if cfg.get("chunked"):
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()
            if cfg.get("chunk_lie"):
                # advertise an absurd chunk then hang up
                self.wfile.write(b"ffffffffff\r\n")
                self.close_connection = True
                return
            for i in range(0, len(body), 9973):
                c = body[i : i + 9973]
                self.wfile.write(b"%x\r\n" % len(c) + c + b"\r\n")
            self.wfile.write(b"0\r\n\r\n")
            return
        self.send_header("Content-Length", str(cfg.get("cl_lie", len(body))))
        self.end_headers()
        self.wfile.write(body)


class _Server(http.server.ThreadingHTTPServer):
    daemon_threads = True

    def __init__(self, payload, cfg=None, certfile=None):
        super().__init__(("127.0.0.1", 0), _RangeHandler)
        self.payload = payload
        self.cfg = cfg or {}
        self.hits = 0
        self.conns = 0
        if certfile:
            ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
            ctx.load_cert_chain(certfile)
            self.socket = ctx.wrap_socket(self.socket, server_side=True)

    def get_request(self):
        req = super().get_request()
        self.conns += 1
        return req

    def handle_error(self, request, client_address):
        pass   # expected: client-aborted TLS handshakes in tests


@pytest.fixture
def serve():
    servers = []

    def start(payload, cfg=None, certfile=None):
        s = _Server(payload, cfg, certfile)
        threading.Thread(target=s.serve_forever, daemon=True).start()
        servers.append(s)
        scheme = "https" if certfile else "http"
        return s, f"{scheme}://127.0.0.1:{s.server_address[1]}"

    yield start
    for s in servers:
        s.shutdown()
        s.server_close()


def _reads(reader, plan):
    out = []
    for pos, n in plan:
        reader.pcm_seek(pos)
        out.append(reader.read(n))
    return out


@pytest.mark.parametrize("ext", ["opus", "flac"])
def test_seek_reader_over_http_bit_exact(serve, ext):
    """Reads over HTTP equal the local reader's and the network cost
    stays bounded (tests/test_net.py:152-170: fewer than 60 requests and
    less than twice the file). The FLAC stream is 20 s long: the bounds
    are for files larger than the reader's 64 KiB probes and first
    window. (The readers' reads differ from the JAX package's here by
    design, ROADMAP.md section 3: the wire counts are compared with the
    JAX source's where the reads are the same, below.)"""
    data = (content("opus") if ext == "opus" else
            tool("flac_stream").make_flac_stream(1, 20.0)[0])
    srv, base = serve(data)
    src = P.HTTPSource(f"{base}/x.{ext}")
    assert src.seekable and src.size == len(data)
    r = seek_reader(src, device="cpu")
    ref = seek_reader(data, device="cpu")
    total = r.pcm_total()
    assert total == ref.pcm_total()
    plan = [(0, 4800), (total // 2, 4800), (total - 4800, 4800), (1234, 4800)]
    for a, b in zip(_reads(r, plan), _reads(ref, plan)):
        np.testing.assert_array_equal(a, b)
    assert src.requests < 60
    assert src.bytes_fetched < 2 * len(data)
    src.close()


def test_overlapping_reads_fetch_what_the_cache_lacks(serve):
    """The same preads through both packages' sources (the Ogg link
    discovery's probes, sliding a page at a time): the same bytes come
    back, and the port fetches only the part of a read its cache does not
    hold, where the JAX source fetches the whole read again."""
    data = np.random.default_rng(3).integers(0, 256, 1 << 19,
                                             np.uint8).tobytes()
    srv, base = serve(data)
    src, jsrc = P.HTTPSource(f"{base}/x.bin"), J.HTTPSource(f"{base}/x.bin")
    span = 128 * 1024               # probes over the first 128 KiB
    for off in range(0, span, 1500):
        assert src.pread(off, 66 * 1024) == jsrc.pread(off, 66 * 1024) == \
            data[off : off + 66 * 1024]
    assert src.requests <= jsrc.requests
    assert src.bytes_fetched < 2 * (span + 66 * 1024) < jsrc.bytes_fetched
    src.close()
    jsrc.close()


def test_sequential_chunk_escalation(serve):
    data = bytes(range(256)) * 4096          # 1 MiB
    srv, base = serve(data)
    counts = []
    for mod in (P, J):
        src = mod.HTTPSource(f"{base}/x.bin")
        out = bytearray()
        pos = 0
        while pos < len(data):
            b = src.pread(pos, 65536)
            out += b
            pos += len(b)
        assert bytes(out) == data
        counts.append((src.requests, src.bytes_fetched))
        src.close()
    # doubling chunks: far fewer requests than 1 MiB / 64 KiB reads
    assert counts[0][0] <= 8
    assert counts[0] == counts[1]


def test_load_url_matches_local(serve):
    data = content("opus")
    srv, base = serve(data)
    d = nqt.load_url(f"{base}/x.opus", device="cpu")
    ref = nqt.load(data, extension="opus", device="cpu")
    np.testing.assert_array_equal(d.samples, ref.samples)
    assert (d.sample_rate, d.channel_count) == (ref.sample_rate,
                                                ref.channel_count)
    j = J.load_url(f"{base}/x.opus")
    assert j.samples.shape == d.samples.shape
    assert np.abs(j.samples - d.samples).max() < 1e-4


def test_redirect_chain_followed(serve):
    data = content("opus")
    srv, base = serve(data)
    for mod in (P, J):
        src = mod.HTTPSource(f"{base}/r/3/x.opus")
        assert src.redirects == 3 and src.requests == 4
        assert src.size == len(data)
        assert src.pread(0, 4) == data[:4]
        src.close()


def test_redirect_loop_bounded(serve):
    srv, base = serve(b"x")
    with pytest.raises(P.NetworkError, match="redirect limit"):
        P.HTTPSource(f"{base}/loop")
    assert srv.hits <= P.REDIRECT_LIMIT + 2
    assert P.REDIRECT_LIMIT == J.REDIRECT_LIMIT


def test_no_range_server_buffers_whole_body(serve):
    data = content("opus")
    srv, base = serve(data, cfg={"ranges": False})
    src = P.HTTPSource(f"{base}/x.opus")
    assert not src.seekable
    assert src.size == len(data)
    r = seek_reader(src, device="cpu")
    r.pcm_seek(1000)
    ref = seek_reader(data, device="cpu")
    ref.pcm_seek(1000)
    np.testing.assert_array_equal(r.read(480), ref.read(480))
    # exactly one download, no per-read requests
    assert src.requests == 1
    assert src.bytes_fetched == len(data)
    src.close()


def test_chunked_200_body(serve):
    data = content("opus")
    srv, base = serve(data, cfg={"ranges": False, "chunked": True})
    for mod in (P, J):
        src = mod.HTTPSource(f"{base}/x.opus")
        assert src.size == len(data)
        assert src.pread(100, 64) == data[100:164]
        assert (src.requests, src.bytes_fetched) == (1, len(data))
        src.close()


def test_lying_content_range_rejected(serve):
    data = b"a" * (P.CHUNK_MIN * 8)
    srv, base = serve(data, cfg={"range_lie": 7})
    # the opener streams from 0; a later far seek issues a fresh range
    # request whose (lied) start mismatches
    src = P.HTTPSource(f"{base}/x.bin")
    with pytest.raises(P.NetworkError, match="Content-Range start"):
        src.pread(len(data) - 16, 16)
    src.close()


def test_lying_content_length_bounded(serve):
    # a no-Range server advertising a 100 TB body must fail fast, not
    # buffer unbounded (BODY_BYTES_MAX)
    srv, base = serve(b"tiny", cfg={"ranges": False, "cl_lie": 100 * 2**40})
    with pytest.raises(P.NetworkError, match="Content-Length"):
        P.HTTPSource(f"{base}/x.bin")


def test_lying_chunk_size_bounded(serve):
    # a chunked body advertising a ~1 TB chunk is rejected before any
    # attempt to buffer it (CHUNK_BYTES_MAX)
    srv, base = serve(b"tiny", cfg={"ranges": False, "chunked": True,
                                    "chunk_lie": True})
    with pytest.raises(P.NetworkError, match="chunk size"):
        P.HTTPSource(f"{base}/x.bin")


def test_lying_content_range_total_bounded(serve):
    # a Content-Range total beyond the body bound would poison the size
    # and every later pread window: rejected at the opener
    srv, base = serve(b"a" * 4096, cfg={"total_lie": 1 << 62})
    with pytest.raises(P.NetworkError, match="Content-Range total"):
        P.HTTPSource(f"{base}/x.bin")


def test_connection_pool_bounded(serve):
    data = content("opus")
    srv, base = serve(data)
    offs = np.random.default_rng(0).integers(0, len(data) - 64, 64)
    counts = []
    for mod in (P, J):
        srv.conns = 0
        src = mod.HTTPSource(f"{base}/x.opus")
        for off in offs:
            assert src.pread(int(off), 64) == data[off : off + 64]
        assert len(src._conns) <= P.NCONNS_MAX
        # keep-alive: far fewer TCP connections than requests
        assert srv.conns <= P.NCONNS_MAX + 2
        counts.append((src.requests, src.bytes_fetched))
        src.close()
    assert counts[0] == counts[1]


@pytest.fixture(scope="module")
def self_signed(tmp_path_factory):
    if shutil.which("openssl") is None:
        pytest.skip("openssl is not installed")
    d = tmp_path_factory.mktemp("tls")
    pem = d / "cert.pem"
    subprocess.run(
        ["openssl", "req", "-x509", "-newkey", "rsa:2048", "-keyout",
         str(pem), "-out", str(pem), "-days", "2", "-nodes", "-subj",
         "/CN=127.0.0.1", "-addext", "subjectAltName=IP:127.0.0.1"],
        check=True, capture_output=True)
    return str(pem)


def test_https_self_signed(serve, self_signed):
    data = content("opus")
    srv, base = serve(data, certfile=self_signed)
    # verify=True rejects the unknown CA ...
    with pytest.raises((P.NetworkError, ssl.SSLError, OSError)):
        P.HTTPSource(f"{base}/x.opus")
    # ... and the OP_SSL_SKIP_CERTIFICATE_CHECK analog accepts it
    src = P.HTTPSource(f"{base}/x.opus", verify=False)
    assert src.size == len(data)
    r = nqt.open_url(f"{base}/x.opus", device="cpu", verify=False)
    ref = seek_reader(data, device="cpu")
    r.pcm_seek(4800)
    ref.pcm_seek(4800)
    np.testing.assert_array_equal(r.read(480), ref.read(480))
    src.close()


def test_scheme_and_error_surface():
    with pytest.raises(nqt.NyquistError):
        P.HTTPSource("ftp://example/x.opus")
    # connection refused surfaces as OSError/NetworkError, not a hang
    free = socket.socket()
    free.bind(("127.0.0.1", 0))
    port = free.getsockname()[1]
    free.close()
    with pytest.raises((P.NetworkError, OSError)):
        P.HTTPSource(f"http://127.0.0.1:{port}/x", timeout=2.0)


def test_http_404_surfaces(serve):
    srv, base = serve(b"x")
    with pytest.raises(P.NetworkError, match="HTTP 404"):
        P.HTTPSource(f"{base}/missing")
    assert issubclass(P.NetworkError, nqt.DecodeError)


def test_url_entry_points_run_on_cuda_unless_told(serve, monkeypatch):
    """open_url and load_url default to CUDA and raise without it,
    before any request."""
    srv, base = serve(content("opus"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn in (nqt.open_url, nqt.load_url):
        with pytest.raises(RuntimeError, match="CUDA"):
            fn(f"{base}/x.opus")
    assert srv.hits == 0
