"""HTTP/HTTPS byte source for the lazy seek readers (opusfile http.c
equivalent).

The reference ships a self-contained HTTP/1.1 client for network
streaming (`opusfile/src/http.c`, 3.4k LoC: URL connect, keep-alive
connection pool, Range seeks, redirect chasing, TLS).  This module is
the same capability over the stdlib `socket`/`ssl` primitives, shaped
for this framework's positioned-read model: it subclasses
`streaming.CountingSource`, so every lazy reader (OggSeekReader,
FlacSeekReader, Mp3SeekReader, MpcSeekReader, WavSeekReader) and the
decode facade work over a URL unchanged.

Behavioral anchors (studied from the reference, reimplemented):
  - connection pool of up to 4 keep-alive connections, the next read
    served by the connection whose stream position is nearest behind
    the target (http.c:360 OP_NCONNS_MAX, http.c:2749 connection
    selection);
  - short forward gaps are read through and discarded rather than
    paying a new request round trip (http.c:396
    OP_READAHEAD_THRESH_MIN);
  - sequential reads escalate the Range chunk from 32 KiB, doubling
    per request up to 1 MiB, then request the file tail (http.c:401
    OP_PIPELINE_CHUNK_SIZE..MAX);
  - redirects chased to depth 20 (http.c:372 OP_REDIRECT_LIMIT);
  - servers without Range support degrade to a full in-memory
    download (the reference treats such streams as unseekable;
    buffering keeps the positioned-read surface uniform);
  - TLS via `ssl.create_default_context`, with `verify=False` as the
    OP_SSL_SKIP_CERTIFICATE_CHECK analog for self-signed test rigs;
  - a read the interval cache covers in part fetches only the rest
    (the readers' probes overlap: the link discovery slides a 66 KiB
    probe a page at a time).

The client is host code over the standard library; only the decode
of what it fetches runs on the device. The tests drive it against
in-process `http.server` / `ssl`-wrapped localhost servers
(tests/test_torch_net.py).
"""

from __future__ import annotations

import socket
import ssl as _ssl
from urllib.parse import urljoin, urlsplit

from .errors import DecodeError, UnsupportedExtensionError
from .streaming import CountingSource

NCONNS_MAX = 4                   # http.c:360
REDIRECT_LIMIT = 20              # http.c:372
CHUNK_MIN = 32 * 1024            # http.c:401
CHUNK_MAX = 1024 * 1024          # http.c:404
READAHEAD_THRESH = 32 * 1024     # http.c:396
CACHE_BYTES_MAX = 16 * 1024 * 1024
# wire-size sanity bounds (the repo's fuzz doctrine: every size field
# read from untrusted input is checked before it drives allocation —
# a lying chunk size / Content-Length must not buffer unbounded)
BODY_BYTES_MAX = 1 << 31
CHUNK_BYTES_MAX = 256 * 1024 * 1024
_REDIRECT_CODES = (301, 302, 303, 307, 308)


def _int_header(value, what, bound=BODY_BYTES_MAX):
    try:
        n = int(value)
    except (TypeError, ValueError):
        raise NetworkError(f"bad {what}: {value!r}")
    if not 0 <= n <= bound:
        raise NetworkError(f"{what} out of bounds: {n}")
    return n


class NetworkError(DecodeError):
    """Transport/protocol failure while streaming from a URL."""


def _parse_url(url: str):
    u = urlsplit(url)
    if u.scheme not in ("http", "https"):
        raise UnsupportedExtensionError(
            f"unsupported URL scheme: {u.scheme!r}")
    if not u.hostname:
        raise NetworkError(f"no host in URL: {url!r}")
    port = u.port or (443 if u.scheme == "https" else 80)
    path = u.path or "/"
    if u.query:
        path += "?" + u.query
    return u.scheme, u.hostname, port, path


class _Response:
    """One parsed HTTP/1.1 response head + a bounded body reader."""

    def __init__(self, status, headers, keep_alive):
        self.status = status
        self.headers = headers
        self.keep_alive = keep_alive


class _Conn:
    """One keep-alive connection: socket + read buffer + the stream
    position the next body byte corresponds to (pos < 0: no body in
    flight)."""

    def __init__(self, scheme, host, port, timeout, ssl_ctx):
        self.key = (scheme, host, port)
        self.timeout = timeout
        self.ssl_ctx = ssl_ctx
        self.sock = None
        self.buf = b""
        self.pos = -1          # next byte offset the body will deliver
        self.body_left = 0     # bytes remaining of the in-flight body
        self.chunk = CHUNK_MIN # current sequential-escalation size
        self.last_use = 0

    # -- transport -------------------------------------------------
    def connect(self):
        self.close()
        scheme, host, port = self.key
        s = socket.create_connection((host, port), self.timeout)
        s.settimeout(self.timeout)
        if scheme == "https":
            s = self.ssl_ctx.wrap_socket(s, server_hostname=host)
        self.sock = s
        self.buf = b""
        self.pos = -1
        self.body_left = 0

    def close(self):
        if self.sock is not None:
            try:
                self.sock.close()
            except OSError:
                pass
        self.sock = None
        self.buf = b""
        self.pos = -1
        self.body_left = 0

    def _fill(self) -> bool:
        try:
            d = self.sock.recv(65536)
        except (OSError, _ssl.SSLError) as e:
            raise NetworkError(f"recv failed: {e}") from e
        if not d:
            return False
        self.buf += d
        return True

    def _read_line(self) -> bytes:
        while b"\r\n" not in self.buf:
            if len(self.buf) > 65536:
                raise NetworkError("oversized header line")
            if not self._fill():
                raise NetworkError("connection closed mid-header")
        line, self.buf = self.buf.split(b"\r\n", 1)
        return line

    def read_exact(self, n: int) -> bytes:
        if not 0 <= n <= BODY_BYTES_MAX:
            raise NetworkError(f"body read size out of bounds: {n}")
        while len(self.buf) < n:
            if not self._fill():
                raise NetworkError("connection closed mid-body")
        out, self.buf = self.buf[:n], self.buf[n:]
        return out

    def read_to_close(self) -> bytes:
        while True:
            if len(self.buf) > BODY_BYTES_MAX:
                raise NetworkError("read-to-close body exceeds bound")
            try:
                if not self._fill():
                    break
            except NetworkError:
                break
        out, self.buf = self.buf, b""
        return out

    # -- HTTP ------------------------------------------------------
    def request(self, path, extra_headers=()) -> _Response:
        """Send one GET and parse the response head.  The caller reads
        the body (read_exact / chunked helpers) before reusing the
        connection."""
        host = self.key[1]
        port = self.key[2]
        default = 443 if self.key[0] == "https" else 80
        hosthdr = host if port == default else f"{host}:{port}"
        lines = [f"GET {path} HTTP/1.1", f"Host: {hosthdr}",
                 "User-Agent: libnyquist-torch/1.0",
                 "Accept-Encoding: identity"]
        lines += list(extra_headers)
        req = ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1")
        if self.sock is None:
            self.connect()
        try:
            self.sock.sendall(req)
        except (OSError, _ssl.SSLError):
            # stale keep-alive connection: one reconnect attempt
            self.connect()
            self.sock.sendall(req)
        try:
            status_line = self._read_line()
        except NetworkError:
            # server closed an idle keep-alive socket between requests
            self.connect()
            self.sock.sendall(req)
            status_line = self._read_line()
        parts = status_line.split(None, 2)
        if len(parts) < 2 or not parts[0].startswith(b"HTTP/1."):
            raise NetworkError(f"bad status line: {status_line!r}")
        status = int(parts[1])
        headers = {}
        while True:
            line = self._read_line()
            if not line:
                break
            if b":" not in line:
                continue
            k, v = line.split(b":", 1)
            headers[k.strip().lower().decode("latin-1")] = \
                v.strip().decode("latin-1")
        keep = (parts[0] != b"HTTP/1.0"
                and headers.get("connection", "").lower() != "close")
        return _Response(status, headers, keep)

    def read_body(self, resp: _Response) -> bytes:
        """Whole response body (Content-Length, chunked, or
        read-to-close)."""
        te = resp.headers.get("transfer-encoding", "").lower()
        if "chunked" in te:
            out = []
            total = 0
            while True:
                szline = self._read_line()
                try:
                    sz = int(szline.split(b";")[0], 16)
                except ValueError:
                    raise NetworkError(f"bad chunk size: {szline!r}")
                if not 0 <= sz <= CHUNK_BYTES_MAX:
                    raise NetworkError(f"chunk size out of bounds: {sz}")
                if sz == 0:
                    while self._read_line():   # trailers
                        pass
                    return b"".join(out)
                total += sz
                if total > BODY_BYTES_MAX:
                    raise NetworkError("chunked body exceeds bound")
                out.append(self.read_exact(sz))
                self.read_exact(2)             # chunk CRLF
        cl = resp.headers.get("content-length")
        if cl is not None:
            return self.read_exact(_int_header(cl, "Content-Length"))
        body = self.read_to_close()
        self.close()
        return body


class HTTPSource(CountingSource):
    """Positioned byte source over HTTP(S) Range requests.

    Drop-in for CountingSource anywhere a seek reader or the decode
    facade takes one: `streaming.seek_reader(HTTPSource(url))`.
    `reads`/`bytes_read` count pread calls (the reader cost model);
    `requests`/`bytes_fetched` count actual network round trips and
    wire bytes — the interesting numbers for a network source.
    """

    def __init__(self, url: str, timeout: float = 10.0,
                 verify: bool = True, ssl_context=None):
        self.timeout = timeout
        if ssl_context is not None:
            self._ssl = ssl_context
        elif verify:
            self._ssl = _ssl.create_default_context()
        else:
            self._ssl = _ssl._create_unverified_context()
        self.reads = 0
        self.bytes_read = 0
        self.requests = 0
        self.bytes_fetched = 0
        self.redirects = 0
        self._conns: list[_Conn] = []
        self._clock = 0
        # interval cache: sorted-by-start {start: bytes}
        self._cache: dict[int, bytes] = {}
        self._cache_bytes = 0
        self._buf_all = None     # no-Range fallback: whole body
        self.url = url
        self._open(url)

    # -- connection/bootstrap ---------------------------------------
    def _new_conn(self, url: str) -> _Conn:
        scheme, host, port, path = _parse_url(url)
        c = _Conn(scheme, host, port, self.timeout, self._ssl)
        c.path = path
        return c

    def _open(self, url: str):
        """Bootstrap request: probe Range support and learn the size
        (http.c sends the same `Range: bytes=0-` opener)."""
        for _ in range(REDIRECT_LIMIT + 1):
            conn = self._new_conn(url)
            resp = conn.request(conn.path, ("Range: bytes=0-",))
            self.requests += 1
            if resp.status in _REDIRECT_CODES:
                loc = resp.headers.get("location")
                if not loc:
                    raise NetworkError("redirect without Location")
                conn.read_body(resp)
                conn.close()
                url = urljoin(url, loc)
                self.redirects += 1
                continue
            break
        else:
            raise NetworkError(f"redirect limit ({REDIRECT_LIMIT}) hit")
        self.url = url
        if resp.status == 206:
            cr = resp.headers.get("content-range", "")
            try:
                total = cr.rsplit("/", 1)[1]
            except IndexError:
                raise NetworkError(f"bad Content-Range: {cr!r}")
            self.size = _int_header(total, "Content-Range total")
            self.seekable = True
            # the opener streams from 0; keep it as a positioned body
            cl = _int_header(
                resp.headers.get("content-length", self.size),
                "Content-Length")
            conn.pos = 0
            conn.body_left = cl
            conn.last_use = self._tick()
            self._conns.append(conn)
        elif resp.status == 200:
            # no Range support: buffer the whole resource (uniform
            # positioned-read surface over an unseekable stream)
            body = conn.read_body(resp)
            self.bytes_fetched += len(body)
            self.size = len(body)
            self.seekable = False
            self._buf_all = body
            if resp.keep_alive:
                conn.last_use = self._tick()
                self._conns.append(conn)
            else:
                conn.close()
        else:
            body = conn.read_body(resp)
            conn.close()
            raise NetworkError(
                f"HTTP {resp.status} for {url!r}: {body[:200]!r}")

    def _tick(self):
        self._clock += 1
        return self._clock

    # -- interval cache ---------------------------------------------
    def _cache_put(self, off: int, data: bytes):
        if not data:
            return
        self._cache[off] = data
        self._cache_bytes += len(data)
        while self._cache_bytes > CACHE_BYTES_MAX and len(self._cache) > 1:
            k = next(iter(self._cache))
            self._cache_bytes -= len(self._cache.pop(k))

    def _cache_get(self, off: int, n: int) -> bytes:
        """The longest prefix of [off, off+n) that cached intervals
        cover (empty when none does)."""
        out = []
        need = n
        pos = off
        while need > 0:
            hit = None
            for s, d in self._cache.items():
                if s <= pos < s + len(d):
                    hit = (s, d)
                    break
            if hit is None:
                break
            s, d = hit
            take = min(need, s + len(d) - pos)
            out.append(d[pos - s : pos - s + take])
            pos += take
            need -= take
        return b"".join(out)

    # -- connection selection (http.c:2749) ---------------------------
    def _pick_conn(self, off: int) -> _Conn:
        best, best_gap = None, None
        for c in self._conns:
            if c.sock is None or c.pos < 0:
                continue
            gap = off - c.pos
            if 0 <= gap <= min(READAHEAD_THRESH, c.body_left):
                if best_gap is None or gap < best_gap:
                    best, best_gap = c, gap
        if best is not None:
            return best
        # reuse an idle (no body in flight) connection, else open one,
        # else evict the least-recently-used
        for c in self._conns:
            if c.sock is not None and c.body_left == 0:
                return c
        if len(self._conns) < NCONNS_MAX:
            c = self._new_conn(self.url)
            self._conns.append(c)
            return c
        c = min(self._conns, key=lambda c: c.last_use)
        c.close()
        return c

    def _fetch(self, off: int, n: int) -> bytes:
        """Fetch [off, off+n) from the network into the cache."""
        c = self._pick_conn(off)
        c.last_use = self._tick()
        gap = off - c.pos
        if c.sock is not None and 0 <= gap <= min(READAHEAD_THRESH,
                                                  c.body_left) \
                and c.pos >= 0:
            # read through the gap on the in-flight body
            if gap:
                skipped = c.read_exact(gap)
                self.bytes_fetched += gap
                self._cache_put(c.pos, skipped)
                c.pos += gap
                c.body_left -= gap
            take = min(n, c.body_left)
            data = c.read_exact(take) if take else b""
            self.bytes_fetched += take
            c.pos += take
            c.body_left -= take
            if take == n:
                self._cache_put(off, data)
                return data
            # body exhausted mid-read: fall through to a new request
            self._cache_put(off, data)
            off += take
            n -= take
            prefix = data
        else:
            prefix = b""
        # fresh ranged request; sequential escalation doubles the
        # chunk, past CHUNK_MAX we request the whole tail (http.c:414)
        want = max(n, c.chunk)
        seq = c.pos == off or c.pos < 0
        c.chunk = min(c.chunk * 2, CHUNK_MAX) if seq else CHUNK_MIN
        if want >= CHUNK_MAX:
            last = self.size - 1
        else:
            last = min(off + want, self.size) - 1
        if last < off:
            return prefix
        for _ in range(2):   # one retry on a dropped keep-alive
            resp = c.request(
                c.path, (f"Range: bytes={off}-{last}",))
            self.requests += 1
            if resp.status == 206:
                cr = resp.headers.get("content-range", "")
                try:
                    got = int(cr.split("bytes", 1)[1].strip()
                              .split("-", 1)[0])
                except (IndexError, ValueError):
                    got = off
                if got != off:
                    c.read_body(resp)
                    c.close()
                    raise NetworkError(
                        f"Content-Range start {got} != requested {off}")
                break
            if resp.status == 200 and off == 0:
                break   # server ignored Range; body starts at 0 anyway
            if resp.status == 416:
                c.read_body(resp)
                return prefix
            c.read_body(resp)
            c.close()
            if resp.status == 200:
                raise NetworkError(
                    "server stopped honoring Range mid-stream")
        else:
            raise NetworkError(f"HTTP {resp.status} on range request")
        cl = _int_header(resp.headers.get("content-length",
                                          last - off + 1),
                         "Content-Length")
        take = min(n, cl)
        data = c.read_exact(take)
        self.bytes_fetched += take
        c.pos = off + take
        c.body_left = cl - take
        if not resp.keep_alive and c.body_left:
            # can't park a body on a closing connection: drain is
            # wasteful, just drop it
            c.close()
        self._cache_put(off, data)
        return prefix + data

    # -- CountingSource surface ---------------------------------------
    def pread(self, off: int, n: int) -> bytes:
        off = max(0, min(off, self.size))
        n = max(0, min(n, self.size - off))
        self.reads += 1
        self.bytes_read += n
        if n == 0:
            return b""
        if self._buf_all is not None:
            return self._buf_all[off : off + n]
        # only what the cache lacks goes to the network: a read that
        # overlaps an earlier one (the readers' probes slide by a page)
        # fetches its new tail alone
        hit = self._cache_get(off, n)
        if len(hit) == n:
            return hit
        return hit + self._fetch(off + len(hit), n - len(hit))

    def close(self):
        for c in self._conns:
            c.close()
        self._conns.clear()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def open_url(url: str, device=None, **kw):
    """Lazy seek reader over a URL — the `op_url` analog
    (opusfile/include/opusfile.h op_open_url).  Returns the same
    reader types as `streaming.seek_reader`, decoding on ``device``
    (CUDA unless the caller names another)."""
    from .device import resolve_device
    from .streaming import seek_reader

    device = resolve_device(device)
    return seek_reader(HTTPSource(url, **kw), device=device)


def load_url(url: str, extension=None, device=None, **kw):
    """Full decode of a URL through the facade on ``device`` (downloads
    the whole resource through the ranged source, then `io.load`)."""
    from .device import resolve_device
    from .io import load

    device = resolve_device(device)
    src = HTTPSource(url, **kw)
    try:
        data = src.pread(0, src.size)
    finally:
        src.close()
    if extension is None:
        path = urlsplit(url).path
        if "." in path.rsplit("/", 1)[-1]:
            extension = path.rsplit(".", 1)[-1].lower()
    return load(data, extension, device)
