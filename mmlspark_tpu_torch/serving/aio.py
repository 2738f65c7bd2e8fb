"""Async HTTP/1.1 transport: event-loop ingress + pooled keep-alive client.

Counterpart of the reference's ``mmlspark_tpu/serving/aio.py``. The
thread-per-connection ``ThreadingHTTPServer`` ingress spends a thread (and
its stack) per open socket and a fresh TCP handshake per non-keep-alive
client. This module is the high-concurrency replacement both
``ServingServer`` and ``RoutingFront`` mount behind their
``http_mode="async"`` knob:

  - ``AsyncHTTPServer``: one event loop on one dedicated thread handles every
    connection. Keep-alive is the default (HTTP/1.1), and reads are
    PIPELINED: a connection's parser keeps reading requests while earlier
    ones await their batch, with responses written strictly in order
    (bounded by ``pipeline_depth`` so a flooding client cannot queue
    unbounded work). Handlers are coroutines; the serving bridge awaits the
    reply-slot future the batch loop fulfills, so thousands of idle
    keep-alive connections cost file descriptors, not threads.
  - ``AsyncConnectionPool``: the client side for the routing front's
    forwards — per-worker keep-alive connection reuse instead of a fresh
    ``urlopen`` socket per hop, with a single stale-connection retry (a
    pooled socket the worker closed while idle).

The parser is deliberately minimal: Content-Length bodies only (chunked
uploads get 411 — no serving client streams chunks), header block bounded by
the stream reader's line limit, body bounded by ``max_body``.
"""

from __future__ import annotations

import asyncio
import threading
import time
from collections import deque
from typing import Awaitable, Callable, Dict, Optional, Tuple
from urllib.parse import urlsplit

__all__ = ["AsyncConnectionPool", "AsyncHTTPServer", "Headers",
           "HTTPRequest", "HTTPResponse"]

#: readline() bound — caps request-line and each header line (and therefore
#: the whole header block, via _MAX_HEADERS lines)
_LINE_LIMIT = 16384
_MAX_HEADERS = 100
_REASONS = {200: "OK", 204: "No Content", 400: "Bad Request",
            403: "Forbidden", 404: "Not Found", 408: "Request Timeout",
            411: "Length Required", 413: "Payload Too Large",
            500: "Internal Server Error", 502: "Bad Gateway",
            503: "Service Unavailable", 504: "Gateway Timeout"}


class Headers(dict):
    """Plain dict of header name -> value (received casing preserved, so
    journaled rows match the threaded transport byte-for-byte) with a
    case-insensitive ``get`` — the lookup convention every consumer
    (``deadline_from_headers``, ``context_from_headers``) already uses."""

    def get(self, key, default=None):  # type: ignore[override]
        v = dict.get(self, key)
        if v is not None:
            return v
        lk = str(key).lower()
        for k, kv in self.items():
            if str(k).lower() == lk:
                return kv
        return default


class HTTPRequest:
    __slots__ = ("method", "path", "headers", "body", "version")

    def __init__(self, method: str, path: str, headers: Headers,
                 body: bytes, version: str = "HTTP/1.1"):
        self.method = method
        self.path = path
        self.headers = headers
        self.body = body
        self.version = version


class HTTPResponse:
    __slots__ = ("status", "body", "content_type", "extra")

    def __init__(self, status: int, body: bytes = b"",
                 content_type: str = "application/json",
                 extra: Optional[Dict[str, str]] = None):
        self.status = int(status)
        self.body = bytes(body)
        self.content_type = content_type
        self.extra = extra

    def render(self, keep_alive: bool) -> bytes:
        reason = _REASONS.get(self.status, "Unknown")
        lines = [f"HTTP/1.1 {self.status} {reason}",
                 f"Content-Type: {self.content_type}",
                 f"Content-Length: {len(self.body)}"]
        for k, v in (self.extra or {}).items():
            lines.append(f"{k}: {v}")
        lines.append("Connection: %s" %
                     ("keep-alive" if keep_alive else "close"))
        return ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1") + self.body


class AsyncHTTPServer:
    """Keep-alive, pipelined HTTP/1.1 server on a dedicated event loop.

    ``handler``: ``async (HTTPRequest) -> HTTPResponse``. Runs on the loop
    thread — it must never block (the serving bridge awaits reply-slot
    events instead). Lifecycle mirrors the threaded transport: ``start()``
    binds (resolving port 0), ``stop()`` closes every connection and joins
    the loop thread. ``stats()`` exposes connection/request counters — the
    load test's proof that 64 concurrent keep-alive clients ride one thread.
    """

    def __init__(self, host: str, port: int,
                 handler: Callable[[HTTPRequest], Awaitable[HTTPResponse]],
                 name: str = "aio-http", max_body: int = 1 << 31,
                 idle_timeout_s: float = 75.0, body_timeout_s: float = 60.0,
                 pipeline_depth: int = 8):
        self.host = host
        self.port = port
        self.handler = handler
        self.name = name
        self.max_body = int(max_body)
        self.idle_timeout_s = float(idle_timeout_s)
        self.body_timeout_s = float(body_timeout_s)
        self.pipeline_depth = max(1, int(pipeline_depth))
        self.loop: Optional[asyncio.AbstractEventLoop] = None
        self._thread: Optional[threading.Thread] = None
        self._server: Optional[asyncio.AbstractServer] = None
        self._started = threading.Event()
        self._start_err: Optional[BaseException] = None
        self._stopping = False
        # counters mutated on the loop thread only; read anywhere (ints)
        self.connections_total = 0
        self.open_connections = 0
        self.peak_open_connections = 0
        self.requests_total = 0

    # -- lifecycle -------------------------------------------------------
    def start(self) -> "AsyncHTTPServer":
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=self.name)
        self._thread.start()
        self._started.wait(timeout=10)
        if self._start_err is not None:
            self._thread.join(timeout=5)
            raise self._start_err
        if not self._started.is_set():
            raise RuntimeError(f"{self.name}: event loop failed to start")
        return self

    def _run(self) -> None:
        loop = asyncio.new_event_loop()
        asyncio.set_event_loop(loop)
        self.loop = loop
        try:
            try:
                self._server = loop.run_until_complete(asyncio.start_server(
                    self._serve_conn, self.host, self.port,
                    limit=_LINE_LIMIT))
                self.port = self._server.sockets[0].getsockname()[1]
            except BaseException as e:  # bind failure -> surface in start()
                self._start_err = e
                return
            finally:
                self._started.set()
            loop.run_forever()
            # stop() requested: close the listener, then cancel the live
            # connections BEFORE waiting for the server to close (since
            # Python 3.12 ``wait_closed`` waits for every connection, so a
            # kept-alive client would hold the loop open and keep being
            # served by a stopped server)
            self._server.close()
            tasks = [t for t in asyncio.all_tasks(loop) if not t.done()]
            for t in tasks:
                t.cancel()
            if tasks:
                loop.run_until_complete(
                    asyncio.gather(*tasks, return_exceptions=True))
            loop.run_until_complete(self._server.wait_closed())
        finally:
            try:
                loop.run_until_complete(loop.shutdown_asyncgens())
            except Exception:  # noqa: BLE001 — closing anyway
                pass
            loop.close()

    def stop(self) -> None:
        self._stopping = True
        if self.loop is not None and self.loop.is_running():
            self.loop.call_soon_threadsafe(self.loop.stop)
        if self._thread is not None:
            self._thread.join(timeout=10)

    def stats(self) -> Dict[str, int]:
        return {"connections_total": self.connections_total,
                "open_connections": self.open_connections,
                "peak_open_connections": self.peak_open_connections,
                "requests_total": self.requests_total}

    # -- connection handling ---------------------------------------------
    async def _serve_conn(self, reader: asyncio.StreamReader,
                          writer: asyncio.StreamWriter) -> None:
        self.connections_total += 1
        self.open_connections += 1
        self.peak_open_connections = max(self.peak_open_connections,
                                         self.open_connections)
        # responses must leave in request order (HTTP/1.1 pipelining): the
        # read side parses ahead and queues handler tasks; the write side
        # drains them in order. maxsize bounds a flooding client.
        resp_q: "asyncio.Queue" = asyncio.Queue(maxsize=self.pipeline_depth)
        w_task = asyncio.ensure_future(self._write_loop(writer, resp_q))
        try:
            while True:
                try:
                    req, keep = await self._read_request(reader)
                except _ParseError as e:
                    await resp_q.put((_done(HTTPResponse(
                        e.status, b'{"error": "%s"}' %
                        e.msg.encode("latin-1", "replace"))), False))
                    break
                except (asyncio.TimeoutError, asyncio.IncompleteReadError,
                        ConnectionError):
                    break
                if req is None:
                    break
                task = asyncio.ensure_future(self._dispatch(req))
                await resp_q.put((task, keep))
                if not keep:
                    break
        except asyncio.CancelledError:
            pass
        finally:
            await resp_q.put(None)
            try:
                await w_task
            except asyncio.CancelledError:
                pass
            try:
                writer.close()
                await writer.wait_closed()
            except Exception:  # noqa: BLE001 — peer already gone
                pass
            self.open_connections -= 1

    async def _dispatch(self, req: HTTPRequest) -> HTTPResponse:
        try:
            resp = await self.handler(req)
        except asyncio.CancelledError:
            raise
        except Exception as e:  # noqa: BLE001 — a request fails, not the loop
            resp = HTTPResponse(500, b'{"error": "%s"}' %
                                str(e).encode("latin-1", "replace"))
        self.requests_total += 1
        return resp

    async def _write_loop(self, writer: asyncio.StreamWriter,
                          resp_q: "asyncio.Queue") -> None:
        # runs until the reader enqueues None: even after the peer vanishes
        # or a close-response, keep DRAINING the queue (discarding) so a
        # reader blocked on a full pipeline queue can never deadlock
        alive = True
        while True:
            item = await resp_q.get()
            if item is None:
                return
            task, keep = item
            try:
                resp = await task
            except asyncio.CancelledError:
                return  # server shutdown
            if not alive:
                continue
            try:
                writer.write(resp.render(keep))
                await writer.drain()
            except (ConnectionError, RuntimeError):
                alive = False
                continue
            if not keep:
                alive = False

    async def _read_request(self, reader: asyncio.StreamReader
                            ) -> Tuple[Optional[HTTPRequest], bool]:
        try:
            line = await asyncio.wait_for(reader.readline(),
                                          self.idle_timeout_s)
        except ValueError as e:  # line over the reader limit
            raise _ParseError(400, "request line too long") from e
        if not line:
            return None, False  # clean EOF between requests
        parts = line.decode("latin-1").strip().split()
        if len(parts) != 3 or not parts[2].startswith("HTTP/"):
            raise _ParseError(400, "malformed request line")
        method, target, version = parts
        headers = Headers()
        for _ in range(_MAX_HEADERS):
            try:
                hline = await asyncio.wait_for(reader.readline(),
                                               self.body_timeout_s)
            except ValueError as e:
                raise _ParseError(400, "header line too long") from e
            if hline in (b"\r\n", b"\n", b""):
                break
            k, sep, v = hline.decode("latin-1").partition(":")
            if not sep:
                raise _ParseError(400, "malformed header")
            headers[k.strip()] = v.strip()
        else:
            raise _ParseError(400, "too many headers")
        if "chunked" in str(headers.get("Transfer-Encoding", "")).lower():
            raise _ParseError(411, "chunked bodies unsupported")
        try:
            length = int(headers.get("Content-Length", 0) or 0)
        except ValueError as e:
            raise _ParseError(400, "bad Content-Length") from e
        if length < 0 or length > self.max_body:
            raise _ParseError(413, "body too large")
        body = b""
        if length:
            body = await asyncio.wait_for(reader.readexactly(length),
                                          self.body_timeout_s)
        conn = str(headers.get("Connection", "")).lower()
        keep = conn != "close" and not (version == "HTTP/1.0"
                                        and "keep-alive" not in conn)
        return HTTPRequest(method, target, headers, body, version), keep


class _ParseError(Exception):
    def __init__(self, status: int, msg: str):
        super().__init__(msg)
        self.status = status
        self.msg = msg


def _done(resp: HTTPResponse) -> "asyncio.Future":
    fut: "asyncio.Future" = asyncio.get_running_loop().create_future()
    fut.set_result(resp)
    return fut


# ---------------------------------------------------------------------------
# Pooled keep-alive client (the routing front's forward hop)
# ---------------------------------------------------------------------------


class AsyncConnectionPool:
    """Per-host keep-alive connection reuse for loop-thread HTTP requests.

    ``request()`` returns ``(status, Headers, body)`` — HTTP error statuses
    are RETURNED, not raised (the front treats any worker answer as
    authoritative); transport failures raise ``OSError`` /
    ``asyncio.TimeoutError`` so the caller's retry/circuit logic sees the
    same taxonomy the urlopen path produced. A request that finds its pooled
    socket closed by the peer before any response byte retries ONCE on a
    fresh connection (never after partial reads — no double-processing)."""

    def __init__(self, per_host: int = 8, idle_s: float = 30.0):
        self.per_host = max(1, int(per_host))
        self.idle_s = float(idle_s)
        self._idle: Dict[Tuple[str, int], deque] = {}

    async def request(self, method: str, url: str, body: bytes = b"",
                      headers: Optional[Dict[str, str]] = None,
                      timeout: Optional[float] = None,
                      deadline=None) -> Tuple[int, Headers, bytes]:
        """``deadline`` (core/faults.Deadline, or any object exposing
        ``remaining()``): gates the single stale-socket retry — a retry
        that would start after the request's deadline already lapsed is an
        answer nobody is waiting for (the caller's ``timeout`` bounds the
        total wall time either way; the gate makes the expiry an immediate
        error instead of a doomed second connection)."""
        parts = urlsplit(url)
        host = parts.hostname or "127.0.0.1"
        port = parts.port or (443 if parts.scheme == "https" else 80)
        path = parts.path or "/"
        if parts.query:
            path += "?" + parts.query
        return await asyncio.wait_for(
            self._request((host, port), method, path, body, headers,
                          deadline),
            timeout)

    async def _request(self, key: Tuple[str, int], method: str, path: str,
                       body: bytes, headers: Optional[Dict[str, str]],
                       deadline=None) -> Tuple[int, Headers, bytes]:
        for attempt in (0, 1):
            fresh, (reader, writer) = await self._checkout(key, attempt == 1)
            try:
                req = [f"{method} {path} HTTP/1.1",
                       f"Host: {key[0]}:{key[1]}",
                       f"Content-Length: {len(body)}"]
                for k, v in (headers or {}).items():
                    if k.lower() not in ("host", "content-length",
                                         "connection"):
                        req.append(f"{k}: {v}")
                req.append("Connection: keep-alive")
                writer.write(("\r\n".join(req) + "\r\n\r\n"
                              ).encode("latin-1") + body)
                await writer.drain()
                status, rhdrs, rbody, reusable = await _read_response(reader)
            except (ConnectionError, asyncio.IncompleteReadError,
                    _StaleConnection) as e:
                self._discard(writer)
                # a reused socket the peer closed while idle: one retry on a
                # fresh connection; a fresh-connection failure is real —
                # and the retry must still be worth making: past the
                # request's X-MMLSpark-Deadline it can only waste a socket
                if not fresh and attempt == 0:
                    if deadline is not None and deadline.remaining() <= 0:
                        raise OSError(
                            f"connection to {key[0]}:{key[1]} went stale "
                            f"and the deadline expired before the retry"
                        ) from e
                    continue
                raise OSError(f"connection to {key[0]}:{key[1]} failed: {e}"
                              ) from e
            except BaseException:
                self._discard(writer)
                raise
            if reusable:
                self._checkin(key, reader, writer)
            else:
                self._discard(writer)
            return status, rhdrs, rbody
        raise OSError(f"connection to {key[0]}:{key[1]} failed")

    async def _checkout(self, key, force_fresh: bool):
        pool = self._idle.setdefault(key, deque())
        now = time.monotonic()
        while pool and not force_fresh:
            reader, writer, t = pool.popleft()
            if now - t > self.idle_s or writer.is_closing():
                self._discard(writer)
                continue
            return False, (reader, writer)
        return True, await asyncio.open_connection(*key)

    def _checkin(self, key, reader, writer) -> None:
        pool = self._idle.setdefault(key, deque())
        if len(pool) >= self.per_host or writer.is_closing():
            self._discard(writer)
            return
        pool.append((reader, writer, time.monotonic()))

    @staticmethod
    def _discard(writer) -> None:
        try:
            writer.close()
        except Exception:  # noqa: BLE001
            pass

    def close(self) -> None:
        for pool in self._idle.values():
            while pool:
                _, writer, _ = pool.popleft()
                self._discard(writer)


class _StaleConnection(Exception):
    pass


async def _read_response(reader: asyncio.StreamReader
                         ) -> Tuple[int, Headers, bytes, bool]:
    """Parse one HTTP/1.1 response: (status, headers, body, reusable)."""
    line = await reader.readline()
    if not line:
        raise _StaleConnection("peer closed before status line")
    parts = line.decode("latin-1").strip().split(None, 2)
    if len(parts) < 2 or not parts[0].startswith("HTTP/"):
        raise _StaleConnection(f"bad status line {line!r}")
    status = int(parts[1])
    headers = Headers()
    for _ in range(_MAX_HEADERS):
        hline = await reader.readline()
        if hline in (b"\r\n", b"\n", b""):
            break
        k, sep, v = hline.decode("latin-1").partition(":")
        if sep:
            headers[k.strip()] = v.strip()
    clen = headers.get("Content-Length")
    if clen is not None:
        body = await reader.readexactly(int(clen))
        reusable = str(headers.get("Connection", "")).lower() != "close"
    else:
        body = await reader.read()  # until EOF: connection not reusable
        reusable = False
    return status, headers, body, reusable
