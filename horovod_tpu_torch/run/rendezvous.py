"""Threaded HTTP key-value store for the launcher (a copy of
``horovod_tpu/run/rendezvous.py``).

Reference: horovod/run/http/http_server.py — `RendezvousServer` and
`KVStoreServer`; payload integrity via HMAC-signed messages
(horovod/run/common/util/secret.py).

The elastic launcher's world rides this store: epoch membership,
heartbeats, the KV collectives of ``elastic/context.py``, the replica tier
of ``ckpt/replica.py`` and worker tracebacks; the function-shipping
``elastic.launch`` puts the pickled function here.

Security model (the reference's): every payload is authenticated with an
HMAC over a per-job secret that travels to workers via the launcher's
env, because the values are pickles — an unauthenticated write would be
remote code execution.  Each MAC binds verb + key + body, so a signature
captured for one operation can never be replayed as another.  All-local
jobs additionally bind loopback only."""

from __future__ import annotations

import hashlib
import hmac
import os
import secrets as _secrets
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.error import HTTPError, URLError

SECRET_ENV = "HVDTPU_SECRET"
_MAC_HEADER = "X-HVDTPU-MAC"


def make_secret() -> str:
    """Per-job shared secret (reference secret.py make_secret_key)."""
    return _secrets.token_hex(32)


def _mac(secret: str, verb: str, key: str, body: bytes = b"") -> str:
    """Every MAC binds verb + key + body (newline-framed; neither verb
    nor key can contain a newline).  Without the verb/key domain
    separation, a signed PUT whose *user-chosen body* spelled out a
    delete token would hand an observer a valid DELETE for that key —
    cross-verb replay is exactly what the binding closes."""
    msg = f"{verb}\n{key}\n".encode() + body
    return hmac.new(secret.encode(), msg, hashlib.sha256).hexdigest()


def _delete_mac(secret: str, key: str) -> str:
    """DELETE has no body: its MAC covers verb + key alone."""
    return _mac(secret, "DELETE", key)


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # silence per-request stderr noise
        pass

    def _key(self) -> str:
        return self.path.lstrip("/")

    def do_PUT(self):
        length = int(self.headers.get("Content-Length", 0))
        value = self.rfile.read(length)
        mac = self.headers.get(_MAC_HEADER, "")
        if not hmac.compare_digest(
            mac, _mac(self.server.secret, "PUT", self._key(), value)  # type: ignore[attr-defined]
        ):
            self.send_response(403)
            self.send_header("Content-Length", "0")
            self.end_headers()
            return
        with self.server.kv_lock:  # type: ignore[attr-defined]
            self.server.kv[self._key()] = value  # type: ignore[attr-defined]
        self.send_response(200)
        self.send_header("Content-Length", "0")
        self.end_headers()

    def do_GET(self):
        if self.path.rstrip("/") == "/healthz":
            # Read-only, unauthenticated liveness probe: operators (and
            # the CI gates) poll this instead of sleeping-and-hoping.
            # Carries only the key count — no values, no pickles, no
            # secret — so it shares /metrics' trust rationale.
            with self.server.kv_lock:  # type: ignore[attr-defined]
                n = len(self.server.kv)  # type: ignore[attr-defined]
            body = (
                '{"status": "ok", "keys": %d}' % n
            ).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
            return
        if self.path.rstrip("/") == "/metrics":
            # Read-only, UNAUTHENTICATED Prometheus exposition of the
            # live telemetry plane (obs/live.py registers the renderer).
            # Deliberately outside the HMAC envelope: scrapers are
            # commodity tools that cannot sign, and the exposition
            # carries only metric values — never pickles, never the
            # secret.  Every mutating verb stays signed.
            render = getattr(self.server, "metrics_render", None)
            if render is None:
                self.send_response(404)
                self.send_header("Content-Length", "0")
                self.end_headers()
                return
            try:
                body = render().encode()
            except Exception:
                # A render bug must not kill the server, but it must be
                # VISIBLE to scrapers: a 200 with an empty body would
                # read as a healthy target with every series absent.
                self.send_response(500)
                self.send_header("Content-Length", "0")
                self.end_headers()
                return
            self.send_response(200)
            self.send_header(
                "Content-Type",
                "text/plain; version=0.0.4; charset=utf-8",
            )
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
            return
        with self.server.kv_lock:  # type: ignore[attr-defined]
            value = self.server.kv.get(self._key())  # type: ignore[attr-defined]
        if value is None:
            self.send_response(404)
            self.send_header("Content-Length", "0")
            self.end_headers()
            return
        self.send_response(200)
        self.send_header("Content-Length", str(len(value)))
        self.send_header(
            _MAC_HEADER,
            _mac(self.server.secret, "GET", self._key(), value),  # type: ignore[attr-defined]
        )
        self.end_headers()
        self.wfile.write(value)

    def do_DELETE(self):
        # Deletes are mutations: signed like PUT, with the MAC bound to
        # method + key (there is no body) — or an unauthenticated client
        # could erase rendezvous worlds and checkpoint replicas out from
        # under a live job, and a captured delete could be replayed
        # against arbitrary keys.
        mac = self.headers.get(_MAC_HEADER, "")
        if not hmac.compare_digest(
            mac, _delete_mac(self.server.secret, self._key())  # type: ignore[attr-defined]
        ):
            self.send_response(403)
            self.send_header("Content-Length", "0")
            self.end_headers()
            return
        with self.server.kv_lock:  # type: ignore[attr-defined]
            self.server.kv.pop(self._key(), None)  # type: ignore[attr-defined]
        self.send_response(200)
        self.send_header("Content-Length", "0")
        self.end_headers()


class KVStoreServer:
    """reference http_server.py `KVStoreServer` (threaded, start/stop).

    ``bind_all=False`` (the all-local default) listens on loopback only."""

    def __init__(self, port: int = 0, *, secret: Optional[str] = None,
                 bind_all: bool = False):
        host = "0.0.0.0" if bind_all else "127.0.0.1"
        self.secret = secret or make_secret()
        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._httpd.kv = {}  # type: ignore[attr-defined]
        self._httpd.kv_lock = threading.Lock()  # type: ignore[attr-defined]
        self._httpd.secret = self.secret  # type: ignore[attr-defined]
        self._httpd.metrics_render = None  # type: ignore[attr-defined]
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    # -- in-process store access (the live telemetry aggregator) ----------
    # The HTTP surface deliberately has no listing verb; the launcher-
    # resident aggregator reads its own store directly instead.

    def scan(self, prefix: str) -> dict:
        """Snapshot of every key under ``prefix`` -> value."""
        with self._httpd.kv_lock:  # type: ignore[attr-defined]
            return {
                k: v
                for k, v in self._httpd.kv.items()  # type: ignore[attr-defined]
                if k.startswith(prefix)
            }

    def discard(self, keys) -> None:
        """Drop consumed keys (bounded memory for the streaming scopes)."""
        with self._httpd.kv_lock:  # type: ignore[attr-defined]
            for k in keys:
                self._httpd.kv.pop(k, None)  # type: ignore[attr-defined]

    def set_metrics_render(self, fn) -> None:
        """Install (or clear, with None) the ``GET /metrics`` renderer —
        a zero-arg callable returning Prometheus exposition text."""
        self._httpd.metrics_render = fn  # type: ignore[attr-defined]

    def start(self) -> int:
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="hvdtpu_kvstore", daemon=True
        )
        self._thread.start()
        return self.port

    def stop(self) -> None:
        self._httpd.shutdown()
        if self._thread:
            self._thread.join(timeout=5)
        self._httpd.server_close()


class KVStoreClient:
    """reference http/http_client.py: authenticated put/get.

    404 means "not published yet" (wait() keeps polling); transport errors
    carry the address so misconfiguration fails loudly, not as a generic
    timeout.

    Connections are PERSISTENT (HTTP/1.1 keep-alive, one per calling
    thread): a fresh TCP connect per call — urllib's behavior — costs a
    connection handshake plus a server-side handler-thread spawn each
    time, which the reference measured as the ceiling of a serving
    fleet's KV traffic, and the replica tier pushes a snapshot in
    thousands of chunks.  A stale or dropped
    connection is re-dialed once per call; every verb here is
    idempotent, so the single retry cannot double-apply anything."""

    def __init__(self, addr: str, secret: Optional[str] = None):
        self._base = f"http://{addr}"
        self._addr = addr
        host, _, port = addr.rpartition(":")
        self._host, self._port = host, int(port)
        self._secret = secret or os.environ.get(SECRET_ENV, "")
        self._local = threading.local()

    def _request(self, method: str, path: str, body: Optional[bytes],
                 headers: dict):
        """One request over the thread's persistent connection; a dead
        connection (server restarted, keep-alive reaped, first use) is
        re-dialed and the request retried ONCE.  Returns (status,
        headers, body).  Connection-refused surfaces as URLError to
        keep wait()'s startup-grace semantics."""
        import http.client  # noqa: PLC0415

        for attempt in (0, 1):
            conn = getattr(self._local, "conn", None)
            try:
                if conn is None:
                    conn = http.client.HTTPConnection(
                        self._host or "127.0.0.1", self._port,
                        timeout=30,
                    )
                    self._local.conn = conn
                conn.request(method, path, body=body, headers=headers)
                resp = conn.getresponse()
                data = resp.read()
                return resp.status, resp.headers, data
            except (http.client.HTTPException, OSError) as e:
                try:
                    conn.close()
                except Exception:
                    pass
                self._local.conn = None
                if attempt or isinstance(e, ConnectionRefusedError):
                    raise URLError(e) from e

    def put(self, scope: str, key: str, value: bytes) -> None:
        status, _, _ = self._request(
            "PUT", f"/{scope}/{key}", value,
            {_MAC_HEADER: _mac(self._secret, "PUT", f"{scope}/{key}",
                               value),
             "Content-Length": str(len(value))},
        )
        if status == 403:
            raise PermissionError(
                f"KV store at {self._addr} rejected the payload signature"
            )
        if status != 200:
            raise HTTPError(f"{self._base}/{scope}/{key}", status,
                            "unexpected status", None, None)

    def delete(self, scope: str, key: str) -> None:
        """Authenticated delete; absent keys are a no-op (the replica
        tier garbage-collects superseded chunks with this)."""
        status, _, _ = self._request(
            "DELETE", f"/{scope}/{key}", None,
            {_MAC_HEADER: _delete_mac(self._secret, f"{scope}/{key}")},
        )
        if status == 403:
            raise PermissionError(
                f"KV store at {self._addr} rejected the delete "
                f"signature"
            )
        if status != 200:
            raise HTTPError(f"{self._base}/{scope}/{key}", status,
                            "unexpected status", None, None)

    def get(self, scope: str, key: str) -> Optional[bytes]:
        """None = key not published yet; raises on transport failure."""
        try:
            status, headers, body = self._request(
                "GET", f"/{scope}/{key}", None, {}
            )
        except URLError as e:
            raise ConnectionError(
                f"cannot reach KV store at {self._addr}: {e.reason}"
            ) from e
        if status == 404:
            return None
        if status != 200:
            raise HTTPError(f"{self._base}/{scope}/{key}", status,
                            "unexpected status", None, None)
        mac = headers.get(_MAC_HEADER, "")
        if not hmac.compare_digest(
            mac, _mac(self._secret, "GET", f"{scope}/{key}", body)
        ):
            raise PermissionError(
                f"KV store at {self._addr} returned a bad payload signature"
            )
        return body

    def wait(self, scope: str, key: str, timeout: float = 120.0) -> bytes:
        """Poll until published.  Transient transport errors are tolerated
        for a short grace window (server may still be starting), then
        surfaced with the address.

        Exponential backoff (50 ms doubling to a 1 s cap): long waits —
        np ranks parked on rendezvous keys, plus the live-stats PUT
        traffic — must not hammer the launcher's single HTTP server with
        fixed-rate polls at np=64."""
        deadline = time.time() + timeout
        grace = time.time() + 5.0
        delay = 0.05
        last_err: Optional[Exception] = None
        while time.time() < deadline:
            try:
                value = self.get(scope, key)
            except ConnectionError as e:
                if time.time() > grace:
                    raise
                last_err = e
                value = None
            if value is not None:
                return value
            time.sleep(min(delay, max(deadline - time.time(), 0.01)))
            delay = min(delay * 2, 1.0)
        raise TimeoutError(
            f"KV key {scope}/{key} not published at {self._addr} within "
            f"{timeout}s" + (f" (last error: {last_err})" if last_err else "")
        )
