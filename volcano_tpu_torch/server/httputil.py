"""Shared HTTP plumbing for the control-plane servers (state server,
webhook manager): JSON responses with broken-pipe tolerance and the
bound-handler + threaded-server bootstrap."""

from __future__ import annotations

import gzip
import json
import threading
from http.server import ThreadingHTTPServer

# bodies below this stay plain: gzip's ~20-byte header + the deflate
# call cost more than the wire bytes they save on small control
# responses ({"ok":true} and friends)
GZIP_MIN_BYTES = 512


def read_json_body(resp):
    """Client half of the encoding negotiation: read an http.client
    response and parse JSON, inflating a gzip'd body.  Lives beside
    the compression half (json_response) so the two can never drift —
    every wire client (RemoteCluster, AuditExporter) reads through
    here."""
    body = resp.read()
    if resp.headers.get("Content-Encoding") == "gzip":
        body = gzip.decompress(body)
    return json.loads(body)


def json_response(handler, code: int, payload, headers=None,
                  trickle_ms: float = 0.0) -> None:
    """Write a JSON response; a client that went away mid-response
    (killed scheduler, cancelled watch) is routine, not an error.

    headers: extra response headers (e.g. Retry-After on the read-only
    degrade 503s).  trickle_ms > 0 is the injected slow-loris fault:
    the body dribbles out in tiny chunks with that gap between them —
    a complete but pathologically slow response, the gray-failure
    shape timeouts exist for.

    Large SUCCESS bodies are gzip-compressed when the client
    advertised `Accept-Encoding: gzip` — snapshot/watch payloads are
    the wire fast lane's dominant byte cost and JSON object dumps
    deflate 5-10x.  Level 1: the hot bodies are codec output
    (repetitive tag strings), where higher levels buy little but cost
    CPU.  Error bodies stay plain regardless: urllib surfaces them
    through HTTPError.read(), which every client parses raw for the
    diagnostic message — a gzip'd 422 would turn an admission veto's
    reason into mojibake exactly when the operator needs it."""
    body = json.dumps(payload, separators=(",", ":")).encode()
    encoding = ""
    if code < 400 and len(body) >= GZIP_MIN_BYTES and "gzip" in (
            handler.headers.get("Accept-Encoding") or ""):
        body = gzip.compress(body, compresslevel=1)
        encoding = "gzip"
    try:
        handler.send_response(code)
        handler.send_header("Content-Type", "application/json")
        if encoding:
            handler.send_header("Content-Encoding", encoding)
        handler.send_header("Content-Length", str(len(body)))
        for name, value in (headers or {}).items():
            handler.send_header(name, str(value))
        handler.end_headers()
        if trickle_ms > 0:
            import time as _time
            # first ~1KB in 64-byte sips, the rest in one gulp: slow
            # enough to exercise client timeouts, bounded enough that
            # a patient client still completes
            for i in range(0, min(len(body), 1024), 64):
                handler.wfile.write(body[i:i + 64])
                handler.wfile.flush()
                _time.sleep(trickle_ms / 1000.0)
            handler.wfile.write(body[min(len(body), 1024):])
        else:
            handler.wfile.write(body)
    except (BrokenPipeError, ConnectionResetError):
        handler.close_connection = True


def serve_threaded(handler_base: type, attrs: dict, port: int,
                   name: str, tls_cert: str = "",
                   tls_key: str = "") -> ThreadingHTTPServer:
    """Bind per-server state onto a handler subclass and serve it on
    127.0.0.1:port (0 = ephemeral) from a daemon thread.  With
    tls_cert/tls_key the listener speaks TLS only — a plaintext client
    is refused during the handshake (reference: the webhook manager is
    TLS-only, cmd/webhook-manager/)."""
    # per-connection timeout (handler.setup applies it to the socket):
    # a silent peer must pin at most one worker thread, and must be
    # longer than the /watch long-poll ceiling (55s)
    attrs = dict(attrs, timeout=65)
    handler = type("BoundHandler", (handler_base,), attrs)
    httpd = ThreadingHTTPServer(("127.0.0.1", port), handler)
    if tls_cert:
        from volcano_tpu_torch.server.tlsutil import server_ssl_context
        # handshake lazily on first read IN THE WORKER THREAD — with
        # do_handshake_on_connect a stalled client would block the
        # single accept loop and take down the whole listener
        httpd.socket = server_ssl_context(tls_cert, tls_key).wrap_socket(
            httpd.socket, server_side=True,
            do_handshake_on_connect=False)
    httpd.daemon_threads = True
    threading.Thread(target=httpd.serve_forever, name=name,
                     daemon=True).start()
    return httpd
