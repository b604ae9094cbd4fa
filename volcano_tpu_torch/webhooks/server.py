"""Standalone webhook-manager process — the vc-webhook-manager binary.

Reference parity: cmd/webhook-manager + pkg/webhooks/router
(admission.go:35).  In the reference, admission runs as its OWN
deployment: the apiserver calls out to it over HTTPS for every create.
Here the state server does the same when started with --webhook-url:
instead of running the embedded chain, it POSTs the object to this
process's /admit route and stores whatever comes back (mutations
included), rejecting on a webhook veto.

The webhook process holds its own read-only LIST+WATCH mirror of the
state server (a RemoteCluster), the analogue of the reference
webhooks' informer-backed listers — cross-object checks (queue
exists/open, hierarchy cycles) read the mirror, never call back into
the serving request.

Run:  volcano-tpu-webhook --cluster-url http://HOST:PORT --port 7443
"""

from __future__ import annotations

import argparse
import json
import logging
import threading
from http.server import BaseHTTPRequestHandler

from volcano_tpu_torch.api import codec
from volcano_tpu_torch.server.httputil import json_response, serve_threaded
from volcano_tpu_torch.webhooks.admission import AdmissionError, default_admission

log = logging.getLogger(__name__)

ADMIT_METHODS = frozenset({
    "admit_job", "admit_job_update", "admit_queue", "admit_podgroup",
    "admit_hypernode", "admit_pod", "admit_jobflow", "admit_cronjob",
})


class WebhookServer:
    """Admission chain + a read-only cluster mirror for cross-object
    validation."""

    def __init__(self, cluster=None):
        self.chain = default_admission()
        self.cluster = cluster          # RemoteCluster mirror or None

    def admit(self, method: str, obj):
        if method not in ADMIT_METHODS:
            raise AdmissionError(f"unknown admission method {method!r}")
        return getattr(self.chain, method)(obj, self.cluster)


class _Handler(BaseHTTPRequestHandler):
    server_version = "volcano-tpu-webhook"
    protocol_version = "HTTP/1.1"
    hooks: WebhookServer = None          # injected by serve_webhooks()
    token: str = ""                      # bearer token for /admit

    def _json(self, code: int, payload: dict):
        json_response(self, code, payload)

    def do_GET(self):  # noqa: N802
        if self.path == "/healthz":
            return self._json(200, {"ok": True})
        return self._json(404, {"error": f"no route {self.path}"})

    def do_POST(self):  # noqa: N802
        from volcano_tpu_torch.server.tlsutil import token_ok
        if not token_ok(self.token, self.headers.get("Authorization")):
            return self._json(401, {"error": "missing or invalid "
                                             "bearer token"})
        if self.path != "/admit":
            return self._json(404, {"error": f"no route {self.path}"})
        try:
            length = int(self.headers.get("Content-Length", "0"))
            payload = json.loads(self.rfile.read(length))
            obj = codec.decode(payload["obj"])
            out = self.hooks.admit(payload["method"], obj)
            return self._json(200, {"ok": True,
                                    "obj": codec.encode(out)})
        except AdmissionError as e:
            return self._json(200, {"ok": False, "error": str(e)})
        except Exception as e:  # noqa: BLE001 - malformed request
            log.exception("webhook request failed")
            return self._json(400, {"ok": False, "error": str(e)})

    def log_message(self, *args):  # quiet
        pass


def serve_webhooks(port: int = 0, cluster=None, tls_cert: str = "",
                   tls_key: str = "", token: str = ""):
    """Start the webhook HTTP server (daemon thread); returns httpd."""
    return serve_threaded(_Handler, {"hooks": WebhookServer(cluster),
                                     "token": token},
                          port, "webhook-server",
                          tls_cert=tls_cert, tls_key=tls_key)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="volcano-tpu-webhook")
    parser.add_argument("--port", type=int, default=7443)
    parser.add_argument("--cluster-url", default="",
                        help="state server to mirror for cross-object "
                             "validation (informer-lister analogue)")
    parser.add_argument("--tls-cert", default="",
                        help="serve TLS with this certificate (PEM)")
    parser.add_argument("--tls-key", default="")
    parser.add_argument("--token", default="",
                        help="cluster bearer token: required of "
                             "callers of /admit AND presented to the "
                             "state server")
    parser.add_argument("--token-file", default="")
    parser.add_argument("--ca-cert", default="",
                        help="CA bundle for the state-server mirror")
    parser.add_argument("--insecure", action="store_true",
                        help="skip state-server cert verification")
    parser.add_argument("-v", "--verbose", action="store_true")
    args = parser.parse_args(argv)
    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format="%(asctime)s %(levelname).1s %(name)s: %(message)s")
    from volcano_tpu_torch.server.tlsutil import load_token
    token = load_token(args.token, args.token_file)
    cluster = None
    if args.cluster_url:
        from volcano_tpu_torch.cache.remote_cluster import RemoteCluster
        cluster = RemoteCluster(args.cluster_url, token=token,
                                ca_cert=args.ca_cert,
                                insecure=args.insecure)
    httpd = serve_webhooks(args.port, cluster,
                           tls_cert=args.tls_cert,
                           tls_key=args.tls_key, token=token)
    log.info("webhook manager listening on :%d",
             httpd.server_address[1])
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.shutdown()
        if cluster is not None:
            cluster.close()
    return 0


class RemoteAdmission:
    """Admission proxy the STATE SERVER uses when --webhook-url is set:
    every create/update POSTs to the external webhook manager, exactly
    like the apiserver calling a registered webhook.

    failure_policy: "Fail" rejects when the webhook is unreachable
    (the reference default), "Ignore" admits unvalidated.
    """

    # class-level defaults so instances unpickled from PRE-auth state
    # files resolve these without tripping __getattr__
    token = ""
    _tls = ("", False)

    def __init__(self, url: str, timeout: float = 5.0,
                 failure_policy: str = "Fail", token: str = "",
                 ca_cert: str = "", insecure: bool = False):
        self.url = url.rstrip("/")
        self.timeout = timeout
        self.failure_policy = failure_policy
        self.token = token
        self._tls = (ca_cert, insecure)

    # the ssl context is rebuilt after unpickling (state files may
    # carry a RemoteAdmission; contexts don't pickle)
    @property
    def _ssl_ctx(self):
        ctx = self.__dict__.get("_ssl_ctx_cached")
        if ctx is None and any(getattr(self, "_tls", ("", False))):
            from volcano_tpu_torch.server.tlsutil import client_ssl_context
            ctx = client_ssl_context(*self._tls)
            self.__dict__["_ssl_ctx_cached"] = ctx
        return ctx

    def __getstate__(self):
        state = self.__dict__.copy()
        state.pop("_ssl_ctx_cached", None)
        return state

    def _call(self, method: str, obj, cluster=None):
        import urllib.request
        del cluster   # the webhook process uses its own mirror
        body = json.dumps({"method": method,
                           "obj": codec.encode(obj)}).encode()
        headers = {"Content-Type": "application/json"}
        if self.token:
            headers["Authorization"] = f"Bearer {self.token}"
        req = urllib.request.Request(
            self.url + "/admit", data=body, method="POST",
            headers=headers)
        try:
            with urllib.request.urlopen(req, timeout=self.timeout,
                                        context=self._ssl_ctx) as resp:
                payload = json.loads(resp.read())
        except Exception as e:  # noqa: BLE001 - webhook down/unreachable
            if self.failure_policy == "Ignore":
                log.warning("webhook %s unreachable (%s); admitting "
                            "per failurePolicy=Ignore", self.url, e)
                return obj
            raise AdmissionError(
                f"admission webhook unreachable: {e}") from None
        if not payload.get("ok"):
            raise AdmissionError(payload.get("error", "webhook denied"))
        return codec.decode(payload["obj"])

    def __getattr__(self, name: str):
        if name in ADMIT_METHODS:
            return lambda obj, cluster=None: self._call(name, obj,
                                                        cluster)
        raise AttributeError(name)


if __name__ == "__main__":
    raise SystemExit(main())
