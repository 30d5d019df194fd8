"""Zero-dependency HTTP scrape endpoint: /metrics + /timeline.

A live soak (or the future multi-process fleet) is watchable without
stopping it: ``ScrapeServer`` serves the Prometheus text exposition of
the registry at ``/metrics``, the recorder's recent timeline as JSON at
``/timeline`` (``?n=K`` bounds the tail), the installed flight
recorder's bundle inventory at ``/flight``, and a liveness probe at
``/healthz`` — stdlib ``http.server`` only, one daemon thread, bound to
loopback by default.

Knobs (docs/TELEMETRY.md): ``PTPU_METRICS_PORT`` (set -> ``enable()``
auto-starts a server there; 0 picks a free port, printed on stderr) and
``PTPU_METRICS_HOST`` (default 127.0.0.1 — never expose a debug
endpoint beyond loopback by default).
"""
from __future__ import annotations

import json
import os
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from . import export as _export
from . import flight as _flight

__all__ = ["ScrapeServer", "start_from_env", "maybe_start_from_env"]

_ENV_PORT = "PTPU_METRICS_PORT"
_ENV_HOST = "PTPU_METRICS_HOST"

#: Prometheus text exposition content type (version is part of the
#: scrape contract, not decoration)
_PROM_CTYPE = "text/plain; version=0.0.4; charset=utf-8"


class ScrapeServer:
    """One registry (+ optional recorder) behind an HTTP endpoint."""

    def __init__(self, registry, recorder=None, *, port=0,
                 host="127.0.0.1", replica_id=None):
        self.registry = registry
        self.recorder = recorder
        self._host = host
        self._want_port = int(port)
        self._httpd = None
        self._thread = None
        #: fleet replica id, if this endpoint serves a child process
        #: (shows up in /healthz and the scrape_endpoint gauge label)
        self.replica_id = replica_id

    # -- lifecycle -----------------------------------------------------------
    @property
    def port(self):
        return (self._httpd.server_address[1] if self._httpd
                else self._want_port)

    @property
    def url(self):
        return f"http://{self._host}:{self.port}"

    def start(self):
        if self._httpd is not None:
            return self
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):       # silent: a scrape every
                pass                         # few seconds is not a log

            def do_GET(self):
                server._handle(self)

        self._httpd = ThreadingHTTPServer(
            (self._host, self._want_port), Handler)
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name="ptpu-scrape")
        self._thread.start()
        # Register the bound (possibly auto-picked) port on the registry
        # so a supervisor scraping the parent can discover child
        # endpoints: `port=0` is resolved by the kernel, and the only
        # in-band channel back out is a metric.
        try:
            label = (str(self.replica_id) if self.replica_id is not None
                     else "main")
            self.registry.gauge(
                "scrape_endpoint",
                "bound port of a /metrics scrape endpoint, by replica",
                ("replica",)).set(float(self.port), (label,))
        except Exception:       # a scrape endpoint must never kill boot
            pass
        return self

    def stop(self):
        httpd, self._httpd = self._httpd, None
        t, self._thread = self._thread, None
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        if t is not None:
            t.join(timeout=10)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False

    # -- routing -------------------------------------------------------------
    def _handle(self, req):
        parsed = urlparse(req.path)
        route = parsed.path.rstrip("/") or "/"
        try:
            if route == "/metrics":
                body = _export.export_prometheus(
                    self.registry).encode()
                self._send(req, 200, _PROM_CTYPE, body)
            elif route == "/timeline":
                q = parse_qs(parsed.query)
                try:
                    n = int(q.get("n", ["50"])[0])
                except ValueError:
                    self._send_json(req, 400,
                                    {"error": "n must be an integer"})
                    return
                view = (self.recorder.timeline_view(n=n)
                        if self.recorder is not None
                        else {"schema": None, "samples": [],
                              "total_samples": 0,
                              "error": "no recorder attached"})
                self._send_json(req, 200, view)
            elif route == "/flight":
                fr = _flight.get()
                self._send_json(req, 200, fr.summary() if fr is not None
                                else {"installed": False})
            elif route in ("/", "/healthz"):
                self._send_json(req, 200, {
                    "ok": True,
                    "enabled": bool(getattr(self.registry, "enabled",
                                            False)),
                    "replica_id": self.replica_id,
                    "pid": os.getpid(),
                    "port": self.port,
                    "routes": ["/metrics", "/timeline", "/flight",
                               "/healthz"]})
            else:
                self._send_json(req, 404, {"error": f"no route "
                                           f"{route!r}"})
        except BrokenPipeError:        # scraper went away mid-response
            pass

    @staticmethod
    def _send(req, code, ctype, body):
        req.send_response(code)
        req.send_header("Content-Type", ctype)
        req.send_header("Content-Length", str(len(body)))
        req.end_headers()
        req.wfile.write(body)

    def _send_json(self, req, code, obj):
        self._send(req, code, "application/json",
                   json.dumps(obj).encode())


def start_from_env(registry, recorder=None, environ=None):
    """PTPU_METRICS_PORT -> a started ScrapeServer, else None."""
    env = environ if environ is not None else os.environ
    port = env.get(_ENV_PORT)
    if not port:
        return None
    try:
        port = int(port)
    except ValueError:
        sys.stderr.write(
            f"# telemetry: ignoring non-integer {_ENV_PORT}={port!r}\n")
        return None
    server = ScrapeServer(registry, recorder, port=port,
                          host=env.get(_ENV_HOST, "127.0.0.1")).start()
    sys.stderr.write(f"# telemetry: scrape endpoint at {server.url}"
                     "/metrics (+ /timeline, /flight)\n")
    return server


_AUTO = [None]


def maybe_start_from_env(registry, recorder=None):
    """Idempotent env auto-start used by ``telemetry.enable()``."""
    if _AUTO[0] is None:
        _AUTO[0] = start_from_env(registry, recorder)
    return _AUTO[0]
