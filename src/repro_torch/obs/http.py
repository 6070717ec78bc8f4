"""Stdlib-HTTP scrape endpoint for the metrics registry.

Port of ``repro/obs/http.py``: the standard library only, the same
behaviour and output text line for line.

One daemon thread, ``http.server`` only (no new dependencies):

  * ``GET /metrics``  -> Prometheus text exposition (the scrape callback is
    where services refresh their gauges AND where alert rules are evaluated
    — scrape-path alerting, so an unscrapped process alerts nobody falsely);
  * ``GET /alerts``   -> JSON of currently-active alerts;
  * ``GET /perf``     -> JSON of the top-k slowest executables with their
    roofline utilization (``ExecTimer.report``);
  * ``GET /flight``   -> JSON dump of the flight recorder's recent events
    (previously only reachable via alert-triggered auto-dump);
  * ``GET /healthz``  -> 200 "ok" liveness.

``port=0`` binds an ephemeral port (tests; the bound port is on
``server.port`` after ``start``).
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


class MetricsServer:
    """Threaded scrape endpoint over a ``scrape_fn() -> exposition text``."""

    def __init__(
        self,
        scrape_fn: Callable[[], str],
        *,
        alerts_fn: Optional[Callable[[], list]] = None,
        perf_fn: Optional[Callable[[], dict]] = None,
        flight_fn: Optional[Callable[[], dict]] = None,
        host: str = "127.0.0.1",
        port: int = 0,
    ):
        self.scrape_fn = scrape_fn
        self.alerts_fn = alerts_fn
        self.perf_fn = perf_fn
        self.flight_fn = flight_fn
        self.host = host
        self.port = int(port)
        self._server: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self.scrapes_total = 0

    def start(self) -> "MetricsServer":
        if self._server is not None:
            raise RuntimeError("metrics server already started")
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # keep the serve logs clean
                pass

            def _send(self, code: int, body: bytes, ctype: str):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                path = self.path.split("?", 1)[0]
                try:
                    if path == "/metrics":
                        outer.scrapes_total += 1
                        self._send(200, outer.scrape_fn().encode(), CONTENT_TYPE)
                    elif path == "/alerts" and outer.alerts_fn is not None:
                        body = json.dumps(outer.alerts_fn(), default=float).encode()
                        self._send(200, body, "application/json")
                    elif path == "/perf" and outer.perf_fn is not None:
                        body = json.dumps(outer.perf_fn(), default=float).encode()
                        self._send(200, body, "application/json")
                    elif path == "/flight" and outer.flight_fn is not None:
                        body = json.dumps(outer.flight_fn(), default=float).encode()
                        self._send(200, body, "application/json")
                    elif path == "/healthz":
                        self._send(200, b"ok\n", "text/plain")
                    else:
                        self._send(404, b"not found\n", "text/plain")
                except Exception as e:  # scrape failure must not kill the server
                    self._send(500, f"scrape error: {e}\n".encode(), "text/plain")

        self._server = ThreadingHTTPServer((self.host, self.port), Handler)
        self._server.daemon_threads = True
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="obs-metrics-http", daemon=True
        )
        self._thread.start()
        return self

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def stop(self, timeout: float = 5.0):
        if self._server is None:
            return
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(timeout)
        self._server = self._thread = None
