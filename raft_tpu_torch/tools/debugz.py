"""debugz: the live HTTP front door over the observability planes.

Counterpart of the reference repository's ``tools/debugz.py``
(:class:`DebugzServer`), kept inside the port because the root ``tools``
package imports the JAX package. Read-only debug endpoints served from a
daemon thread inside the process (stdlib ``http.server``), with the
reference's routes and JSON keys:

- ``/statusz``   — the human health snapshot
  (:func:`raft_tpu_torch.tools.statusz.render_statusz`)
- ``/metricsz``  — Prometheus text exposition (scrape target)
- ``/explainz``  — the explain-record ring as JSON
  (``?outcome=ok|error|deadline`` filters, ``?limit=N`` truncates)
- ``/flightz``   — the flight ring as a Perfetto-loadable trace JSON
- ``/healthz``   — 200 ``ok``; 503 ``burning`` while the SLO engine has
  a page-severity burn alert active (a load balancer's drain signal)
- ``/stackz``    — a live thread dump (every Python thread's stack with
  blocked-at annotations)
- ``/crashz``    — the prior run's postmortem reconstruction when the
  engine booted over an epilogue-less blackbox; ``{"verdict": "none"}``
  otherwise

Started by the engine (``ServingEngine(debug_port=0)`` or
``RAFT_TPU_DEBUGZ_PORT``; port 0 binds an ephemeral port, read back
from :attr:`DebugzServer.port`) or on its own::

    srv = DebugzServer(engine=eng, port=9090).start()
    ...
    srv.stop()

Binds 127.0.0.1 by default. Every handler is read-only and never raises:
a broken subsystem renders as an error note in the page body.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse


class _Handler(BaseHTTPRequestHandler):
    # the server instance injects itself; class attr keeps mypy quiet
    debugz: "DebugzServer"

    # quiet: one log line per scrape would drown the process log
    def log_message(self, fmt, *args):  # noqa: A002
        pass

    def _send(self, status: int, body: str,
              ctype: str = "text/plain; charset=utf-8") -> None:
        payload = body.encode("utf-8")
        self.send_response(status)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(payload)))
        self.end_headers()
        try:
            self.wfile.write(payload)
        except (BrokenPipeError, ConnectionResetError):
            pass  # scraper hung up mid-write; nothing to clean up

    def do_GET(self) -> None:  # noqa: N802 (http.server contract)
        url = urlparse(self.path)
        route = url.path.rstrip("/") or "/"
        try:
            if route == "/statusz" or route == "/":
                self._statusz()
            elif route == "/metricsz":
                self._metricsz()
            elif route == "/explainz":
                self._explainz(parse_qs(url.query))
            elif route == "/flightz":
                self._flightz()
            elif route == "/healthz":
                self._healthz()
            elif route == "/stackz":
                self._stackz()
            elif route == "/crashz":
                self._crashz()
            else:
                self._send(404, "not found: %s\n" % route)
        except Exception as e:  # read-only page: render, don't raise
            self._send(500, "debugz handler error: %r\n" % (e,))

    def _statusz(self) -> None:
        from raft_tpu_torch.tools.statusz import render_statusz

        self._send(200, render_statusz(engine=self.debugz.engine))

    def _metricsz(self) -> None:
        from raft_tpu_torch.observability.exporters import export_prometheus

        self._send(200, export_prometheus(),
                   ctype="text/plain; version=0.0.4; charset=utf-8")

    def _explainz(self, qs) -> None:
        from raft_tpu_torch.observability.explain import explain_records

        outcome = (qs.get("outcome") or [None])[0]
        try:
            limit = int((qs.get("limit") or [64])[0])
        except (TypeError, ValueError):
            limit = 64
        records = explain_records(outcome=outcome, limit=limit)
        self._send(200, json.dumps({"records": records}, default=str,
                                   indent=2) + "\n",
                   ctype="application/json")

    def _flightz(self) -> None:
        from raft_tpu_torch.observability.exporters import export_perfetto

        self._send(200, json.dumps(export_perfetto()) + "\n",
                   ctype="application/json")

    def _stackz(self) -> None:
        from raft_tpu_torch.observability.watchdog import format_stacks

        self._send(200, format_stacks() + "\n")

    def _crashz(self) -> None:
        eng = self.debugz.engine
        report = (getattr(eng, "crash_report", None)
                  if eng is not None else None)
        if report is None:
            report = {"verdict": "none",
                      "note": "no prior-run unclean blackbox detected"}
        self._send(200, json.dumps(report, default=str, indent=2)
                   + "\n", ctype="application/json")

    def _healthz(self) -> None:
        burning = False
        eng = self.debugz.engine
        slo = getattr(eng, "slo", None) if eng is not None else None
        if slo is not None:
            try:
                burning = bool(slo.burning("page"))
            except Exception:
                burning = False
        if burning:
            self._send(503, "burning\n")
        else:
            self._send(200, "ok\n")


class DebugzServer:
    """The debug HTTP server: ThreadingHTTPServer on a daemon thread.
    ``port=0`` binds an ephemeral port (tests); read the bound port
    back from :attr:`port` after :meth:`start`."""

    def __init__(self, engine=None, port: int = 0,
                 host: str = "127.0.0.1"):
        self.engine = engine
        self._requested_port = int(port)
        self._host = host
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> Optional[int]:
        """The bound port (None before :meth:`start`)."""
        if self._httpd is None:
            return None
        return self._httpd.server_address[1]

    def start(self) -> "DebugzServer":
        if self._httpd is not None:
            return self
        handler = type("_BoundHandler", (_Handler,), {"debugz": self})
        self._httpd = ThreadingHTTPServer(
            (self._host, self._requested_port), handler)
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            kwargs={"poll_interval": 0.1},
            name="debugz", daemon=True)
        self._thread.start()
        return self

    def stop(self, timeout: float = 5.0) -> None:
        httpd, self._httpd = self._httpd, None
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout)
