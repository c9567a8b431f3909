"""Shared HTTP status surface: ``/`` JSON + ``/metrics`` Prometheus.

One handler shape for every process that exposes itself over HTTP — the
worker's ``--status-port`` page (the headless stand-in for the reference's
worker GUI), the master's own ``--status-port`` (whose registry additionally
carries the merged ``cluster.*`` series), and the serving plane's API port
(``cake_tpu_torch.serve.api`` mounts these two routes next to its traffic
endpoints, so one port serves both requests and observability).
``status_fn`` supplies the JSON body; ``/metrics`` always serves the
process-global registry in Prometheus text exposition.

Binding defaults to loopback: a status page leaks identity, layer
assignments, and traffic counters, so exposing it beyond the host is an
explicit ``--status-bind`` decision, not a side effect of starting it.
"""

from __future__ import annotations

import http.server
import json
import logging
import threading

from cake_tpu_torch.obs import metrics as _metrics

log = logging.getLogger("cake_tpu_torch.obs.statusd")


def status_response(status_fn, path: str) -> tuple[bytes, str]:
    """Body + content type for one status-surface GET: ``/metrics`` is the
    process-global registry in Prometheus text exposition, anything else is
    ``status_fn()`` as JSON (which embeds the same registry snapshot under
    ``metrics``). The ONE place the bytes are built — every server that
    exposes the surface (``start_status_server`` here, ``serve.api``'s
    mounted routes) calls this, so their output stays byte-identical."""
    path = path.rstrip("/")
    if path == "/metrics":
        return (_metrics.registry().to_prometheus().encode(),
                "text/plain; version=0.0.4")
    if path == "/debug/prof":
        # engine profiling plane (obs/prof): phase percentiles, compile/
        # retrace counts, memory watermarks — same body on every surface
        # that mounts this handler (worker statusd, serve API port)
        from cake_tpu_torch.obs import prof as _prof

        return (json.dumps(_prof.report(), indent=1).encode(),
                "application/json")
    return json.dumps(status_fn(), indent=1).encode(), "application/json"


def start_status_server(status_fn, bind: str = "127.0.0.1", port: int = 0):
    """Serve ``status_fn()`` as JSON on ``/`` and the metrics registry as
    Prometheus text on ``/metrics``. Returns ``(httpd, bound_port)``;
    daemon-threaded, stopped with ``httpd.shutdown()`` +
    ``httpd.server_close()``."""

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802 (stdlib casing)
            body, ctype = status_response(status_fn, self.path)
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, fmt, *args):
            log.debug("status: " + fmt, *args)

    httpd = http.server.ThreadingHTTPServer((bind, port), Handler)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, httpd.server_address[1]
