"""Dependency-free HTTP transport (stdlib http.server) over the serving endpoints.

Counterpart of `plotpointe_tpu/serving/httpd.py`. All request logic lives in
`endpoints.ServingState`; this module only parses HTTP and JSON. Spans
(`utils/tracing.py`): `http.request` (a new request id, the route and the
status) around `http.parse` (the body's read and `json.loads`), the endpoint
and `http.reply` (`json.dumps` and the write).
"""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from plotpointe_tpu_torch.serving.endpoints import ServingState
from plotpointe_tpu_torch.serving.runtime import RecommenderRuntime
from plotpointe_tpu_torch.utils import tracing


class _Handler(BaseHTTPRequestHandler):
    server_version = "plotpointe-tpu-torch/0.1"

    def _send(self, code: int, obj) -> None:
        with tracing.span("http.reply"):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    def log_message(self, fmt, *args):  # quiet by default
        pass

    @property
    def _state(self) -> ServingState:
        return self.server.state  # type: ignore[attr-defined]

    def do_GET(self):
        with tracing.span("http.request", rid=tracing.request_id(), route=self.path) as req:
            if self.path == "/healthz":
                code, body = self._state.healthz()
            else:
                code, body = 404, {"detail": "not found"}
            req.note(status=code)
            self._send(code, body)

    def do_POST(self):
        with tracing.span("http.request", rid=tracing.request_id(), route=self.path) as req:
            code, body = self._post()
            req.note(status=code)
            self._send(code, body)

    def _post(self):
        with tracing.span("http.parse"):
            try:
                length = int(self.headers.get("Content-Length", 0))
                payload = json.loads(self.rfile.read(length) or b"{}")
            except (ValueError, json.JSONDecodeError):
                return 400, {"detail": "invalid JSON body"}
        route = {
            "/startup": self._state.startup,
            "/recommend": self._state.recommend,
            "/feedback": self._state.feedback,
        }.get(self.path)
        if route is None:
            return 404, {"detail": "not found"}
        return route(payload)


class _Server(ThreadingHTTPServer):
    # the default listen backlog (5) drops connections under concurrent
    # load, and micro-batching exists for 64+ simultaneous clients
    request_queue_size = 128
    daemon_threads = True


def serve(host: str = "0.0.0.0", port: int = 8080, runtime: Optional[RecommenderRuntime] = None,
          telemetry=None, block: bool = True, micro_batch: bool = False,
          micro_batch_max: int = 64, micro_batch_wait_ms: float = 3.0,
          micro_batch_in_flight: int = 4):
    """Start the server. Returns (server, thread) when block=False; stop it
    with `server.shutdown(); server.server_close(); server.state.close()`."""
    httpd = _Server((host, port), _Handler)
    httpd.state = ServingState(runtime=runtime, telemetry=telemetry,  # type: ignore[attr-defined]
                               micro_batch=micro_batch,
                               micro_batch_max=micro_batch_max,
                               micro_batch_wait_ms=micro_batch_wait_ms,
                               micro_batch_in_flight=micro_batch_in_flight)
    if block:
        httpd.serve_forever()
        return httpd, None
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    return httpd, t
