"""Live telemetry plane (counterpart of ``tpuframe/obs/exporter.py``): an
OpenMetrics endpoint over the port's counters, gauges and collectors,
rendered byte for byte as the JAX exporter renders them.

Endpoints:

  ``/metrics``  OpenMetrics text exposition: the port's counters (one
                ``tpuframe_events_total`` family, counter name as a label:
                the retry counters of ``resilience/policy.py``, under the
                JAX package's names), the ``tpuframe_open_spans`` leak
                gauge, and whatever gauges/collectors were registered
                (the serving scheduler's queue, slot and latency samples,
                a replica's weights version).
  ``/healthz``  200 while the registered health probe says healthy, 503
                otherwise (a replica's stall and drain probe).
  POST          handlers registered with :meth:`add_handler` (a replica's
                ``/generate`` and ``/swap_weights``), so a process's whole
                HTTP surface is this one server.

Enable via ``TPUFRAME_METRICS_PORT=<port>`` (0 = ephemeral; the bound
port lands on ``MetricsExporter.port``).  Scrape-less hosts set
``TPUFRAME_METRICS_TEXTFILE=<path>`` instead (or additionally): every
``flush()`` atomically rewrites the same exposition text.

Pure stdlib: the server thread only reads in-process state, never a
device or a collective.
"""

from __future__ import annotations

import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

ENV_PORT = "TPUFRAME_METRICS_PORT"
ENV_TEXTFILE = "TPUFRAME_METRICS_TEXTFILE"

CONTENT_TYPE = "application/openmetrics-text; version=1.0.0; charset=utf-8"


def _escape_label(v) -> str:
    return (str(v).replace("\\", "\\\\").replace("\n", "\\n")
            .replace('"', '\\"'))


def _fmt_sample(name: str, labels: dict, value) -> str:
    if labels:
        body = ",".join(f'{k}="{_escape_label(v)}"'
                        for k, v in sorted(labels.items()))
        return f"{name}{{{body}}} {float(value):g}"
    return f"{name} {float(value):g}"


class MetricsExporter:
    """Push-gauges + pull-collectors rendered as one OpenMetrics page.

    ``set_gauge(name, value, **labels)`` stores a sample (the push API
    for per-step facts); ``add_collector(fn)`` registers ``fn() ->
    iterable of (name, labels_dict, value)`` polled at render time (the
    pull API for live state like the goodput meter).  Families whose
    name ends in ``_total`` render as counters (OpenMetrics requires the
    suffix), everything else as gauges.
    """

    def __init__(self, *, port: int | None = None,
                 textfile: str | None = None, health=None):
        self._port_requested = port
        self.port: int | None = None
        self.textfile = textfile
        self._health = health
        self._lock = threading.Lock()
        self._gauges: dict[tuple, float] = {}
        self._collectors: list = []
        self._handlers: dict[str, object] = {}
        self._server: ThreadingHTTPServer | None = None
        self._thread: threading.Thread | None = None

    # -- registration ----------------------------------------------------

    def set_gauge(self, name: str, value, **labels) -> None:
        try:
            v = float(value)
        except (TypeError, ValueError):
            return
        with self._lock:
            self._gauges[(name, tuple(sorted(labels.items())))] = v

    def add_collector(self, fn) -> None:
        with self._lock:
            if fn not in self._collectors:
                self._collectors.append(fn)

    def set_health(self, fn) -> None:
        with self._lock:
            self._health = fn

    def add_handler(self, path: str, fn) -> None:
        """Register ``fn(body: bytes) -> (status: int, body: bytes)`` to
        serve POST requests at ``path``.  This keeps the process's whole
        HTTP surface on one endpoint: the serving replica's ``/generate``
        rides the same server, port knob and health probe as the scrape
        plane instead of standing up its own socket."""
        with self._lock:
            self._handlers[path] = fn

    def _handler_for(self, path: str):
        with self._lock:
            return self._handlers.get(path)

    def healthy(self) -> bool:
        fn = self._health
        if fn is None:
            return True
        try:
            return bool(fn())
        except Exception:  # noqa: BLE001 — a broken probe reads unhealthy
            return False

    # -- rendering -------------------------------------------------------

    def _samples(self) -> list[tuple[str, dict, float]]:
        out: list[tuple[str, dict, float]] = []
        try:
            from tpuframe_torch.resilience import policy

            for name, v in sorted(policy.counters().items()):
                out.append(("tpuframe_events_total", {"name": name},
                            float(v)))
        except Exception:  # noqa: BLE001 — counters are best-effort
            pass
        try:
            from tpuframe_torch.obs import tracing

            # Live leak signal: spans this process opened and has not
            # closed.  A replica stuck with unanswered requests shows a
            # climbing gauge on /metrics long before the offline
            # leaked-span anomaly sweep ever runs.
            out.append(("tpuframe_open_spans", {},
                        float(tracing.open_span_count())))
        except Exception:  # noqa: BLE001 — best-effort like the counters
            pass
        with self._lock:
            gauges = list(self._gauges.items())
            collectors = list(self._collectors)
        for (name, labels), v in gauges:
            out.append((name, dict(labels), v))
        for fn in collectors:
            try:
                for name, labels, v in fn():
                    out.append((str(name), dict(labels or {}), float(v)))
            except Exception:  # noqa: BLE001 — one broken collector must
                continue  # not blank the whole exposition
        return out

    def render(self) -> str:
        by_family: dict[str, list[str]] = {}
        for name, labels, v in self._samples():
            by_family.setdefault(name, []).append(
                _fmt_sample(name, labels, v))
        lines: list[str] = []
        for name in sorted(by_family):
            if name.endswith("_total"):
                lines.append(f"# TYPE {name[:-len('_total')]} counter")
            else:
                lines.append(f"# TYPE {name} gauge")
            lines.extend(sorted(by_family[name]))
        lines.append("# EOF")
        return "\n".join(lines) + "\n"

    # -- serving ---------------------------------------------------------

    def start(self) -> "MetricsExporter":
        if self._port_requested is None or self._server is not None:
            return self
        exporter = self

        class _Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 — BaseHTTPRequestHandler API
                if self.path.split("?")[0] == "/metrics":
                    body = exporter.render().encode()
                    self.send_response(200)
                    self.send_header("Content-Type", CONTENT_TYPE)
                elif self.path.split("?")[0] == "/healthz":
                    ok = exporter.healthy()
                    body = (b"ok\n" if ok else b"unhealthy\n")
                    self.send_response(200 if ok else 503)
                    self.send_header("Content-Type",
                                     "text/plain; charset=utf-8")
                else:
                    body = b"not found\n"
                    self.send_response(404)
                    self.send_header("Content-Type",
                                     "text/plain; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_POST(self):  # noqa: N802 — BaseHTTPRequestHandler API
                path = self.path.split("?")[0]
                handler = exporter._handler_for(path)
                if handler is None:
                    status, body = 404, b"not found\n"
                else:
                    try:
                        n = int(self.headers.get("Content-Length") or 0)
                        status, body = handler(self.rfile.read(n))
                    except Exception as e:  # noqa: BLE001 — a broken
                        # handler must answer 500, not kill the server
                        status, body = 500, f"{type(e).__name__}: {e}\n" \
                            .encode()
                self.send_response(int(status))
                self.send_header("Content-Type",
                                 "application/json; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):  # scrapes must not spam stdout
                pass

        # Lifecycle fields (_server/port/_thread) are caller-serialized:
        # start()/stop() only run under the module _exporter_lock
        # (start_from_env/stop below), and the handler thread never
        # writes them, so self._lock is not held across bind/serve setup.
        try:
            self._server = ThreadingHTTPServer(
                ("0.0.0.0", int(self._port_requested)), _Handler)
        except OSError as e:
            import sys

            if int(self._port_requested) != 0:
                # Occupied/unbindable port: fall back to an ephemeral one
                # (the bound port lands on ``.port``) instead of silently
                # dropping the scrape plane — a fleet replica without a
                # /healthz is indistinguishable from a dead one.
                try:
                    self._server = ThreadingHTTPServer(
                        ("0.0.0.0", 0), _Handler)
                    print(f"[tpuframe_torch.obs] metrics exporter: cannot "
                          f"bind port {self._port_requested} ({e}) — fell "
                          f"back "
                          f"to ephemeral port "
                          f"{self._server.server_address[1]}",
                          file=sys.stderr)
                except OSError as e2:
                    e = e2
                    self._server = None
            if self._server is None:
                print(f"[tpuframe_torch.obs] metrics exporter: cannot bind "
                      f"port {self._port_requested} ({e}) — scrape endpoint "
                      f"off, textfile output unaffected", file=sys.stderr)
                return self
        self._server.daemon_threads = True
        self.port = self._server.server_address[1]
        # Serves in-process snapshots only (counters/gauges under a plain
        # lock): never touches the device or a collective.
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True,
            name="tpuframe-metrics")
        self._thread.start()
        return self

    def flush(self) -> None:
        """Rewrite the textfile exposition (atomic), when configured."""
        if not self.textfile:
            return
        try:
            d = os.path.dirname(self.textfile)
            if d:
                os.makedirs(d, exist_ok=True)
            tmp = f"{self.textfile}.tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                f.write(self.render())
            os.replace(tmp, self.textfile)
        except OSError:
            pass  # scrape-less fallback is itself best-effort

    def stop(self) -> None:
        # Same caller-serialized lifecycle contract as start(): runs only
        # under the module _exporter_lock, and holding self._lock across
        # shutdown()/join() would stall a mid-scrape handler holding it.
        self.flush()
        server, self._server = self._server, None
        if server is not None:
            try:
                server.shutdown()
                server.server_close()
            except OSError:
                pass
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None


# ---------------------------------------------------------------------------
# Module-level singleton — one exporter per process, env-gated.
# ---------------------------------------------------------------------------

_exporter: MetricsExporter | None = None
_exporter_lock = threading.Lock()


def start_from_env(*, health=None, port_offset: int = 0
                   ) -> MetricsExporter | None:
    """Start (or return) the process-wide exporter.  Off unless
    ``TPUFRAME_METRICS_PORT`` or ``TPUFRAME_METRICS_TEXTFILE`` is set.
    ``port_offset`` shifts the bound port (the JAX launcher's supervisor
    uses +1 so it never collides with a child's bind on the same host)."""
    global _exporter
    with _exporter_lock:
        if _exporter is not None:
            if health is not None and _exporter._health is None:
                _exporter.set_health(health)
            return _exporter
        port_s = os.environ.get(ENV_PORT, "").strip()
        textfile = os.environ.get(ENV_TEXTFILE, "").strip() or None
        if not port_s and not textfile:
            return None
        port: int | None = None
        if port_s:
            try:
                port = int(port_s)
            except ValueError:
                port = None
            else:
                if port and port_offset:
                    port += port_offset
        _exporter = MetricsExporter(port=port, textfile=textfile,
                                    health=health).start()
        return _exporter


def get() -> MetricsExporter | None:
    return _exporter


def stop() -> None:
    global _exporter
    with _exporter_lock:
        if _exporter is not None:
            _exporter.stop()
            _exporter = None
