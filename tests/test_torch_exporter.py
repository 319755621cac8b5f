"""tpuframe_torch.obs.exporter against tpuframe.obs.exporter.

  - ``render()`` is byte-equal for the same counters, gauges (escaped
    labels included) and collectors (a broken one included);
  - over HTTP: ``/metrics``, ``/healthz`` 200 and 503 (a broken probe
    reads unhealthy), 404, and POST handlers (200, 404, a raising handler
    answers 500), with the JAX exporter's statuses and bodies;
  - the textfile flush writes the same exposition; ``start_from_env`` is
    off without its variables and a process singleton with them; an
    occupied port falls back to an ephemeral one.
"""

import json
import socket
import urllib.error
import urllib.request

import pytest

pytest.importorskip("torch")

from tpuframe.obs import exporter as jax_exporter  # noqa: E402
from tpuframe.obs import metrics as jax_metrics  # noqa: E402
from tpuframe.obs import tracing as jax_tracing  # noqa: E402
from tpuframe_torch.obs import exporter  # noqa: E402
from tpuframe_torch.obs import tracing  # noqa: E402
from tpuframe_torch.resilience import policy  # noqa: E402

MODS = {"port": exporter, "jax": jax_exporter}


@pytest.fixture
def same_counters(monkeypatch):
    """Both packages' counter tables set to the same two counters, and
    their open-span registries (the ``tpuframe_open_spans`` gauge)
    empty."""
    monkeypatch.setattr(policy, "COUNTERS", {})
    monkeypatch.setattr(tracing, "_open", {})
    monkeypatch.setattr(jax_tracing, "_open", {})
    jax_metrics.reset_counters()
    for name, n in (("retry.gcs_read.retries", 3),
                    ("retry.ckpt_write.recovered", 1)):
        policy.bump(name, n)
        jax_metrics.bump(name, n)
    yield
    jax_metrics.reset_counters()


def _populate(ex):
    ex.set_gauge("tpuframe_step", 7)
    ex.set_gauge("tpuframe_goodput_bucket_seconds", 1.5, bucket="productive")
    ex.set_gauge("g", 1.0, path='a"b\nc\\d')
    ex.set_gauge("tpuframe_serve_queue_depth", 0)
    ex.set_gauge("skipped", "not a number")
    ex.add_collector(lambda: [("tpuframe_live", {"k": "v"}, 2.0),
                              ("tpuframe_live", {"k": "u"}, 0.25),
                              ("tpuframe_serve_ttft_ms", {"quantile": "p50"},
                               12.345678)])

    def broken():
        raise RuntimeError("boom")

    ex.add_collector(broken)
    return ex


def test_render_is_byte_equal(same_counters):
    port = _populate(exporter.MetricsExporter()).render()
    ref = _populate(jax_exporter.MetricsExporter()).render()
    assert port == ref
    lines = port.splitlines()
    assert "# TYPE tpuframe_events counter" in lines
    assert 'tpuframe_events_total{name="retry.gcs_read.retries"} 3' in lines
    assert 'g{path="a\\"b\\nc\\\\d"} 1' in lines
    assert lines[-1] == "# EOF" and port.endswith("\n")


def _call(url, body=None):
    req = urllib.request.Request(
        url, data=None if body is None else json.dumps(body).encode())
    try:
        with urllib.request.urlopen(req, timeout=5.0) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _http_session(mod):
    state = {"ok": True}
    ex = _populate(mod.MetricsExporter(port=0, health=lambda: state["ok"]))
    ex.add_handler("/echo", lambda body: (
        200, json.dumps({"echo": json.loads(body)["x"]}).encode()))

    def boom(body):
        raise ValueError("bad payload")

    ex.add_handler("/boom", boom)
    ex.start()
    base = f"http://127.0.0.1:{ex.port}"
    try:
        out = [_call(f"{base}/metrics"), _call(f"{base}/healthz"),
               _call(f"{base}/nope"), _call(f"{base}/echo", {"x": 5}),
               _call(f"{base}/missing", {"x": 1}),
               _call(f"{base}/boom", {"x": 1})]
        state["ok"] = False
        out.append(_call(f"{base}/healthz"))
        ex.set_health(lambda: 1 / 0)             # a broken probe
        out.append(_call(f"{base}/healthz"))
    finally:
        ex.stop()
    return out


def test_http_surface_matches_jax(same_counters):
    port = _http_session(exporter)
    ref = _http_session(jax_exporter)
    assert port == ref
    assert [s for s, _ in port] == [200, 200, 404, 200, 404, 500, 503, 503]
    assert port[1][1] == "ok\n" and port[6][1] == "unhealthy\n"
    assert json.loads(port[3][1]) == {"echo": 5}
    assert port[5][1] == "ValueError: bad payload\n"


def test_textfile_flush_matches_jax(tmp_path, same_counters):
    for name, mod in MODS.items():
        ex = _populate(mod.MetricsExporter(textfile=str(
            tmp_path / name / "tpuframe.prom")))
        ex.flush()
        ex.stop()                 # a final flush rides on stop()
    assert (tmp_path / "port" / "tpuframe.prom").read_text() == \
        (tmp_path / "jax" / "tpuframe.prom").read_text()
    assert not list((tmp_path / "port").glob("*.tmp.*"))


def test_start_from_env_gating(monkeypatch, tmp_path):
    monkeypatch.delenv(exporter.ENV_PORT, raising=False)
    monkeypatch.delenv(exporter.ENV_TEXTFILE, raising=False)
    exporter.stop()
    assert exporter.start_from_env() is None and exporter.get() is None
    monkeypatch.setenv(exporter.ENV_PORT, "0")
    try:
        ex = exporter.start_from_env(health=lambda: True)
        assert ex is not None and ex.port > 0
        assert exporter.start_from_env() is ex         # one a process
        assert exporter.get() is ex
    finally:
        exporter.stop()
        exporter.stop()                                # idempotent
    assert exporter.get() is None
    monkeypatch.delenv(exporter.ENV_PORT)
    monkeypatch.setenv(exporter.ENV_TEXTFILE, str(tmp_path / "m.prom"))
    try:
        ex = exporter.start_from_env()
        assert ex is not None and ex.port is None      # textfile only
    finally:
        exporter.stop()
    assert (tmp_path / "m.prom").read_text().endswith("# EOF\n")


def test_occupied_port_falls_back_to_ephemeral(capsys):
    with socket.socket() as s:
        s.bind(("0.0.0.0", 0))
        s.listen(1)
        taken = s.getsockname()[1]
        ex = exporter.MetricsExporter(port=taken).start()
        try:
            assert ex.port is not None and ex.port != taken
        finally:
            ex.stop()
    assert "fell back to ephemeral port" in capsys.readouterr().err
