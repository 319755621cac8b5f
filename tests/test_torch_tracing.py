"""tpuframe_torch.obs.tracing against tpuframe.obs.tracing.

  - the same event streams give equal ``build_traces``, ``span_anomalies``,
    ``verify_traces``, ``critical_path``, ``waterfall`` and ``trace_of``
    results: the JAX package's synthetic trace and its seeded corruptions,
    its golden traced-fleet sample, and streams that each package's
    scheduler and router write;
  - ``sampled`` and ``mint`` agree over many keys and rates;
  - the live half: span events validate, the open-span registry and its
    ``tpuframe_open_spans`` gauge, atomic pairs bypass the registry;
  - ``check()`` is clean.
"""

import json
import os
import threading
import time

import pytest

pytest.importorskip("torch")

from tpuframe.obs import events as jax_events  # noqa: E402
from tpuframe.obs import tracing as jax_tracing  # noqa: E402
from tpuframe.serve.replica import FakeEngine as JaxFakeEngine  # noqa: E402
from tpuframe.serve.replica import Replica as JaxReplica  # noqa: E402
from tpuframe.serve.router import Router as JaxRouter  # noqa: E402
from tpuframe_torch.obs import events  # noqa: E402
from tpuframe_torch.obs import exporter  # noqa: E402
from tpuframe_torch.obs import tracing  # noqa: E402
from tpuframe_torch.serve.replica import FakeEngine, Replica  # noqa: E402
from tpuframe_torch.serve.router import Router  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAMPLE = os.path.join(REPO, "docs", "samples", "traced_fleet")


def _trees(traces):
    """``build_traces``' result as plain data (each Span by its ids)."""
    def sp(s):
        return {"name": s.name, "parent": s.parent, "opened": s.opened,
                "closed": s.closed, "notes": s.notes,
                "children": [c.span for c in s.children],
                "complete": s.complete, "ms": s.ms, "end_t": s.end_t()}

    return {tid: {"spans": {sid: sp(s) for sid, s in tv.spans.items()},
                  "roots": [r.span for r in tv.roots], "notes": tv.notes,
                  "complete_roots": [r.span for r in tv.complete_roots()]}
            for tid, tv in traces.items()}


def _analyses(mod, stream):
    traces = mod.build_traces(stream)
    out = {"trees": _trees(traces),
           "anomalies": mod.span_anomalies(stream),
           "verify": mod.verify_traces(stream),
           "verify_tight": mod.verify_traces(stream, tol_ms=0.001),
           "paths": {}, "waterfalls": {}}
    for tid, tv in traces.items():
        for root in tv.roots:
            out["paths"][root.span] = [s.span for s in
                                       mod.critical_path(root)]
            out["waterfalls"][root.span] = [
                (r["depth"], r["span"].span) for r in mod.waterfall(root)]
    rids = sorted({r.get("id") for r in stream
                   if r.get("type") == "router_admit"}, key=str)
    out["trace_of"] = [mod.trace_of(stream, rid) for rid in rids]
    return out


def _mutations():
    healthy = jax_tracing._synthetic_trace()
    return {
        "healthy": healthy,
        "leaked": [r for r in healthy if not (
            r["type"] == "span_close" and r.get("span") == "s1")],
        "orphan": [dict(r, parent="zz") if (
            r["type"] == "span_open" and r.get("span") == "s1") else r
            for r in healthy],
        "ttft_drift": [dict(r, ttft_ms=67.0) if (
            r["type"] == "span_close" and r.get("span") == "r0") else r
            for r in healthy],
        "ttft_nudged": [dict(r, ttft_ms=19.0) if (
            r["type"] == "span_close" and r.get("span") == "r0") else r
            for r in healthy],
        "missing_root": [r for r in healthy
                         if r["type"] not in jax_tracing.SPAN_EVENT_TYPES],
        "incomplete_root": [r for r in healthy if not (
            r["type"] == "span_close" and r.get("span") == "r0")],
        "orphan_close": healthy + [dict(healthy[5], span="ghost")],
        "orphan_note": healthy + [{**healthy[0], "type": "span_note",
                                   "trace": "tchk.0000", "note": "x",
                                   "span": "nowhere"}],
        "missing_phase": [r for r in healthy if r.get("span") != "q1"],
    }


def test_synthetic_traces_are_the_same():
    assert tracing._synthetic_trace() == jax_tracing._synthetic_trace()
    assert tracing.SPAN_REQUIRED_FIELDS == jax_tracing.SPAN_REQUIRED_FIELDS


@pytest.mark.parametrize("name", sorted(_mutations()))
def test_offline_analyses_match_jax(name):
    stream = _mutations()[name]
    port, ref = _analyses(tracing, stream), _analyses(jax_tracing, stream)
    assert port == ref
    if name == "healthy":
        assert port["verify"] == []
        assert [s for s in port["paths"]["r0"]] == ["r0", "a1", "s1", "d1"]
    else:
        assert port["verify"] or name == "ttft_nudged"


def test_golden_traced_fleet_sample_matches_jax():
    stream = events.merge(SAMPLE)
    assert stream == jax_events.merge(SAMPLE)
    port, ref = _analyses(tracing, stream), _analyses(jax_tracing, stream)
    assert port == ref
    assert port["verify"] == [] and port["trees"]


def _fleet_stream(mod_router, mod_replica_cls, mod_engine_cls, ev_mod,
                  directory):
    """Four traced requests through an in-process router -> replica ->
    scheduler of one package, the replica pumped on a thread."""
    ev_mod.init(str(directory))
    try:
        replica = mod_replica_cls(mod_engine_cls(slots=2),
                                  handler_timeout_s=10.0)
        pump = threading.Thread(target=replica.run,
                                kwargs=dict(max_idle_s=30.0), daemon=True)
        pump.start()

        def transport(url, payload, timeout_s):
            if url.endswith("/generate"):
                status, body = replica.handle_generate(
                    json.dumps(payload).encode())
                return status, json.loads(body.decode())
            if url.endswith("/healthz"):
                return 200, "ok\n"
            return 200, "tpuframe_serve_queue_depth 0\n# EOF\n"

        r = mod_router(["http://r0"], transport=transport, hedge_ms=0,
                       scrape_interval_s=1e9)
        for rid in range(4):
            assert r.submit(rid, [rid + 1, 2, 3], max_new_tokens=3)
        deadline = time.monotonic() + 10.0
        while r.has_work() and time.monotonic() < deadline:
            r.step()
            time.sleep(0.002)
        assert not r.has_work()
        replica.drain()
        pump.join(10.0)
        assert not pump.is_alive()
    finally:
        ev_mod.close()
    return ev_mod.merge(str(directory))


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_fleet_streams_analyse_alike(tmp_path, writer):
    """A stream the port's router and scheduler write, and one the JAX
    package's write: each package's analyses agree on both, and each
    stream is whole (one complete root a request, every phase)."""
    if writer == "port":
        stream = _fleet_stream(Router, Replica, FakeEngine, events,
                               tmp_path)
    else:
        stream = _fleet_stream(JaxRouter, JaxReplica, JaxFakeEngine,
                               jax_events, tmp_path)
    port, ref = _analyses(tracing, stream), _analyses(jax_tracing, stream)
    assert port == ref
    assert port["verify"] == []
    traces = tracing.build_traces(stream)
    assert len(traces) == 4
    for tv in traces.values():
        (root,) = tv.complete_roots()
        names = [r["span"].name for r in tracing.waterfall(root)]
        assert names == ["request", "attempt", "serve", "queue", "prefill",
                         "decode"]


@pytest.mark.parametrize("rate", ["", "0", "0.1", "0.37", "0.5", "0.99",
                                  "1", "7", "-1", "junk"])
def test_sampling_agrees_with_jax(monkeypatch, rate):
    monkeypatch.setenv(tracing.ENV_SAMPLE, rate)
    assert tracing.resolve_sample() == jax_tracing.resolve_sample()
    keys = list(range(1000)) + [f"rollout-{i}" for i in range(200)]
    picks = [tracing.sampled(k) for k in keys]
    assert picks == [jax_tracing.sampled(k) for k in keys]
    assert [tracing.mint(k) for k in keys[:50]] == \
        [jax_tracing.mint(k) for k in keys[:50]]
    assert tracing.mint(3, force=True) == jax_tracing.mint(3, force=True)
    if rate == "0.5":
        assert 200 < sum(picks[:1000]) < 800


def test_span_events_validate_in_both_packages(tmp_path):
    events.init(str(tmp_path))
    try:
        tid = tracing.mint(0, force=True)
        sid = tracing.open_span(tid, "request", rid=0)
        tracing.note(tid, "requeue", span=sid, replica="r0")
        tracing.close_span(tid, sid, 12.5, status="ok")
        tracing.span(tid, "queue", parent=sid, ms=3.0)
    finally:
        events.close()
    merged = events.merge(str(tmp_path))
    assert [e["type"] for e in merged].count("span_open") == 2
    for rec in merged:
        assert events.validate_record(rec) == []
        assert jax_events.validate_record(rec) == []
    assert tracing.verify_traces(merged) == []


def test_open_span_registry_and_metrics_gauge():
    base = tracing.open_span_count()
    tid = tracing.mint("gauge-test", force=True)
    sid = tracing.open_span(tid, "request")
    try:
        assert tracing.open_span_count() == base + 1
        assert (tid, sid, "request") in tracing.open_spans()
        text = exporter.MetricsExporter().render()
        assert f"tpuframe_open_spans {base + 1}\n" in text
    finally:
        tracing.close_span(tid, sid, 1.0)
    assert tracing.open_span_count() == base
    tracing.span("tx.0", "queue", ms=1.0)        # atomic pair: no entry
    assert tracing.open_span_count() == base


def test_check_is_clean():
    assert tracing.check() == []
