"""Per-request tracing plane (counterpart of ``tpuframe/obs/tracing.py``):
spans over the structured event log, in the JAX package's span schema, so
either package's tools read the other's fleet traces.

Span model:

  - A *trace* is one request's end-to-end story.  ``Router.submit``
    mints the trace id at admission (``mint(rid)``, sampled by
    ``TPUFRAME_TRACE_SAMPLE``); the id rides the dispatch payload into
    the replica (``/generate`` body keys ``trace``/``span``), so every
    process annotates the same trace without a shared clock or a
    central collector.
  - A *span* is one timed phase: ``request`` (root, router),
    ``attempt`` (one dispatch: first placement, hedge or redispatch),
    ``serve`` (replica-side lifetime), ``queue``/``prefill``/``decode``
    (scheduler phases).  Spans carry ``parent`` links; hedge losers
    close with ``duplicate=true`` under the same trace.
  - Spans are ordinary typed events (``span_open``/``span_close``/
    ``span_note``) through :mod:`tpuframe_torch.obs.events`.

Clock contract: every ``ms`` on a ``span_close`` is a *same-process
monotonic* delta (router and scheduler both run on ``time.monotonic``);
cross-process subtraction never happens.  The wall-clock envelope ``t``
orders spans for display only.  Consequence: for a completed request,

    root ttft_ms == wait_ms + queue.ms + prefill.ms   (± rounding)

which ``verify_traces`` enforces within ``tol_ms``.

This module is the one emitter of span event types: everything else calls
``open_span``/``close_span``/``span``/``note``, so parent links, the
open-span registry (the ``tpuframe_open_spans`` gauge on ``/metrics``)
and the sampling decision cannot be half-applied.

Offline half: ``build_traces`` reconstructs span trees from a merged
stream, ``verify_traces`` makes orphan/leaked/unclosed spans and
phase-sum violations loud, ``critical_path`` walks the chain of spans
that gated completion, ``waterfall`` orders a tree for display;
``check()`` is the self-check with seeded positives.

Pure stdlib, as ``obs.events``.
"""

from __future__ import annotations

import os
import threading
import zlib
from dataclasses import dataclass, field

from tpuframe_torch.obs import events as obs_events

ENV_SAMPLE = "TPUFRAME_TRACE_SAMPLE"

SPAN_EVENT_TYPES = ("span_open", "span_close", "span_note")

# The per-type required fields this plane relies on, pinned here AND in
# obs/events.py REQUIRED_FIELDS; check() cross-checks the two so a
# schema edit that strands shipped traces fails the gate.
SPAN_REQUIRED_FIELDS = {
    "span_open": ("trace", "span", "name"),
    "span_close": ("trace", "span", "ms"),
    "span_note": ("trace", "note"),
}

_ids_lock = threading.Lock()
_next_id = 0

# In-process registry of spans opened but not yet closed — the live
# "leak" signal: the exporter renders its size as the label-free
# ``tpuframe_open_spans`` gauge, so a replica accumulating unclosed
# spans is visible on /metrics before any offline analysis runs.
_open_lock = threading.Lock()
_open: dict[tuple, str] = {}      # (trace, span) -> name


def resolve_sample() -> float:
    """The ``TPUFRAME_TRACE_SAMPLE`` fraction, clamped to [0, 1].
    Default 1.0 — every request traced; production fleets dial down."""
    raw = os.environ.get(ENV_SAMPLE, "").strip()
    if not raw:
        return 1.0
    try:
        return min(1.0, max(0.0, float(raw)))
    except ValueError:
        return 1.0


def sampled(key) -> bool:
    """Deterministic sampling decision for ``key`` (a rid or a string
    tag) against the resolved fraction.  Arithmetic hash, NOT ``hash()``
    — the decision must agree across processes and runs regardless of
    ``PYTHONHASHSEED``."""
    frac = resolve_sample()
    if frac >= 1.0:
        return True
    if frac <= 0.0:
        return False
    if isinstance(key, int):
        h = (key * 2654435761) & 0xFFFFFFFF
    else:
        h = zlib.crc32(str(key).encode())
    return h / 2.0 ** 32 < frac


def mint(key, *, force: bool = False) -> str | None:
    """Mint a trace id for ``key`` or return None when sampled out.
    ``force=True`` skips sampling (fleet-operation traces like a rollout
    are one-per-event, never volume).  The pid suffix keeps ids unique
    when a relaunched router reuses rids in the same events dir."""
    if not force and not sampled(key):
        return None
    return f"t{key}.{os.getpid() & 0xFFFF:04x}"


def _new_span_id() -> str:
    global _next_id
    with _ids_lock:
        _next_id += 1
        n = _next_id
    return f"s{os.getpid() & 0xFFFF:04x}.{n:x}"


def open_span(trace: str, name: str, *, parent: str | None = None,
              **fields) -> str:
    """Open a span under ``trace`` and return its span id.  Best-effort
    like every emit: with events off this still mints the id and tracks
    the open span (the gauge stays live), it just writes nothing."""
    span = _new_span_id()
    with _open_lock:
        _open[(trace, span)] = name
    obs_events.emit("span_open", trace=trace, span=span, name=name,
                    parent=parent, **fields)
    return span


def close_span(trace: str, span: str, ms, **fields) -> None:
    with _open_lock:
        _open.pop((trace, span), None)
    obs_events.emit("span_close", trace=trace, span=span,
                    ms=round(float(ms), 3), **fields)


def span(trace: str, name: str, *, parent: str | None = None,
         ms=0.0, **fields) -> str:
    """An already-measured phase as an atomic open+close pair — the
    scheduler's queue/prefill/decode spans, whose boundaries are clock
    reads it already takes."""
    sid = _new_span_id()
    obs_events.emit("span_open", trace=trace, span=sid, name=name,
                    parent=parent)
    obs_events.emit("span_close", trace=trace, span=sid,
                    ms=round(float(ms), 3), **fields)
    return sid


def note(trace: str, text: str, *, span: str | None = None,
         **fields) -> None:
    """Annotate a trace (optionally anchored to a span): drain
    re-queues, rollout swaps — the sibling events that explain why a
    waterfall has a gap without being timed phases themselves."""
    obs_events.emit("span_note", trace=trace, note=text, span=span,
                    **fields)


def open_span_count() -> int:
    with _open_lock:
        return len(_open)


def open_spans() -> list[tuple[str, str, str]]:
    """Snapshot of (trace, span, name) still open in this process."""
    with _open_lock:
        return [(t, s, n) for (t, s), n in sorted(_open.items())]


# ---------------------------------------------------------------------------
# Reconstruction — the offline half (tests, check(), chip_smoke.py).
# ---------------------------------------------------------------------------

@dataclass
class Span:
    """One reconstructed span: its open/close records and children."""

    trace: str
    span: str
    name: str | None = None
    parent: str | None = None
    opened: dict | None = None
    closed: dict | None = None
    notes: list = field(default_factory=list)
    children: list = field(default_factory=list)

    @property
    def complete(self) -> bool:
        return self.opened is not None and self.closed is not None

    @property
    def ms(self) -> float | None:
        if self.closed is None:
            return None
        return float(self.closed.get("ms") or 0.0)

    def end_t(self) -> float | None:
        """Wall-clock end estimate (open ``t`` + duration) — display and
        critical-path ordering only, never duration arithmetic."""
        if self.opened is None or self.ms is None:
            return None
        return float(self.opened.get("t") or 0.0) + self.ms / 1e3


@dataclass
class Trace:
    """One trace's span tree plus its unanchored notes."""

    trace: str
    spans: dict = field(default_factory=dict)    # span id -> Span
    roots: list = field(default_factory=list)
    notes: list = field(default_factory=list)

    def complete_roots(self, name: str = "request") -> list:
        return [sp for sp in self.roots
                if sp.name == name and sp.complete]


def build_traces(events: list) -> dict:
    """Reconstruct ``{trace_id: Trace}`` from a merged event stream.
    Tolerant by design — a torn stream still yields a tree; the
    judgments (orphans, leaks, sum violations) live in
    ``span_anomalies``/``verify_traces``."""
    traces: dict[str, Trace] = {}
    for r in events:
        etype = r.get("type")
        if etype not in SPAN_EVENT_TYPES:
            continue
        tid = str(r.get("trace"))
        tv = traces.setdefault(tid, Trace(trace=tid))
        sid = r.get("span")
        if etype == "span_note":
            if sid is not None and sid in tv.spans:
                tv.spans[sid].notes.append(r)
            tv.notes.append(r)
            continue
        sid = str(sid)
        sp = tv.spans.setdefault(sid, Span(trace=tid, span=sid))
        if etype == "span_open":
            if sp.opened is None:
                sp.opened = r
                sp.name = r.get("name")
                sp.parent = r.get("parent")
        else:
            if sp.closed is None:
                sp.closed = r
    for tv in traces.values():
        for sp in tv.spans.values():
            if sp.opened is None:
                continue
            if sp.parent is None:
                tv.roots.append(sp)
            elif sp.parent in tv.spans:
                tv.spans[sp.parent].children.append(sp)
    return traces


def span_anomalies(events: list) -> list[dict]:
    """Leaked (opened, never closed) and orphan (close/note/child with
    no opened parent) spans — the loud failure modes of a propagation
    bug or a torn process.  Each finding: ``{"kind", "detail", ...}``,
    the ``find_anomalies`` contract."""
    out: list[dict] = []
    traces = build_traces(events)
    for tid, tv in sorted(traces.items()):
        for sid, sp in sorted(tv.spans.items()):
            if sp.opened is None:
                host = (sp.closed or {}).get("host")
                out.append({
                    "kind": "orphan_span", "trace": tid, "span": sid,
                    "host": host,
                    "detail": f"trace {tid}: span_close for {sid} with "
                              f"no span_open (host {host})"})
                continue
            host = sp.opened.get("host")
            if sp.parent is not None and (
                    sp.parent not in tv.spans
                    or tv.spans[sp.parent].opened is None):
                out.append({
                    "kind": "orphan_span", "trace": tid, "span": sid,
                    "host": host,
                    "detail": f"trace {tid}: span {sp.name}({sid}) "
                              f"claims parent {sp.parent!r} which was "
                              f"never opened"})
            if sp.closed is None:
                out.append({
                    "kind": "leaked_span", "trace": tid, "span": sid,
                    "name": sp.name, "host": host,
                    "detail": f"trace {tid}: span {sp.name}({sid}) "
                              f"opened on {host} but never closed"})
        for rec in tv.notes:
            sid = rec.get("span")
            if sid is not None and sid not in tv.spans:
                out.append({
                    "kind": "orphan_span", "trace": tid, "span": sid,
                    "host": rec.get("host"),
                    "detail": f"trace {tid}: note "
                              f"{rec.get('note')!r} anchored to "
                              f"unknown span {sid}"})
    return out


def _winner_attempt(root: Span) -> Span | None:
    for ch in root.children:
        if (ch.name == "attempt" and ch.closed is not None
                and ch.closed.get("status") == "ok"
                and not ch.closed.get("duplicate")):
            return ch
    return None


def _child(sp: Span, name: str) -> Span | None:
    for ch in sp.children:
        if ch.name == name and ch.closed is not None:
            return ch
    return None


def verify_traces(events: list, *, tol_ms: float = 5.0) -> list[dict]:
    """The trace-completeness contract over a merged stream:

      - every span anomaly (leaked/orphan) from ``span_anomalies``;
      - every *traced* ``router_admit`` resolves to exactly one
        ``request`` root span (``missing_root``/``multiple_root``),
        and that root closed (``incomplete_root``);
      - for each completed root whose winning attempt carries replica
        phases, ``wait_ms + queue + prefill`` agrees with the recorded
        queue-inclusive TTFT within ``tol_ms`` (``ttft_mismatch``) —
        the one-monotonic-clock invariant;
      - a closed serve span missing its queue/prefill phases is
        ``missing_phase`` (the decomposition would silently lie).

    Returns findings; [] means every admitted request's story is whole.
    """
    problems = span_anomalies(events)
    traces = build_traces(events)
    admits = [r for r in events
              if r.get("type") == "router_admit"
              and r.get("trace") is not None]
    for rec in admits:
        tid, rid = str(rec["trace"]), rec.get("id")
        tv = traces.get(tid)
        roots = [sp for sp in (tv.roots if tv else [])
                 if sp.name == "request"]
        if not roots:
            problems.append({
                "kind": "missing_root", "trace": tid, "id": rid,
                "detail": f"admitted rid {rid}: trace {tid} has no "
                          f"request root span"})
            continue
        if len(roots) > 1:
            problems.append({
                "kind": "multiple_root", "trace": tid, "id": rid,
                "detail": f"admitted rid {rid}: trace {tid} has "
                          f"{len(roots)} request root spans"})
            continue
        root = roots[0]
        if root.closed is None:
            problems.append({
                "kind": "incomplete_root", "trace": tid, "id": rid,
                "detail": f"admitted rid {rid}: request root span "
                          f"never closed (request lost or still "
                          f"in flight)"})
            continue
        ttft = root.closed.get("ttft_ms")
        wait = root.closed.get("wait_ms")
        attempt = _winner_attempt(root)
        if ttft is None or wait is None or attempt is None:
            continue
        serve = _child(attempt, "serve")
        if serve is None:
            continue  # unit-fleet transports answer without a replica
        queue, prefill = _child(serve, "queue"), _child(serve, "prefill")
        if queue is None or prefill is None:
            problems.append({
                "kind": "missing_phase", "trace": tid, "id": rid,
                "detail": f"rid {rid}: serve span closed without "
                          f"queue/prefill phase spans — the TTFT "
                          f"decomposition cannot be checked"})
            continue
        total = float(wait) + (queue.ms or 0.0) + (prefill.ms or 0.0)
        if abs(total - float(ttft)) > tol_ms:
            problems.append({
                "kind": "ttft_mismatch", "trace": tid, "id": rid,
                "ttft_ms": round(float(ttft), 3),
                "phase_sum_ms": round(total, 3),
                "detail": f"rid {rid}: phases sum to {total:.3f} ms "
                          f"(wait {float(wait):.3f} + queue "
                          f"{queue.ms:.3f} + prefill {prefill.ms:.3f}) "
                          f"but recorded TTFT is {float(ttft):.3f} ms "
                          f"(tol {tol_ms} ms) — a clock-source or "
                          f"accounting drift"})
    return problems


def critical_path(root: Span) -> list[Span]:
    """The chain of spans that gated completion: from the root, descend
    at each span into the child whose end gated its parent's close (the
    latest-ending child; an unclosed child gates forever).  The names on
    this path are the request's binding constraints — the thing the
    disaggregation roadmap item needs per-phase."""
    path, sp = [], root
    while sp is not None:
        path.append(sp)
        nxt, best = None, float("-inf")
        for ch in sp.children:
            if ch.opened is None:
                continue
            end = float("inf") if ch.closed is None else (ch.end_t()
                                                          or 0.0)
            if end > best:
                best, nxt = end, ch
        sp = nxt
    return path


def waterfall(root: Span) -> list[dict]:
    """Depth-first rows ``{"depth", "span"}`` in wall-clock open order —
    the renderer's input (the JAX package's ``python -m tpuframe.obs
    trace`` renders the same rows)."""
    rows: list[dict] = []

    def rec(sp: Span, depth: int) -> None:
        rows.append({"depth": depth, "span": sp})
        for ch in sorted(sp.children,
                         key=lambda c: float(
                             (c.opened or {}).get("t") or 0.0)):
            rec(ch, depth + 1)

    rec(root, 0)
    return rows


def trace_of(events: list, rid) -> str | None:
    """The trace id minted for ``rid``, from its ``router_admit``."""
    for r in events:
        if r.get("type") == "router_admit" and r.get("id") == rid:
            return r.get("trace")
    return None


# ---------------------------------------------------------------------------
# Self-check.
# ---------------------------------------------------------------------------

def _rec(etype: str, t: float, host: str, **fields) -> dict:
    return {"schema": obs_events.SCHEMA_VERSION, "type": etype,
            "t": t, "host": host, "proc": 0, "attempt": 0, **fields}


def _synthetic_trace(tid: str = "tchk.0000") -> list[dict]:
    """One healthy end-to-end traced request, hand-built: router wait
    10 ms, replica queue 5 + prefill 2 + decode 40 — so the recorded
    queue-inclusive TTFT is exactly 17 ms.  The seeded positives below
    are mutations of this stream."""
    rh, ph = "checkh-p90", "checkh-p0"
    return [
        _rec("router_admit", 100.000, rh, id=1, trace=tid),
        _rec("span_open", 100.000, rh, trace=tid, span="r0",
             name="request", parent=None, rid=1),
        _rec("span_open", 100.010, rh, trace=tid, span="a1",
             name="attempt", parent="r0", replica="r0", cause="first"),
        _rec("span_open", 100.011, ph, trace=tid, span="s1",
             name="serve", parent="a1", rid=1),
        _rec("span_open", 100.016, ph, trace=tid, span="q1",
             name="queue", parent="s1"),
        _rec("span_close", 100.016, ph, trace=tid, span="q1", ms=5.0),
        _rec("span_open", 100.018, ph, trace=tid, span="p1",
             name="prefill", parent="s1"),
        _rec("span_close", 100.018, ph, trace=tid, span="p1", ms=2.0),
        _rec("span_open", 100.058, ph, trace=tid, span="d1",
             name="decode", parent="s1"),
        _rec("span_close", 100.058, ph, trace=tid, span="d1", ms=40.0,
             tokens=8),
        _rec("span_close", 100.059, ph, trace=tid, span="s1", ms=47.5,
             ttft_ms=7.0, tpot_ms=5.7),
        _rec("span_close", 100.061, rh, trace=tid, span="a1", ms=60.0,
             status="ok"),
        _rec("span_close", 100.062, rh, trace=tid, span="r0", ms=62.0,
             replica="r0", ttft_ms=17.0, wait_ms=10.0, tokens=8),
        _rec("router_request", 100.062, rh, id=1, replica="r0",
             ttft_ms=17.0, output_tokens=8, trace=tid, wait_ms=10.0),
    ]


def _repo_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def check() -> list[str]:
    """Host-only tracing checks: the span schema pin, seeded
    leaked/orphan/sum positives the verifier MUST flag (the check refuses
    to run blind), the golden traced-fleet sample's full reconstruction
    (the JAX package's ``docs/samples/traced_fleet``), and the SLO
    sentry's parse + rc contract.  The JAX check's source-lint leg
    (rule TF123) waits for the lint rules (ROADMAP.md queue 1, item 14).
    Returns problem strings; [] means healthy."""
    problems: list[str] = []

    from tpuframe_torch.obs import events as events_lib

    for etype, want in SPAN_REQUIRED_FIELDS.items():
        got = events_lib.REQUIRED_FIELDS.get(etype)
        if got is None:
            problems.append(
                f"span event type {etype!r} not registered in "
                f"obs.events.REQUIRED_FIELDS")
        elif tuple(got) != want:
            problems.append(
                f"span event {etype!r} required fields drifted: "
                f"registered {got!r}, tracing pins {want!r}")

    if not 0.0 <= resolve_sample() <= 1.0:
        problems.append(f"{ENV_SAMPLE} resolved outside [0, 1]")

    # Synthetic round-trip: the healthy stream must verify clean with
    # exactly one complete root...
    healthy = _synthetic_trace()
    for p in verify_traces(healthy):
        problems.append(f"synthetic healthy trace flagged: "
                        f"[{p['kind']}] {p['detail']}")
    traces = build_traces(healthy)
    n_complete = sum(len(tv.complete_roots()) for tv in traces.values())
    if n_complete != 1:
        problems.append(f"synthetic trace reconstructed {n_complete} "
                        f"complete roots (want 1)")

    # ...and each seeded corruption MUST be flagged, or the verifier is
    # blind and every downstream assertion is theater.
    seeds = (
        ("leaked_span",
         [r for r in healthy
          if not (r["type"] == "span_close" and r.get("span") == "s1")]),
        ("orphan_span",
         [dict(r, parent="zz") if (r["type"] == "span_open"
                                   and r.get("span") == "s1") else r
          for r in healthy]),
        ("ttft_mismatch",
         [dict(r, ttft_ms=67.0) if (r["type"] == "span_close"
                                    and r.get("span") == "r0") else r
          for r in healthy]),
    )
    for kind, stream in seeds:
        if not any(p["kind"] == kind for p in verify_traces(stream)):
            problems.append(f"seeded {kind} positive NOT flagged — the "
                            f"trace gate is blind")

    # Golden traced-fleet sample: a real multi-process fleet run of the
    # JAX package whose reconstruction must stay whole here too.
    sample = os.path.join(_repo_root(), "docs", "samples",
                          "traced_fleet")
    files = events_lib.event_files(sample)
    if not files:
        problems.append(f"golden traced-fleet sample missing under "
                        f"{sample}")
    else:
        merged = events_lib.merge(sample)
        for p in verify_traces(merged):
            problems.append(f"traced-fleet sample: [{p['kind']}] "
                            f"{p['detail']}")
        gtraces = build_traces(merged)
        complete = [tv for tv in gtraces.values()
                    if tv.complete_roots()]
        if not complete:
            problems.append("traced-fleet sample: no complete request "
                            "root reconstructed")
        from tpuframe_torch.obs import goodput as goodput_lib

        fleet = goodput_lib.fleet_stats(merged) or {}
        p99 = (fleet.get("ttft_exemplars") or {}).get("p99")
        if not p99 or p99.get("trace") not in gtraces:
            problems.append("traced-fleet sample: p99 exemplar does "
                            "not resolve to a reconstructed trace")

    # SLO sentry: defaults parse, and the rc contract holds on
    # synthetic streams (0 clean / 1 breach / 2 no data).
    from tpuframe_torch.obs import slo as slo_lib

    try:
        specs = slo_lib.parse_slos(slo_lib.DEFAULT_SLO)
        windows = slo_lib.parse_windows(slo_lib.DEFAULT_WINDOWS)
    except ValueError as exc:
        problems.append(f"SLO defaults unparseable: {exc}")
        return problems
    fast = [_rec("router_request", 100.0 + 0.1 * i, "checkh-p90",
                 id=i, replica="r0", ttft_ms=10.0) for i in range(20)]
    slow = [dict(r, ttft_ms=10.0 * specs[0].threshold_ms)
            for r in fast]
    for name, stream, want in (("clean", fast, 0), ("breach", slow, 1),
                               ("empty", [], 2)):
        got = slo_lib.evaluate(stream, specs, windows)["rc"]
        if got != want:
            problems.append(f"SLO rc contract: {name} stream returned "
                            f"rc {got} (want {want})")
    return problems
