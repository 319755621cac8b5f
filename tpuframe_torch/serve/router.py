"""Health-driven fleet router (counterpart of ``tpuframe/serve/router.py``):
admission control, drain, hedged retries.

A router that load-balances generation requests over N replica processes
(``serve/replica.py``) and keeps the fleet available under partial
failure.

Contract:

  admission   ``submit()`` either accepts into a *bounded* pending queue
              or sheds explicitly (429-style, ``router_shed`` event +
              counter) — never unbounded buffering.  Acknowledgment at
              the router means exactly this: an admitted request retires
              exactly once or the run is wrong; a shed request was never
              acknowledged.
  placement   least-loaded healthy replica: local in-flight count first,
              then the live ``tpuframe_serve_queue_depth`` gauge scraped
              off ``/metrics``.
  drain       a 503 from ``/healthz``, a scrape timeout, or a failed
              dispatch marks the replica draining (sticky): no new
              dispatches, and its in-flight requests are re-queued for
              re-dispatch (``router_drain`` / ``router_redispatch``).
              Original attempts keep racing — a gracefully draining
              replica finishes its accepted work and may still win.
  hedging     an in-flight request older than ``hedge_ms`` with no
              racing attempt gets one hedge on another replica
              (``router_hedge``).  First winner kept; losers counted as
              duplicates.  Safe because decode is deterministic
              (greedy argmax / FakeEngine's pure token function):
              re-prefill reproduces the same stream on any replica.
  transport   every scrape and dispatch goes through
              :class:`~tpuframe_torch.resilience.policy.RetryPolicy`
              (decorrelated jitter, attempt timeout, deadline), over
              :func:`http_transport`, the one client seam.

Threading: dispatch attempts run on daemon threads that only do stdlib
HTTP and a queue put (never torch or a collective); all router state is
owned by the single-threaded ``step()`` loop, which consumes attempt
outcomes from the done queue.  Every duration is a ``time.monotonic``
delta, the scheduler's clock too, so ``verify_traces``' TTFT sum holds.

Env knobs: ``TPUFRAME_ROUTER_QUEUE`` (pending bound, default 64),
``TPUFRAME_HEDGE_MS`` (hedge threshold, default 1000),
``TPUFRAME_ROUTER_REPLICAS`` (fleet size; the JAX package's serve CLI
reads it for ``--fleet``, which the port has not yet).
"""

from __future__ import annotations

import json
import os
import queue
import random
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from dataclasses import dataclass, field

from tpuframe_torch.obs import events as obs_events
from tpuframe_torch.obs import tracing
from tpuframe_torch.obs.goodput import _pct
from tpuframe_torch.resilience.policy import RetryPolicy

ENV_REPLICAS = "TPUFRAME_ROUTER_REPLICAS"
ENV_QUEUE = "TPUFRAME_ROUTER_QUEUE"
ENV_HEDGE_MS = "TPUFRAME_HEDGE_MS"

DEFAULT_QUEUE = 64
DEFAULT_HEDGE_MS = 1000.0
DEFAULT_REPLICAS = 2

ROUTER_EVENT_TYPES = (
    "router_admit", "router_shed", "router_dispatch", "router_hedge",
    "router_redispatch", "router_drain", "router_request",
    "router_summary",
)


def _env_num(name: str, default, cast):
    raw = os.environ.get(name, "").strip()
    if not raw:
        return default
    try:
        return cast(raw)
    except ValueError:
        return default


def resolve_queue_limit() -> int:
    return max(1, _env_num(ENV_QUEUE, DEFAULT_QUEUE, int))


def resolve_hedge_ms() -> float:
    return _env_num(ENV_HEDGE_MS, DEFAULT_HEDGE_MS, float)


def resolve_replicas() -> int:
    return max(1, _env_num(ENV_REPLICAS, DEFAULT_REPLICAS, int))


def http_transport(url: str, payload: dict | None, timeout_s: float):
    """The one raw-HTTP seam: POST ``payload`` as JSON, GET when
    ``payload`` is None.  Returns ``(status, parsed body)`` — an HTTP
    error status is an *answer* (503 from a draining replica must not
    burn retry budget); only transport failures raise, as OSError
    subclasses the RetryPolicy's default classification retries."""
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(
        url, data=data,
        headers={"Content-Type": "application/json"} if data else {})
    try:
        with urllib.request.urlopen(req, timeout=timeout_s) as r:
            status, body = r.status, r.read()
    except urllib.error.HTTPError as e:
        status, body = e.code, e.read()
    text = body.decode("utf-8", "replace")
    try:
        return status, json.loads(text)
    except ValueError:
        return status, text


def parse_gauges(text: str, names) -> dict:
    """Label-free gauge samples out of an OpenMetrics page — enough to
    read the queue-depth/active-slots signals off a replica scrape."""
    out: dict = {}
    wanted = set(names)
    for line in text.splitlines():
        if line.startswith("#"):
            continue
        parts = line.split()
        if len(parts) == 2 and parts[0] in wanted:
            try:
                out[parts[0]] = float(parts[1])
            except ValueError:
                pass
    return out


class Shed(RuntimeError):
    """Raised by ``submit(..., raise_on_shed=True)`` — the 429 analogue."""


@dataclass
class ReplicaHandle:
    """The router's view of one replica."""

    url: str
    name: str
    state: str = "ok"                  # "ok" -> "draining" (sticky)
    queue_depth: float = 0.0
    active_slots: float = 0.0
    last_scrape_t: float = -1e18
    inflight: set = field(default_factory=set)   # rids dispatched here
    # Served weights version, scraped off the replica's label-free
    # ``tpuframe_weights_version`` gauge; None until first seen.  The
    # rollout controller reads this to prove the mixed-version window
    # is bounded (and the canary constraint routes on it).
    version: int | None = None


@dataclass
class RoutedRequest:
    """One request's lifecycle at the router."""

    rid: int
    prompt: list
    max_new_tokens: int
    submit_t: float
    attempts: int = 0                  # dispatches launched (all causes)
    live: int = 0                      # attempt threads still running
    hedged: bool = False
    requeued: bool = False             # next dispatch is a re-dispatch
    last_launch_t: float | None = None
    done_t: float | None = None
    ttft_ms: float | None = None       # router wait + winning replica TTFT
    replica: str | None = None         # winning replica
    result: dict | None = None
    # Tracing context (None when sampled out): the trace id minted at
    # admission and the root "request" span every attempt/serve span
    # parents under.  Rides the dispatch payload into the replica.
    trace: str | None = None
    root_span: str | None = None

    @property
    def done(self) -> bool:
        return self.done_t is not None


class Router:
    """Single-threaded routing loop over a fleet of replica endpoints.

    ``transport`` is injectable (``fn(url, payload|None, timeout_s) ->
    (status, body)``) so the whole drain/hedge/shed state machine is
    unit-testable without processes; the default is
    :func:`http_transport` under the dispatch/scrape RetryPolicies.
    """

    def __init__(self, replica_urls, *, queue_limit: int | None = None,
                 hedge_ms: float | None = None,
                 scrape_interval_s: float = 0.25,
                 scrape_timeout_s: float = 1.0,
                 dispatch_timeout_s: float = 60.0,
                 max_inflight_per_replica: int = 4,
                 transport=None, dispatch_policy: RetryPolicy | None = None,
                 scrape_policy: RetryPolicy | None = None,
                 clock=time.monotonic):
        self.replicas = [ReplicaHandle(url=str(u).rstrip("/"), name=f"r{i}")
                         for i, u in enumerate(replica_urls)]
        self.queue_limit = (resolve_queue_limit() if queue_limit is None
                            else max(1, int(queue_limit)))
        self.hedge_ms = (resolve_hedge_ms() if hedge_ms is None
                         else float(hedge_ms))
        self.scrape_interval_s = scrape_interval_s
        self.scrape_timeout_s = scrape_timeout_s
        self.dispatch_timeout_s = dispatch_timeout_s
        self.max_inflight_per_replica = max_inflight_per_replica
        self._clock = clock
        self._transport = transport or http_transport
        # Both policies bounded on every axis: attempts, per-attempt
        # timeout AND deadline — a router retry loop must never outlive
        # the request it is retrying for.
        self.dispatch_policy = dispatch_policy or RetryPolicy(
            max_attempts=2, base_delay_s=0.02, max_delay_s=0.25,
            attempt_timeout_s=dispatch_timeout_s,
            deadline_s=2.0 * dispatch_timeout_s)
        self.scrape_policy = scrape_policy or RetryPolicy(
            max_attempts=2, base_delay_s=0.02, max_delay_s=0.25,
            attempt_timeout_s=scrape_timeout_s,
            deadline_s=4.0 * scrape_timeout_s)
        self.pending: list[RoutedRequest] = []
        self.inflight: dict[int, RoutedRequest] = {}
        self.completed: list[RoutedRequest] = []
        self.counters = {"admitted": 0, "shed": 0, "completed": 0,
                         "hedged": 0, "redispatched": 0, "duplicates": 0,
                         "dispatch_errors": 0, "drains": 0}
        self._done_q: queue.SimpleQueue = queue.SimpleQueue()
        # Attempt spans launched but not yet reaped — lets run() grant a
        # bounded grace window so late hedge losers close their spans
        # instead of leaking them into the offline anomaly sweep.
        self._open_attempts: set[tuple[str, str]] = set()
        # Canary constraint (rollout controller): while set, a seeded
        # fraction of fresh placements is steered onto the canary
        # replica and the rest onto the old-version pool.
        self._canary_name: str | None = None
        self._canary_frac = 0.0
        self._canary_rng = random.Random(0)

    # -- admission ---------------------------------------------------------

    def submit(self, rid: int, prompt, max_new_tokens: int = 8, *,
               raise_on_shed: bool = False) -> bool:
        """Admit into the bounded queue or shed explicitly.  Admission is
        the router's acknowledgment: an admitted request retires exactly
        once; a shed one was never accepted (and is counted, never
        silently dropped)."""
        depth = len(self.pending) + len(self.inflight)
        if depth >= self.queue_limit:
            self.counters["shed"] += 1
            obs_events.emit("router_shed", id=rid, queued=depth)
            if raise_on_shed:
                raise Shed(f"request {rid}: router queue full "
                           f"({depth}/{self.queue_limit})")
            return False
        req = RoutedRequest(
            rid=rid, prompt=list(prompt),
            max_new_tokens=int(max_new_tokens), submit_t=self._clock(),
            trace=tracing.mint(rid))
        if req.trace is not None:
            req.root_span = tracing.open_span(req.trace, "request",
                                              rid=rid)
        self.pending.append(req)
        self.counters["admitted"] += 1
        obs_events.emit("router_admit", id=rid, trace=req.trace)
        return True

    # -- the routing loop --------------------------------------------------

    def step(self) -> None:
        """One router tick: reap finished attempts, scrape due health,
        hedge stragglers, dispatch what the fleet has capacity for."""
        now = self._clock()
        self._reap()
        self._scrape_due(now)
        self._hedge_due(now)
        self._dispatch_pending()

    def has_work(self) -> bool:
        return bool(self.pending) or bool(self.inflight)

    def _replica(self, name: str) -> ReplicaHandle | None:
        for rep in self.replicas:
            if rep.name == name:
                return rep
        return None

    def set_canary(self, name: str, frac: float, *, seed: int = 0) -> None:
        """Arm the canary placement constraint: a seeded ``frac`` of
        fresh placements lands on replica ``name`` (the new version),
        the rest on the old-version pool — the version constraint the
        rollout gate's old-vs-new comparison needs."""
        self._canary_name = name
        self._canary_frac = min(1.0, max(0.0, float(frac)))
        self._canary_rng = random.Random(seed)

    def clear_canary(self) -> None:
        self._canary_name = None
        self._canary_frac = 0.0

    def _pick(self, exclude_rid: int | None = None
              ) -> ReplicaHandle | None:
        """Least-loaded healthy replica with dispatch capacity, never one
        already holding this rid (a hedge/redispatch must race a
        *different* replica).  Under an armed canary constraint the
        eligible pool is first split canary/rest and one seeded draw
        selects the side — so the traffic fraction is deterministic
        given the seed and the dispatch order."""
        eligible = []
        for rep in self.replicas:
            if rep.state != "ok":
                continue
            if exclude_rid is not None and exclude_rid in rep.inflight:
                continue
            if len(rep.inflight) >= self.max_inflight_per_replica:
                continue
            eligible.append(rep)
        if self._canary_name is not None:
            canary = [r for r in eligible if r.name == self._canary_name]
            rest = [r for r in eligible if r.name != self._canary_name]
            if canary and rest:
                draw = self._canary_rng.random()
                eligible = canary if draw < self._canary_frac else rest
            # One side empty: fall through on whatever has capacity —
            # availability beats the traffic split.
        best = None
        for rep in eligible:
            load = (len(rep.inflight), rep.queue_depth)
            if best is None or load < best[0]:
                best = (load, rep)
        return None if best is None else best[1]

    def drain_replica(self, name: str, *, reason: str) -> bool:
        """Operator/rollout-initiated drain: same sticky state and
        redispatch contract as a health-detected one — no new
        dispatches, in-flight work requeued, originals keep racing."""
        rep = self._replica(name)
        if rep is None:
            return False
        self._mark_draining(rep, reason=reason)
        return True

    def readmit(self, name: str) -> bool:
        """Undo a sticky drain after the rollout controller swapped and
        re-verified the replica: back to "ok", with the scrape clock
        reset so the next step() re-reads its health and version gauge
        immediately."""
        rep = self._replica(name)
        if rep is None:
            return False
        rep.state = "ok"
        rep.last_scrape_t = -1e18
        return True

    def _launch(self, req: RoutedRequest, rep: ReplicaHandle, *,
                cause: str) -> None:
        req.attempts += 1
        req.live += 1
        req.last_launch_t = self._clock()
        rep.inflight.add(req.rid)
        self.inflight[req.rid] = req
        start_t = req.last_launch_t
        url = rep.url + "/generate"
        payload = {"rid": req.rid, "prompt": req.prompt,
                   "max_new_tokens": req.max_new_tokens}
        span = None
        if req.trace is not None:
            span = tracing.open_span(req.trace, "attempt",
                                     parent=req.root_span,
                                     replica=rep.name, cause=cause)
            self._open_attempts.add((req.trace, span))
            # Context propagation: the replica parents its serve span
            # under this attempt, so a hedge race reconstructs as two
            # sibling attempt subtrees of one root.
            payload["trace"] = req.trace
            payload["span"] = span
        trace = req.trace

        def attempt():
            try:
                status, body = self.dispatch_policy.call(
                    self._transport, url, payload,
                    self.dispatch_timeout_s, op="router_dispatch")
                self._done_q.put((req.rid, rep.name, start_t, status,
                                  body, trace, span))
            except Exception as e:  # noqa: BLE001 — retries exhausted or
                # non-retryable: the loop requeues/marks draining
                self._done_q.put((req.rid, rep.name, start_t, None, e,
                                  trace, span))

        # This thread only does stdlib HTTP + a queue put — it never
        # touches torch or a collective; all shared state is owned by the
        # step() loop, which consumes outcomes from the done queue.
        threading.Thread(
            target=attempt, daemon=True,
            name=f"router-dispatch-{req.rid}-{rep.name}").start()
        etype = {"hedge": "router_hedge",
                 "redispatch": "router_redispatch"}.get(
            cause, "router_dispatch")
        obs_events.emit(etype, id=req.rid, replica=rep.name)

    def _close_attempt(self, trace, span, start_t: float, *,
                       status: str, **fields) -> None:
        if trace is None or span is None:
            return
        self._open_attempts.discard((trace, span))
        tracing.close_span(trace, span,
                           1e3 * max(0.0, self._clock() - start_t),
                           status=status, **fields)

    def _reap(self) -> None:
        while True:
            try:
                rid, rep_name, start_t, status, body, trace, span = \
                    self._done_q.get_nowait()
            except queue.Empty:
                return
            rep = self._replica(rep_name)
            if rep is not None:
                rep.inflight.discard(rid)
            req = self.inflight.get(rid)
            if req is None or req.done:
                # Hedge/redispatch loser finishing late: first winner
                # was kept, this one is only counted — and its span
                # closes ``duplicate=true`` under the same trace.
                if status == 200:
                    self.counters["duplicates"] += 1
                    self._close_attempt(trace, span, start_t,
                                        status="ok", duplicate=True)
                else:
                    self._close_attempt(trace, span, start_t,
                                        status="error", duplicate=True)
                continue
            req.live -= 1
            if status == 200 and isinstance(body, dict):
                self._close_attempt(trace, span, start_t, status="ok")
                self._complete(req, rep_name, start_t, body)
                continue
            self._close_attempt(
                trace, span, start_t, status="error",
                detail=(type(body).__name__ if status is None
                        else int(status)))
            self.counters["dispatch_errors"] += 1
            if rep is not None and rep.state == "ok":
                why = (f"dispatch {type(body).__name__}"
                       if status is None else f"generate {status}")
                self._mark_draining(rep, reason=why)
            if req.live <= 0 and req not in self.pending:
                # No racing attempt left: back to the queue front.
                req.requeued = True
                self.pending.insert(0, req)
                if req.trace is not None:
                    tracing.note(req.trace, "requeue",
                                 span=req.root_span, replica=rep_name)

    def _complete(self, req: RoutedRequest, rep_name: str, start_t: float,
                  body: dict) -> None:
        req.done_t = self._clock()
        req.replica = rep_name
        req.result = body
        wait_ms = 1e3 * max(0.0, start_t - req.submit_t)
        req.ttft_ms = wait_ms + float(body.get("ttft_ms") or 0.0)
        self.inflight.pop(req.rid, None)
        if req in self.pending:
            self.pending.remove(req)
        self.completed.append(req)
        self.counters["completed"] += 1
        if req.trace is not None and req.root_span is not None:
            # wait_ms + the replica's queue + prefill spans must sum to
            # this ttft_ms — the invariant verify_traces enforces.
            tracing.close_span(
                req.trace, req.root_span,
                1e3 * max(0.0, req.done_t - req.submit_t),
                replica=rep_name, ttft_ms=round(req.ttft_ms, 3),
                wait_ms=round(wait_ms, 3),
                tokens=len(body.get("tokens") or []))
        obs_events.emit(
            "router_request", id=req.rid, replica=rep_name,
            ttft_ms=round(req.ttft_ms, 3),
            wait_ms=round(wait_ms, 3), trace=req.trace,
            output_tokens=len(body.get("tokens") or []),
            attempts=req.attempts)

    def _mark_draining(self, rep: ReplicaHandle, *, reason: str) -> None:
        """503 / scrape timeout / dispatch failure: stop dispatching to
        this replica and requeue its in-flight work for re-dispatch.
        Original attempts keep racing (a graceful drain finishes its
        accepted requests and may still win — first winner kept)."""
        if rep.state == "draining":
            return
        rep.state = "draining"
        self.counters["drains"] += 1
        obs_events.emit("router_drain", replica=rep.name, reason=reason)
        for rid in sorted(rep.inflight):
            req = self.inflight.get(rid)
            if req is None or req.done or req in self.pending:
                continue
            req.requeued = True
            self.pending.insert(0, req)
            if req.trace is not None:
                tracing.note(req.trace, "drain_requeue",
                             span=req.root_span, replica=rep.name,
                             reason=reason)

    def _scrape_due(self, now: float) -> None:
        for rep in self.replicas:
            if (rep.state != "ok"
                    or now - rep.last_scrape_t < self.scrape_interval_s):
                continue
            rep.last_scrape_t = now
            try:
                status, _body = self.scrape_policy.call(
                    self._transport, rep.url + "/healthz", None,
                    self.scrape_timeout_s, op="router_scrape")
            except Exception as e:  # noqa: BLE001 — unreachable after
                # retries: that IS the drain signal
                self._mark_draining(rep,
                                    reason=f"scrape {type(e).__name__}")
                continue
            if status != 200:
                self._mark_draining(rep, reason=f"healthz {status}")
                continue
            try:
                _s, text = self.scrape_policy.call(
                    self._transport, rep.url + "/metrics", None,
                    self.scrape_timeout_s, op="router_scrape")
                gauges = parse_gauges(
                    text if isinstance(text, str) else "",
                    ("tpuframe_serve_queue_depth",
                     "tpuframe_serve_active_slots",
                     "tpuframe_weights_version"))
                rep.queue_depth = gauges.get("tpuframe_serve_queue_depth",
                                             rep.queue_depth)
                rep.active_slots = gauges.get(
                    "tpuframe_serve_active_slots", rep.active_slots)
                if "tpuframe_weights_version" in gauges:
                    rep.version = int(gauges["tpuframe_weights_version"])
            except Exception:  # noqa: BLE001 — the load signal is
                pass  # best-effort; /healthz above is authoritative

    def _hedge_due(self, now: float) -> None:
        if self.hedge_ms <= 0:
            return
        for req in list(self.inflight.values()):
            if (req.done or req.hedged or req.live != 1
                    or req in self.pending
                    or req.last_launch_t is None):
                continue
            if 1e3 * (now - req.last_launch_t) < self.hedge_ms:
                continue
            rep = self._pick(exclude_rid=req.rid)
            if rep is None:
                continue
            req.hedged = True
            self.counters["hedged"] += 1
            self._launch(req, rep, cause="hedge")

    def _dispatch_pending(self) -> None:
        while self.pending:
            req = self.pending[0]
            if req.done:
                self.pending.pop(0)
                continue
            rep = self._pick(exclude_rid=req.rid)
            if rep is None:
                return
            self.pending.pop(0)
            if req.requeued:
                self.counters["redispatched"] += 1
                self._launch(req, rep, cause="redispatch")
                req.requeued = False
            else:
                self._launch(req, rep, cause="first")

    # -- open-loop drive ---------------------------------------------------

    def run(self, requests, *, timeout_s: float = 60.0,
            arrival_speedup: float = 1.0, poll_s: float = 0.002,
            on_tick=None, log=None) -> dict:
        """Drive the loadgen's seeded schedule through the fleet: submit
        each request once the wall clock passes its ``arrival_t`` (virtual
        seconds scaled by ``arrival_speedup``), tick the router until
        everything admitted has retired (or ``timeout_s`` trips — counted
        as lost, never silently).  ``on_tick()`` (if given) runs once per
        loop after ``step()`` — the rollout controller's drive seam; when
        it returns a truthy "keep running" the loop also waits for it,
        not just for the request backlog."""
        todo = sorted(requests, key=lambda r: r.arrival_t)
        t0 = self._clock()
        i = 0
        timed_out = False
        while True:
            now = self._clock() - t0
            while (i < len(todo)
                   and todo[i].arrival_t / arrival_speedup <= now):
                r = todo[i]
                i += 1
                self.submit(r.rid, r.prompt, r.max_new_tokens)
            self.step()
            tick_busy = bool(on_tick()) if on_tick is not None else False
            if i >= len(todo) and not self.has_work() and not tick_busy:
                break
            if now > timeout_s:
                timed_out = True
                break
            time.sleep(poll_s)
        # Bounded grace for late hedge/redispatch losers: their attempt
        # threads may still be in flight after every request retired;
        # reap them so their spans close as duplicates instead of
        # leaking.  Wall clock on purpose — tests inject fake _clocks
        # that do not advance while we sleep.
        grace_end = time.monotonic() + 2.0
        while self._open_attempts and time.monotonic() < grace_end:
            self._reap()
            time.sleep(poll_s)
        out = self.summary()
        out["submitted"] = i
        out["timed_out"] = timed_out
        if log:
            log(f"fleet: {out['requests']}/{out['admitted']} admitted "
                f"requests completed, {out['shed']} shed, "
                f"{out['redispatched']} redispatched, "
                f"{out['hedged']} hedged, {out['drains']} drain(s)")
        return out

    def summary(self) -> dict:
        """Fleet rollup (also emitted as the typed ``router_summary``)."""
        ttft = sorted(r.ttft_ms for r in self.completed
                      if r.ttft_ms is not None)
        out = {
            "requests": self.counters["completed"],
            "admitted": self.counters["admitted"],
            "shed": self.counters["shed"],
            "lost": self.counters["admitted"] - self.counters["completed"],
            "hedged": self.counters["hedged"],
            "redispatched": self.counters["redispatched"],
            "duplicates": self.counters["duplicates"],
            "dispatch_errors": self.counters["dispatch_errors"],
            "drains": self.counters["drains"],
            "replicas": len(self.replicas),
            "versions": {rep.name: rep.version for rep in self.replicas},
            "ttft_ms": {q: round(_pct(ttft, v), 3) for q, v in
                        (("p50", 0.5), ("p90", 0.9), ("p99", 0.99))}
            if ttft else None,
        }
        flat = {k: v for k, v in out.items() if not isinstance(v, dict)}
        if out["ttft_ms"]:
            flat.update({f"ttft_{q}_ms": v
                         for q, v in out["ttft_ms"].items()})
        obs_events.emit("router_summary", **flat)
        return out


# ---------------------------------------------------------------------------
# Fleet harness — subprocess replicas + router (the CPU fleet tests; the
# JAX package's chaos tier and serve --selfcheck use its twin).
# ---------------------------------------------------------------------------

_PKG_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

def _spawn_replica(rank: int, *, tmpdir: str, events_dir: str | None,
                   engine: str, slots: int, step_delay_ms: float,
                   stall_timeout_s: float, faults_spec: str | None,
                   weights_version: int = 0, port: int = 0,
                   device: str = "cuda"):
    ready = os.path.join(tmpdir, f"ready.{rank}")
    log_path = os.path.join(tmpdir, f"replica.{rank}.log")
    env = dict(os.environ)
    env.update({
        # 0 = ephemeral (port read back via READY); a relaunch after a
        # mid-swap kill passes the dead replica's port so the router's
        # URL stays valid.
        "TPUFRAME_METRICS_PORT": str(port),
        "TPUFRAME_PROCESS_ID": str(rank),
        "TPUFRAME_ATTEMPT": env.get("TPUFRAME_ATTEMPT", "0"),
        # the replica imports this package from the same checkout
        "PYTHONPATH": os.pathsep.join(
            p for p in (_PKG_ROOT, env.get("PYTHONPATH")) if p),
    })
    env.pop("TPUFRAME_FAULTS", None)
    # the removed legacy aliases RAISE at registry build — scrub them so
    # an operator shell that still exports one cannot take down a
    # replica that never asked for a fault
    env.pop("TPUFRAME_FAULT_STEP", None)
    env.pop("TPUFRAME_FAULT_ONCE", None)
    if events_dir:
        env["TPUFRAME_EVENTS_DIR"] = events_dir
    if faults_spec:
        env["TPUFRAME_FAULTS"] = faults_spec
    cmd = [sys.executable, "-m", "tpuframe_torch.serve.replica",
           "--engine", engine, "--device", device, "--slots", str(slots),
           "--step-delay-ms", str(step_delay_ms),
           "--stall-timeout-s", str(stall_timeout_s),
           "--weights-version", str(weights_version),
           "--max-idle-s", "60", "--ready-file", ready]
    log_fh = open(log_path, "wb")
    proc = subprocess.Popen(cmd, env=env, stdout=log_fh, stderr=log_fh)
    log_fh.close()
    return proc, ready, log_path


def _wait_ready(proc, ready_path: str, *, timeout_s: float) -> int:
    """Poll the replica's ready file for its bound port."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if os.path.exists(ready_path):
            text = open(ready_path).read()
            for part in text.split():
                if part.startswith("port="):
                    return int(part.split("=", 1)[1])
        if proc.poll() is not None:
            raise RuntimeError(
                f"replica exited rc={proc.returncode} before READY")
        time.sleep(0.01)
    raise RuntimeError(f"replica not ready after {timeout_s}s")


def fleet_smoke(*, replicas: int = 2, n_requests: int = 12,
                kill_rank: int | None = None, kill_step: int = 3,
                seed: int = 0, events_dir: str | None = None,
                engine: str = "fake", slots: int = 2, device: str = "cuda",
                step_delay_ms: float = 5.0, rate: float = 50.0,
                max_new_tokens: int = 8, queue_limit: int | None = None,
                hedge_ms: float | None = None,
                scrape_interval_s: float = 0.05,
                timeout_s: float = 60.0, ready_timeout_s: float = 30.0,
                log=None) -> dict:
    """Spawn a fleet of replica subprocesses
    (``python -m tpuframe_torch.serve.replica``; ``device`` is the
    tiny-lm engine's), drive the seeded Poisson loadgen through the
    router, optionally ``replica_crash`` one replica mid-run, tear the
    fleet down, and return the router summary plus replica exit codes."""
    import shutil
    import tempfile

    from tpuframe_torch.serve import loadgen

    tmpdir = tempfile.mkdtemp(prefix="tpuframe-fleet-")
    procs = []
    old_proc_id = os.environ.get("TPUFRAME_PROCESS_ID")
    try:
        for rank in range(replicas):
            spec = None
            if kill_rank is not None and rank == kill_rank:
                spec = (f"replica_crash:step={kill_step}"
                        f":rank={kill_rank}")
            procs.append(_spawn_replica(
                rank, tmpdir=tmpdir, events_dir=events_dir, engine=engine,
                slots=slots, step_delay_ms=step_delay_ms,
                stall_timeout_s=2.0, faults_spec=spec, device=device))
        urls = [f"http://127.0.0.1:"
                f"{_wait_ready(p, ready, timeout_s=ready_timeout_s)}"
                for p, ready, _log in procs]
        if events_dir:
            # The router's own events get their own per-process file
            # (the replicas own ranks 0..N-1).
            os.environ["TPUFRAME_PROCESS_ID"] = str(replicas + 90)
            obs_events.init(events_dir)
        reqs = loadgen.synthetic_requests(
            n_requests, buckets=(16, 32), rate=rate,
            max_new_tokens=max_new_tokens, vocab_size=256, seed=seed)
        router = Router(urls, queue_limit=queue_limit, hedge_ms=hedge_ms,
                        scrape_interval_s=scrape_interval_s,
                        scrape_timeout_s=0.5, dispatch_timeout_s=30.0,
                        max_inflight_per_replica=max(2, slots))
        out = router.run(reqs, timeout_s=timeout_s, log=log)
        if events_dir:
            obs_events.close()
        for proc, _ready, _log in procs:
            if proc.poll() is None:
                proc.terminate()  # graceful drain path (SIGTERM)
        exit_codes = []
        for proc, _ready, _log in procs:
            try:
                exit_codes.append(proc.wait(timeout=10))
            except subprocess.TimeoutExpired:
                proc.kill()
                exit_codes.append(proc.wait(timeout=10))
        out["exit_codes"] = exit_codes
        return out
    finally:
        if old_proc_id is None:
            os.environ.pop("TPUFRAME_PROCESS_ID", None)
        else:
            os.environ["TPUFRAME_PROCESS_ID"] = old_proc_id
        for proc, _ready, _log in procs:
            if proc.poll() is None:
                proc.kill()
        shutil.rmtree(tmpdir, ignore_errors=True)


# ---------------------------------------------------------------------------
# Self-check.
# ---------------------------------------------------------------------------

def check() -> list:
    """Host-only router checks: event registration, admission
    arithmetic, bounded retry policies, and the replica fault seams.  The
    JAX check's source-lint leg (rule TF118) waits for the lint rules
    (ROADMAP.md queue 1, item 14).  Returns problem strings; [] means
    healthy."""
    problems: list = []

    from tpuframe_torch.obs import events as events_lib

    for etype in ROUTER_EVENT_TYPES:
        if etype not in events_lib.REQUIRED_FIELDS:
            problems.append(
                f"router event type {etype!r} not registered in "
                f"obs.events.REQUIRED_FIELDS")

    # Admission control: the bounded queue sheds at the limit and counts
    # it — never unbounded buffering.
    r = Router(["http://127.0.0.1:9"], queue_limit=2,
               transport=lambda *_a, **_k: (503, "check() never dispatches"))
    if not (r.submit(0, [1, 2]) and r.submit(1, [1, 2])):
        problems.append("admission control: queue rejected below limit")
    if r.submit(2, [1, 2]):
        problems.append("admission control: queue did not shed at limit")
    if r.counters["shed"] != 1 or r.counters["admitted"] != 2:
        problems.append(
            f"admission counters wrong: {r.counters['admitted']} admitted,"
            f" {r.counters['shed']} shed (want 2, 1)")

    for pol, what in ((r.dispatch_policy, "dispatch"),
                      (r.scrape_policy, "scrape")):
        if pol.max_attempts < 1 or pol.deadline_s is None \
                or pol.attempt_timeout_s is None:
            problems.append(f"{what} RetryPolicy unbounded "
                            f"(attempts/timeout/deadline must all be set)")

    from tpuframe_torch.resilience import faults as faults_lib

    for seam, kind in (("replica_crash", "crash"),
                       ("replica_hang", "hang"),
                       ("replica_slow", "slow")):
        try:
            parsed = faults_lib.parse(seam)
        except ValueError as exc:
            problems.append(f"fault seam {seam} unparseable: {exc}")
            continue
        if not parsed or parsed[0].kind != kind:
            problems.append(f"fault seam {seam}: default kind "
                            f"{parsed[0].kind if parsed else '?'} "
                            f"(want {kind})")

    if resolve_queue_limit() < 1:
        problems.append("TPUFRAME_ROUTER_QUEUE resolved below 1")
    if resolve_replicas() < 1:
        problems.append("TPUFRAME_ROUTER_REPLICAS resolved below 1")

    return problems
