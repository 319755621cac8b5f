"""Continuous batching over the engine's fixed decode slots (counterpart
of ``tpuframe/serve/scheduler.py``).

The decode step always runs all ``slots`` sequences; requests are
admitted into and retired from those slots at step boundaries, so a long
generation never blocks a short one behind it.  Per step, in order:

  1. admit   — for every free slot, pop the oldest pending request,
               prefill it and insert it.  TTFT stops here.
  2. decode  — ONE decode step over all slots (active or not).
  3. retire  — requests that hit ``max_new_tokens`` or the EOS id leave
               their slot free.
  4. admit   — again, so a slot freed by this step's retires is refilled
               this step.

Telemetry, as in the JAX scheduler: a typed ``serve_step`` event per step
and a ``serve_request`` event per retirement (TTFT/TPOT, token counts);
the exporter's queue, slot, token and TTFT/TPOT collectors when
``TPUFRAME_METRICS_PORT`` (or ``_TEXTFILE``) is set; and, for a traced
request, the ``queue``, ``prefill`` and ``decode`` spans under its
``serve`` span, which share their clock reads with TTFT.  All of it is a
no-op while no event log or exporter is open.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

from tpuframe_torch.obs import events as obs_events
from tpuframe_torch.obs import exporter as obs_exporter
from tpuframe_torch.obs import tracing
from tpuframe_torch.obs.goodput import _pct


@dataclass
class Request:
    """One generation request and its lifecycle record."""

    rid: int
    prompt: list
    max_new_tokens: int = 16
    arrival_t: float = 0.0            # scheduler clock, seconds
    # -- filled in by the scheduler --
    first_token_t: float | None = None
    done_t: float | None = None
    tokens: list = field(default_factory=list)   # generated tokens
    # Tracing context: trace id propagated in the /generate payload and
    # the replica-side "serve" span the scheduler's queue/prefill/decode
    # phase spans parent under.  None when the request is untraced.
    trace: str | None = None
    span: str | None = None

    @property
    def done(self) -> bool:
        return self.done_t is not None

    def ttft_ms(self) -> float | None:
        if self.first_token_t is None:
            return None
        return 1e3 * (self.first_token_t - self.arrival_t)

    def tpot_ms(self) -> float | None:
        """Time per output token AFTER the first (the decode cadence)."""
        if self.done_t is None or self.first_token_t is None \
                or len(self.tokens) < 2:
            return None
        return 1e3 * (self.done_t - self.first_token_t) \
            / (len(self.tokens) - 1)


class Scheduler:
    """Continuous-batching request loop over one :class:`LMEngine`.
    ``clock`` is injectable for fake-clock tests."""

    def __init__(self, engine, *, clock=time.monotonic):
        self.engine = engine
        self._clock = clock
        self.pending: list = []                 # FIFO of Request
        self.active: list = [None] * engine.slots
        self.completed: list = []
        self.step_count = 0
        self.tokens_generated = 0
        # Live telemetry (obs/exporter.py, env-gated no-op otherwise):
        # queue/slot/token gauges and TTFT/TPOT percentiles served
        # through pull collectors — a scrape between steps must see the
        # *current* pending depth (the router's admission signal), not
        # the last step's snapshot.
        self._exporter = obs_exporter.start_from_env()
        if self._exporter is not None:
            self._exporter.add_collector(self._latency_samples)
            self._exporter.add_collector(self._load_samples)

    def _load_samples(self):
        return [
            ("tpuframe_serve_queue_depth", {}, float(len(self.pending))),
            ("tpuframe_serve_active_slots", {},
             float(sum(r is not None for r in self.active))),
            ("tpuframe_serve_tokens_generated", {},
             float(self.tokens_generated)),
        ]

    def _latency_samples(self):
        ttft = sorted(v for v in (r.ttft_ms() for r in self.completed)
                      if v is not None)
        tpot = sorted(v for v in (r.tpot_ms() for r in self.completed)
                      if v is not None)
        out = []
        for name, vals in (("tpuframe_serve_ttft_ms", ttft),
                           ("tpuframe_serve_tpot_ms", tpot)):
            if vals:
                for q, frac in (("p50", 0.5), ("p90", 0.9), ("p99", 0.99)):
                    out.append((name, {"quantile": q}, _pct(vals, frac)))
        return out

    def submit(self, request: Request) -> None:
        if len(request.prompt) > max(self.engine.prompt_buckets):
            # Admission control: reject ahead of any shape decision.
            raise ValueError(
                f"request {request.rid}: prompt {len(request.prompt)} "
                f"exceeds largest bucket "
                f"{max(self.engine.prompt_buckets)}")
        self.pending.append(request)

    def has_work(self) -> bool:
        return bool(self.pending) or any(r is not None
                                         for r in self.active)

    def step(self) -> int:
        """One scheduler step (admit + decode + retire + admit).
        Returns the number of live tokens produced this step."""
        t0 = self._clock()
        admitted = self._admit()
        produced = 0
        if any(r is not None for r in self.active):
            toks = self.engine.decode_step()
            now = self._clock()
            for slot, req in enumerate(self.active):
                if req is None:
                    continue
                tok = int(toks[slot])
                req.tokens.append(tok)
                produced += 1
                if self._finished(req, tok):
                    req.done_t = now
                    self._retire(slot)
        admitted += self._admit()
        self.step_count += 1
        self.tokens_generated += produced + admitted
        obs_events.emit(
            "serve_step", step=self.step_count,
            wall_ms=round(1e3 * (self._clock() - t0), 3),
            active=sum(r is not None for r in self.active),
            admitted=admitted, produced=produced,
            queued=len(self.pending))
        return produced + admitted

    def _admit(self) -> int:
        """Fill free slots from the pending FIFO.  A request that finishes
        at prefill retires in place and its slot is reused at once."""
        admitted = 0
        slot = 0
        while self.pending and slot < self.engine.slots:
            if self.active[slot] is not None:
                slot += 1
                continue
            req = self.pending.pop(0)
            t_adm = self._clock()
            first_tok, pcache, length = self.engine.prefill(req.prompt)
            self.engine.insert(slot, pcache, length, first_tok)
            req.first_token_t = self._clock()
            req.tokens.append(first_tok)
            if req.trace is not None:
                # Phase spans share clock reads with the TTFT record:
                # arrival -> admit is queue, admit -> first token is
                # prefill, so queue.ms + prefill.ms == ttft_ms exactly
                # (modulo rounding) — the verify_traces invariant.
                tracing.span(req.trace, "queue", parent=req.span,
                             ms=1e3 * (t_adm - req.arrival_t))
                tracing.span(req.trace, "prefill", parent=req.span,
                             ms=1e3 * (req.first_token_t - t_adm),
                             engine_ms=getattr(self.engine,
                                               "last_prefill_ms", None))
            self.active[slot] = req
            admitted += 1
            if self._finished(req, first_tok):
                self._retire(slot)
            else:
                slot += 1
        return admitted

    def _finished(self, req: Request, tok: int) -> bool:
        return (len(req.tokens) >= req.max_new_tokens
                or (self.engine.eos_id is not None
                    and tok == self.engine.eos_id))

    def _retire(self, slot: int) -> None:
        req = self.active[slot]
        self.active[slot] = None
        if req.done_t is None:
            req.done_t = self._clock()
        self.completed.append(req)
        if req.trace is not None and req.first_token_t is not None:
            tracing.span(req.trace, "decode", parent=req.span,
                         ms=1e3 * (req.done_t - req.first_token_t),
                         tokens=len(req.tokens))
        obs_events.emit(
            "serve_request", id=req.rid, trace=req.trace,
            prompt_tokens=len(req.prompt),
            output_tokens=len(req.tokens),
            ttft_ms=round(req.ttft_ms() or 0.0, 3),
            tpot_ms=round(req.tpot_ms(), 3)
            if req.tpot_ms() is not None else None)
