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

The JAX scheduler's obs events, live exporter and tracing spans belong to
the observability slice, not yet ported; ``Request.trace`` stays None.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field


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
            first_tok, pcache, length = self.engine.prefill(req.prompt)
            self.engine.insert(slot, pcache, length, first_tok)
            req.first_token_t = self._clock()
            req.tokens.append(first_tok)
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
