"""Retry policies for transient I/O failures (counterpart of
``tpuframe/resilience/policy.py``).

Every storage operation of the port (``data/gcs.py``, and through it every
checkpoint file read and write) runs under a :class:`RetryPolicy`:
exponential backoff with decorrelated jitter (each delay drawn uniformly
from ``[base, prev * 3]``, capped), and an overall deadline.  Only
transient errors retry: a ``FileNotFoundError`` is a fact about the
storage, and retrying it turns a crisp error into a slow one.

Retry activity is counted in :data:`COUNTERS` under the JAX package's
names (``retry.<op>.retries`` / ``.recovered`` / ``.exhausted``) and
emitted as ``retry`` events (``tpuframe_torch.obs.events``; a no-op while
no event log is open).
"""

from __future__ import annotations

import functools
import random
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable

from tpuframe_torch.obs import events

# Exception types that are facts about the request, not the transport.
_NON_RETRYABLE_OS = (
    FileNotFoundError,
    FileExistsError,
    IsADirectoryError,
    NotADirectoryError,
    PermissionError,
)

# Transient storage-client error classes, matched by name so that the
# classification works without those packages.
_RETRYABLE_NAMES = frozenset({
    "ServiceUnavailable",       # 503
    "TooManyRequests",          # 429
    "InternalServerError",      # 500
    "BadGateway",               # 502
    "GatewayTimeout",           # 504
    "DeadlineExceeded",
    "RetryError",
    "TransportError",
    "ChunkedEncodingError",
    "ProtocolError",
    "IncompleteRead",
})

# The process's retry counters (``tpuframe.obs.metrics``'s in the JAX
# package), by name.
COUNTERS: dict[str, int] = {}
_COUNTERS_LOCK = threading.Lock()


def bump(name: str, n: int = 1) -> None:
    with _COUNTERS_LOCK:
        COUNTERS[name] = COUNTERS.get(name, 0) + n


def counters(prefix: str = "") -> dict[str, int]:
    """A copy of the counters whose names start with ``prefix``."""
    with _COUNTERS_LOCK:
        return {k: v for k, v in COUNTERS.items() if k.startswith(prefix)}


def is_retryable(exc: BaseException) -> bool:
    """Default transient-vs-permanent classification: any ``OSError`` but
    the permanent shapes above, or a transient client error by name."""
    if isinstance(exc, _NON_RETRYABLE_OS):
        return False
    if isinstance(exc, OSError):
        return True
    return any(c.__name__ in _RETRYABLE_NAMES for c in type(exc).__mro__)


def _record(op: str, counter: str, outcome: str, attempt: int) -> None:
    bump(f"retry.{op}.{counter}")
    # attempt_n, not attempt: the envelope's ``attempt`` is the
    # supervisor's relaunch counter
    events.emit("retry", op=op, outcome=outcome, attempt_n=attempt)


@dataclass
class RetryPolicy:
    """Bounded retry with decorrelated jitter.  ``clock``, ``sleep`` and
    ``rng`` are injectable, so the timing is testable with a fake clock.
    ``attempt_timeout_s`` is carried for clients that take a timeout; the
    local filesystem takes none."""

    max_attempts: int = 5
    base_delay_s: float = 0.05
    max_delay_s: float = 5.0
    attempt_timeout_s: float | None = 60.0
    deadline_s: float | None = 120.0
    retryable: Callable[[BaseException], bool] = field(default=is_retryable)
    clock: Callable[[], float] = field(default=time.monotonic)
    sleep: Callable[[float], None] = field(default=time.sleep)
    rng: random.Random = field(default_factory=random.Random)

    def call(self, fn: Callable[..., Any], *args: Any, op: str = "io",
             **kwargs: Any) -> Any:
        """Run ``fn(*args, **kwargs)`` under this policy; re-raises the
        last error when attempts or the deadline run out, at once for an
        error that is not retryable."""
        start = self.clock()
        delay = self.base_delay_s
        attempt = 0
        while True:
            attempt += 1
            try:
                out = fn(*args, **kwargs)
                if attempt > 1:
                    _record(op, "recovered", "recovered", attempt)
                return out
            except Exception as e:  # noqa: BLE001 — classified right below
                if not self.retryable(e):
                    raise
                if attempt >= self.max_attempts:
                    _record(op, "exhausted", "exhausted", attempt)
                    raise
                delay = min(self.max_delay_s,
                            self.rng.uniform(self.base_delay_s,
                                             max(self.base_delay_s,
                                                 delay * 3.0)))
                if self.deadline_s is not None:
                    remaining = self.deadline_s - (self.clock() - start)
                    if remaining <= 0.0:
                        _record(op, "exhausted", "exhausted", attempt)
                        raise
                    delay = min(delay, remaining)
                _record(op, "retries", "retrying", attempt)
                print(f"[resilience] {op} failed "
                      f"(attempt {attempt}/{self.max_attempts}): "
                      f"{type(e).__name__}: {e} — retrying in {delay:.2f}s",
                      file=sys.stderr, flush=True)
                self.sleep(delay)

    def wrap(self, fn: Callable[..., Any], *, op: str | None = None
             ) -> Callable[..., Any]:
        """``fn`` bound to this policy (``op`` defaults to its name)."""
        name = op or getattr(fn, "__name__", "io")

        @functools.wraps(fn)
        def wrapped(*args: Any, **kwargs: Any) -> Any:
            return self.call(fn, *args, op=name, **kwargs)

        return wrapped


def retrying(policy: RetryPolicy, *, op: str | None = None):
    """Decorator form: ``@retrying(policy, op="gcs_read")``."""

    def deco(fn: Callable[..., Any]) -> Callable[..., Any]:
        return policy.wrap(fn, op=op)

    return deco
