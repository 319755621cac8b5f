"""Structured run-event log (counterpart of ``tpuframe/obs/events.py``):
one thread-safe JSONL file per process, ``events.<host>.jsonl``, in the JAX
package's schema, so its offline tools read a port run's files unchanged.

Record envelope (every line)::

    {"schema": 2, "type": "<event type>", "t": <unix seconds>,
     "host": "<hostname>-p<rank>", "proc": <rank>, "attempt": <int>,
     ...type-specific fields}

``<rank>`` is :func:`tpuframe_torch.parallel.bootstrap.process_index`:
the group rank, else ``TPUFRAME_PROCESS_ID``, so each replica and the
router of a serving fleet (processes with no group) write files of their
own.

The port emits ``ckpt_save``, ``ckpt_restore``, ``fault_injected``,
``retry`` and ``preempt`` (checkpointing, fault injection, the retry
policy and the preemption guard), ``stall`` (the watchdog), the serving
``serve_*``, ``router_*`` and span events (``serve/``,
``obs/tracing.py``).  The trainer's ``run_start``, ``step`` and
``run_end`` need the goodput meter and wait for ROADMAP.md queue 1, item
11; until then the trainer refuses ``TPUFRAME_EVENTS_DIR``, and a caller
that wants the events opens the log with :func:`init` (a fleet replica
does, from ``TPUFRAME_EVENTS_DIR``).  Every ``emit`` is a no-op while no
log is open, and never raises.
"""

from __future__ import annotations

import json
import os
import re
import socket
import threading
import time

from tpuframe_torch.parallel import bootstrap

SCHEMA_VERSION = 2
ACCEPTED_SCHEMAS = (1, 2)

ENV_DIR = "TPUFRAME_EVENTS_DIR"
ENV_ATTEMPT = "TPUFRAME_ATTEMPT"

# Per-type required fields beyond the envelope: the JAX package's contract,
# every type of it, so that a file of either package validates in both.
REQUIRED_FIELDS: dict[str, tuple[str, ...]] = {
    "run_start": ("config", "config_hash", "jax_version"),
    "step": ("step", "wall_ms"),
    "compile": (),
    "ckpt_save": ("step",),
    "ckpt_restore": ("step",),
    "retry": ("op",),
    "fault_injected": ("seam", "kind"),
    "stall": ("last_step", "idle_s"),
    "preempt": ("signal",),
    "devmem": ("devices",),
    "remat_policy": ("policy", "source"),
    "weight_update": ("mode", "source"),
    "wire_format": ("format", "source"),
    "fusion_threshold": ("threshold", "source"),
    "pspec": ("spec", "source"),
    "elastic_resize": ("n_from", "n_to", "policy"),
    "run_end": ("final_step", "wall_s", "goodput"),
    "trace_start": ("step", "path"),
    "trace_end": ("step", "path"),
    "serve_step": ("step", "wall_ms", "active"),
    "serve_request": ("id", "prompt_tokens", "output_tokens", "ttft_ms"),
    "serve_summary": ("requests", "tokens_per_s"),
    "router_admit": ("id",),
    "router_shed": ("id", "queued"),
    "router_dispatch": ("id", "replica"),
    "router_hedge": ("id", "replica"),
    "router_redispatch": ("id", "replica"),
    "router_drain": ("replica", "reason"),
    "router_request": ("id", "replica", "ttft_ms"),
    "router_summary": ("requests", "shed"),
    "rollout_step": ("replica", "version", "phase"),
    "rollout_done": ("version", "replicas"),
    "rollout_abort": ("version", "metric", "reason"),
    "span_open": ("trace", "span", "name"),
    "span_close": ("trace", "span", "ms"),
    "span_note": ("trace", "note"),
}

_ENVELOPE = ("schema", "type", "t", "host", "proc", "attempt")

_FILE_RE = re.compile(r"^events\.(?P<host>.+)\.jsonl$")


def _hostname() -> str:
    try:
        return socket.gethostname().split(".")[0] or "host"
    except OSError:
        return "host"


def attempt_id() -> int:
    """The supervisor's relaunch counter (0 on a first launch)."""
    try:
        return int(os.environ.get(ENV_ATTEMPT, "0") or "0")
    except ValueError:
        return 0


class EventLog:
    """Thread-safe JSONL event writer, one file per (host, rank), opened
    for appending so that a relaunched attempt extends the same file."""

    def __init__(self, directory: str, *, host: str | None = None,
                 proc: int | None = None):
        self.proc = bootstrap.process_index() if proc is None else proc
        self.host = host or f"{_hostname()}-p{self.proc}"
        os.makedirs(directory, exist_ok=True)
        self.path = os.path.join(directory, f"events.{self.host}.jsonl")
        self._lock = threading.Lock()
        self._fh = open(self.path, "a", buffering=1)
        self._closed = False

    def emit(self, etype: str, **fields) -> dict | None:
        """Append one record and return it (None once closed).  Never
        raises: observability must not take down the run."""
        record = {
            "schema": SCHEMA_VERSION,
            "type": etype,
            "t": round(time.time(), 3),
            "host": self.host,
            "proc": self.proc,
            "attempt": attempt_id(),
            **fields,
        }
        try:
            line = json.dumps(record, default=str)
        except (TypeError, ValueError):
            return None
        with self._lock:
            if self._closed:
                return None
            try:
                self._fh.write(line + "\n")
            except (OSError, ValueError):
                return None
        return record

    def close(self) -> None:
        with self._lock:
            if not self._closed:
                self._closed = True
                try:
                    self._fh.close()
                except OSError:
                    pass


# The process-wide log every seam writes through.
_log: EventLog | None = None
_log_lock = threading.Lock()


def init(directory: str | None = None) -> EventLog | None:
    """(Re)open the process-wide log in ``directory`` (default:
    ``TPUFRAME_EVENTS_DIR``); unset or empty leaves events off."""
    global _log
    directory = directory or os.environ.get(ENV_DIR, "")
    if not directory.strip():
        return None
    with _log_lock:
        if _log is not None:
            _log.close()
        _log = EventLog(directory)
        return _log


def get() -> EventLog | None:
    return _log


def enabled() -> bool:
    return _log is not None


def emit(etype: str, **fields) -> dict | None:
    """Write through the process-wide log; a no-op while none is open."""
    log = _log
    if log is None:
        return None
    return log.emit(etype, **fields)


def close() -> None:
    global _log
    with _log_lock:
        if _log is not None:
            _log.close()
            _log = None


def validate_record(rec: dict) -> list[str]:
    """Problems with one parsed record; empty means valid."""
    if not isinstance(rec, dict):
        return [f"record is not an object: {rec!r:.80}"]
    problems = [f"missing envelope key {key!r}" for key in _ENVELOPE
                if key not in rec]
    if rec.get("schema") not in ACCEPTED_SCHEMAS:
        problems.append(f"unknown schema version {rec.get('schema')!r} "
                        f"(this reader knows {ACCEPTED_SCHEMAS})")
    etype = rec.get("type")
    if etype in REQUIRED_FIELDS:
        problems += [f"{etype} record missing field {key!r}"
                     for key in REQUIRED_FIELDS[etype] if key not in rec]
    elif etype is not None:
        problems.append(f"unknown event type {etype!r}")
    return problems


def read_file(path: str, *, strict: bool = False) -> list[dict]:
    """Parse one events file.  A torn last line is expected after a crash
    and skipped unless ``strict``."""
    out: list[dict] = []
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                out.append(json.loads(line))
            except json.JSONDecodeError:
                if strict:
                    raise ValueError(f"{path}:{lineno}: unparseable event "
                                     f"line {line!r:.80}")
    return out


def event_files(directory: str) -> list[str]:
    """The ``events.<host>.jsonl`` files under ``directory``, sorted."""
    try:
        names = sorted(os.listdir(directory))
    except (FileNotFoundError, NotADirectoryError):
        if _FILE_RE.match(os.path.basename(directory)):
            return [directory]
        return []
    return [os.path.join(directory, n) for n in names if _FILE_RE.match(n)]


def merge(directory: str) -> list[dict]:
    """Every host's events in one stream, ordered by time (ties by host,
    then by their order in the file)."""
    records: list[dict] = []
    for path in event_files(directory):
        records.extend(read_file(path))
    return sorted(records,
                  key=lambda r: (r.get("t", 0.0), str(r.get("host", ""))))
