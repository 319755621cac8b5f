"""Structured fault injection (counterpart of
``tpuframe/resilience/faults.py``, the same grammar and registry): every
recovery path of the port deterministically testable on the CPU.

Spec grammar (``TPUFRAME_FAULTS``, comma-separated entries)::

    TPUFRAME_FAULTS="gcs_read:step=13:kind=ioerror,ckpt_shard:kind=corrupt,
                     host:step=20:kind=sigterm"

    <seam>[:step=N][:kind=K][:times=T][:rank=R][:k=K][:once=1][:delay_s=X]

Seams, and where the port fires them:

  =======================  ==============================================
  seam                     where it fires
  =======================  ==============================================
  gcs_read                 ``data/gcs.py`` read_bytes
  gcs_write                ``data/gcs.py`` write_bytes, rename_tree
  gcs_list                 ``data/gcs.py`` listdir
  gcs_stat                 ``data/gcs.py`` exists, mtime
  gcs_delete               ``data/gcs.py`` delete, delete_tree
  ckpt_shard               the checkpoint's shard serialisation
                           (``mangle`` on the bytes written: kinds
                           ``corrupt``/``torn``; the CRC covers the clean
                           bytes)
  host                     the training loop, once per step
  slow_gcs                 ``data/gcs.py`` write_bytes, before the retry
                           wrapper (default kind ``slow``)
  crash_during_upload      the async checkpoint worker, after the shard
                           files and before the CRC sidecar (default kind
                           ``crash``)
  sigterm_pending_upload   right after an async save is enqueued (default
                           kind ``sigterm``: drives the flush before rc 14)
  replica_crash,           the serving replica's loop and weight swap:
  replica_hang,            they parse here and fire nowhere until the
  replica_slow,            serving fleet is ported (ROADMAP.md queue 1,
  slow_canary,             item 13)
  crash_during_swap
  =======================  ==============================================

Kinds: ``ioerror`` (raise a retryable :class:`InjectedFault`), ``slow``
(sleep ``delay_s``), ``corrupt`` (flip bytes), ``torn`` (truncate),
``crash`` (``os._exit(42)``, no cleanup), ``sigterm``/``sigint`` (deliver
the real signal to this process), ``hang`` (sleep forever),
``partial_sigterm`` (SIGTERM only on ranks below ``k``).

Matching: ``step=N`` gates on the training step (the trainer calls
:func:`set_step`); ``times=T`` caps firings (default 1); ``rank=R``
restricts to one rank of the ``torch.distributed`` world; ``once=1`` drops
the fault on a resumed run, so that a relaunch survives the step that
killed it.  The old ``TPUFRAME_FAULT_STEP``/``TPUFRAME_FAULT_ONCE``
aliases are refused loudly: a fault the operator believes armed that never
fires would turn every resilience proof into a false pass.
"""

from __future__ import annotations

import os
import signal
import time
from dataclasses import dataclass

from tpuframe_torch.obs import events
from tpuframe_torch.parallel import collectives

_KINDS = ("ioerror", "slow", "corrupt", "torn", "crash", "sigterm",
          "sigint", "hang", "partial_sigterm")
_SEAMS = ("gcs_read", "gcs_write", "gcs_list", "gcs_stat", "gcs_delete",
          "ckpt_shard", "host", "slow_gcs", "crash_during_upload",
          "sigterm_pending_upload", "replica_crash", "replica_hang",
          "replica_slow", "slow_canary", "crash_during_swap")
# Seams whose name is their failure mode default to that kind.
_SEAM_DEFAULT_KIND = {"slow_gcs": "slow", "crash_during_upload": "crash",
                      "sigterm_pending_upload": "sigterm",
                      "replica_crash": "crash", "replica_hang": "hang",
                      "replica_slow": "slow", "slow_canary": "slow",
                      "crash_during_swap": "crash"}
_CRASH_RC = 42


class InjectedFault(IOError):
    """Raised by ``kind=ioerror``: an OSError, so the retry policy treats
    it as transient (that is the point)."""


@dataclass
class Fault:
    seam: str
    kind: str = "ioerror"
    step: int | None = None
    times: int = 1
    rank: int | None = None
    once: bool = False
    delay_s: float = 1.0
    # partial_sigterm only: the ranks below k take the signal
    k: int = 1


def parse(spec: str) -> list[Fault]:
    """Parse a ``TPUFRAME_FAULTS`` value; raises ValueError on an unknown
    seam, kind or key."""
    faults: list[Fault] = []
    for entry in spec.split(","):
        entry = entry.strip()
        if not entry:
            continue
        seam, *opts = entry.split(":")
        if seam not in _SEAMS:
            raise ValueError(f"unknown fault seam {seam!r} in {entry!r}; "
                             f"have {_SEAMS}")
        f = Fault(seam=seam, kind=_SEAM_DEFAULT_KIND.get(seam, "ioerror"))
        for opt in opts:
            key, sep, val = opt.partition("=")
            if not sep:
                raise ValueError(f"fault option {opt!r} needs key=value "
                                 f"(in {entry!r})")
            if key == "kind":
                if val not in _KINDS:
                    raise ValueError(f"unknown fault kind {val!r} in "
                                     f"{entry!r}; have {_KINDS}")
                f.kind = val
            elif key == "step":
                f.step = int(val)
            elif key == "times":
                f.times = int(val)
            elif key == "rank":
                f.rank = int(val)
            elif key == "k":
                f.k = int(val)
                if f.k < 1:
                    raise ValueError(f"fault option k must be >= 1 "
                                     f"(in {entry!r})")
            elif key == "once":
                f.once = val not in ("0", "false", "")
            elif key == "delay_s":
                f.delay_s = float(val)
            else:
                raise ValueError(f"unknown fault option {key!r} in "
                                 f"{entry!r}")
        faults.append(f)
    return faults


def _rank() -> int:
    return collectives.world()[1]


class FaultRegistry:
    def __init__(self, faults: list[Fault] | None = None):
        self.faults = list(faults or [])
        self.step = 0

    def set_step(self, step: int) -> None:
        self.step = step

    def set_resumed(self, resumed: bool) -> None:
        """Drop ``once`` faults on a resumed run (start step > 0)."""
        if resumed:
            self.faults = [f for f in self.faults if not f.once]

    def _take(self, seam: str, kinds: tuple[str, ...]) -> Fault | None:
        for f in self.faults:
            if (f.seam == seam and f.kind in kinds and f.times > 0
                    and (f.step is None or f.step == self.step)
                    and (f.rank is None or f.rank == _rank())):
                f.times -= 1
                # before the fault acts, so that a crash or hang leaves
                # its record
                events.emit("fault_injected", seam=f.seam, kind=f.kind,
                            step=self.step)
                return f
        return None

    def fire(self, seam: str) -> None:
        """Run the control-flow fault armed at ``seam``, if any (the data
        kinds go through :meth:`mangle`)."""
        f = self._take(seam, ("ioerror", "slow", "crash", "sigterm",
                              "sigint", "hang", "partial_sigterm"))
        if f is None:
            return
        if f.kind == "ioerror":
            raise InjectedFault(f"injected ioerror at seam {seam} "
                                f"(step {self.step})")
        if f.kind == "slow":
            print(f"[tpuframe] FAULT INJECTION: slow {seam} "
                  f"({f.delay_s:.1f}s) at step {self.step}", flush=True)
            time.sleep(f.delay_s)
        elif f.kind == "crash":
            print(f"[tpuframe] FAULT INJECTION: dying at step {self.step}",
                  flush=True)
            os._exit(_CRASH_RC)
        elif f.kind == "partial_sigterm":
            if _rank() < f.k:
                print(f"[tpuframe] FAULT INJECTION: raising SIGTERM on "
                      f"host {_rank()} (partial, k={f.k}) at step "
                      f"{self.step}", flush=True)
                os.kill(os.getpid(), signal.SIGTERM)
            else:
                print(f"[tpuframe] FAULT INJECTION: partial_sigterm "
                      f"spared host {_rank()} (k={f.k}) at step "
                      f"{self.step}", flush=True)
        elif f.kind in ("sigterm", "sigint"):
            sig = signal.SIGTERM if f.kind == "sigterm" else signal.SIGINT
            print(f"[tpuframe] FAULT INJECTION: raising {f.kind.upper()} "
                  f"at step {self.step}", flush=True)
            os.kill(os.getpid(), sig)
        elif f.kind == "hang":
            print(f"[tpuframe] FAULT INJECTION: hanging at step "
                  f"{self.step}", flush=True)
            time.sleep(10 ** 6)

    def mangle(self, seam: str, data: bytes) -> bytes:
        """``data`` corrupted or truncated when a data fault is armed at
        ``seam``, else unchanged (storage-side corruption: the writer's
        CRC covers the clean bytes, so a restore sees a mismatch)."""
        f = self._take(seam, ("corrupt", "torn"))
        if f is None:
            return data
        print(f"[tpuframe] FAULT INJECTION: {f.kind} bytes at seam {seam} "
              f"(step {self.step})", flush=True)
        if f.kind == "torn":
            return data[: max(1, len(data) // 2)]
        mangled = bytearray(data)
        for i in (0, len(mangled) // 2, len(mangled) - 1):
            mangled[i] ^= 0xFF
        return bytes(mangled)


# The registry the seams consult, built from the environment at first use.
_registry: FaultRegistry | None = None


def reset_from_env(env=os.environ) -> FaultRegistry:
    """(Re)build the registry from ``TPUFRAME_FAULTS``; the removed
    ``TPUFRAME_FAULT_STEP``/``TPUFRAME_FAULT_ONCE`` raise."""
    global _registry
    for var in ("TPUFRAME_FAULT_STEP", "TPUFRAME_FAULT_ONCE"):
        if env.get(var, "").strip():
            step = env.get("TPUFRAME_FAULT_STEP", "N").strip() or "N"
            once = ":once=1" if env.get("TPUFRAME_FAULT_ONCE") else ""
            raise RuntimeError(
                f"{var} was removed — spell the fault as "
                f"TPUFRAME_FAULTS='host:step={step}:kind=crash{once}' "
                f"(see tpuframe_torch.resilience.faults for the grammar)")
    _registry = FaultRegistry(parse(env.get("TPUFRAME_FAULTS", "")))
    return _registry


def registry() -> FaultRegistry:
    if _registry is None:
        return reset_from_env()
    return _registry


def fire(seam: str) -> None:
    registry().fire(seam)


def mangle(seam: str, data: bytes) -> bytes:
    return registry().mangle(seam, data)


def set_step(step: int) -> None:
    registry().set_step(step)


def set_resumed(resumed: bool) -> None:
    registry().set_resumed(resumed)
