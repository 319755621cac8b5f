"""The preemption contract (counterpart of
``tpuframe/resilience/preempt.py``).

A preemptible host gets SIGTERM with a short grace window before it
disappears.  The contract:

  1. :class:`PreemptionGuard` turns SIGTERM/SIGINT into a *flag*, never
     an exception: a signal in the middle of a step or a collective must
     not unwind it.
  2. The training loop checks the flag at each step boundary, commits a
     final checkpoint and exits with :data:`RC_PREEMPTED` (14).
  3. A supervisor treats rc 14 as "resume me".

A second signal escalates past the flag: ^C ^C raises KeyboardInterrupt,
and a second SIGTERM is re-delivered with the guard uninstalled, so that
a supervisor's kill after the grace window kills a wedged run.
"""

from __future__ import annotations

import signal
import sys
import threading

from tpuframe_torch.obs import events

RC_PREEMPTED = 14


class PreemptionGuard:
    """Flag-setting SIGTERM/SIGINT handler with install/uninstall.

    Signal handlers work only in the main thread; ``install()`` in any
    other thread is a visible no-op (``active`` stays False)."""

    def __init__(self, signals: tuple[int, ...] = (signal.SIGTERM,
                                                   signal.SIGINT)):
        self.signals = signals
        self.active = False
        self._requested = False
        self.signal_name: str | None = None
        self._saved: dict[int, object] = {}

    @property
    def requested(self) -> bool:
        return self._requested

    def _handle(self, signum, frame) -> None:
        if self._requested and signum in (signal.SIGINT, signal.SIGTERM):
            # the second signal: stop shielding
            self.uninstall()
            if signum == signal.SIGINT:
                raise KeyboardInterrupt
            signal.raise_signal(signum)
            return
        self._requested = True
        self.signal_name = signal.Signals(signum).name
        events.emit("preempt", signal=self.signal_name)
        print(f"[tpuframe] received {self.signal_name} — will checkpoint "
              f"at the next step boundary and exit rc {RC_PREEMPTED} "
              f"(supervisor resumes)", file=sys.stderr, flush=True)

    def install(self) -> "PreemptionGuard":
        if threading.current_thread() is not threading.main_thread():
            return self
        for sig in self.signals:
            self._saved[sig] = signal.getsignal(sig)
            signal.signal(sig, self._handle)
        self.active = True
        return self

    def reassert(self) -> None:
        """Take the signals back after something else replaced the
        handler (a distributed runtime initialised after :meth:`install`
        may install its own); ``uninstall()`` still restores the handlers
        from before the guard."""
        if not self.active:
            return
        for sig in self.signals:
            if signal.getsignal(sig) is not self._handle:
                signal.signal(sig, self._handle)

    def uninstall(self) -> None:
        for sig, old in self._saved.items():
            try:
                signal.signal(sig, old)
            except (ValueError, TypeError):  # not the main thread
                pass
        self._saved.clear()
        self.active = False

    def __enter__(self) -> "PreemptionGuard":
        return self.install()

    def __exit__(self, *exc) -> None:
        self.uninstall()
