"""Heartbeat / stall detection (counterpart of ``tpuframe/obs/heartbeat.py``):
Horovod's ``HOROVOD_STALL_CHECK`` for the port's training loop.

A watchdog thread watches a step counter the loop bumps, and logs (or
calls back) when no step completes within the window: the per-process
symptom of an input-pipeline stall, hung I/O or a dead peer whose
collective never returns.  The thread needs the GIL to notice: a gloo or
NCCL wait releases it, and the trainer's callback ends the process with
``os._exit`` while the main thread is still blocked.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable

from tpuframe_torch.obs import events

logger = logging.getLogger(__name__)


class Heartbeat:
    def __init__(self, *, timeout_s: float = 120.0, poll_s: float = 5.0,
                 on_stall: Callable[[float], None] | None = None,
                 arm_after_first_beat: bool = False):
        self.timeout_s = timeout_s
        self.poll_s = poll_s
        self.on_stall = on_stall
        # When True, the watchdog arms only once a first step has completed:
        # the first step builds the kernels and tunes cuDNN, which is
        # legitimate and unbounded (the trainer uses this mode).
        self.arm_after_first_beat = arm_after_first_beat
        self._beats = 0
        self._last_beat = time.monotonic()
        # seconds between the last two beats: how much earlier a peer that
        # never beat this rank's last step reaches its own deadline
        self.last_interval_s = 0.0
        self._step = 0
        self._stalled = False
        self.stall_count = 0
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def beat(self, step: int) -> None:
        """Call once per completed training step.  A beat after a stall
        re-arms the watchdog: a recovered run that stalls again reports a
        *second* stall instead of staying latched on the first one."""
        now = time.monotonic()
        if self._beats:
            self.last_interval_s = now - self._last_beat
        self._step = step
        self._beats += 1
        self._last_beat = now
        self._stalled = False

    @property
    def stalled(self) -> bool:
        return self._stalled

    def start(self) -> "Heartbeat":
        self._thread = threading.Thread(target=self._watch, daemon=True,
                                        name="tpuframe-heartbeat")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2 * self.poll_s)

    def check(self, *, slack_s: float = 0.0) -> bool:
        """One poll of the watchdog, run now, with the deadline brought
        ``slack_s`` earlier; True when it reported a stall.  The thread
        runs it every ``poll_s``; the trainer runs it once more when its
        loop fails (see ``tpuframe_torch.train._train``)."""
        if self.arm_after_first_beat and self._beats == 0:
            return False
        with self._lock:
            idle = time.monotonic() - self._last_beat
            if idle <= self.timeout_s - slack_s or self._stalled:
                return False
            # read with the decision: a beat landing before the event is
            # written must not relabel this stall with its step
            step, count = self._step, self.stall_count + 1
            self._stalled = True
            self.stall_count = count
        logger.warning(
            "no training step completed in %.0fs (last step %d) — "
            "input pipeline stall, hung I/O, or peer failure", idle, step)
        events.emit("stall", last_step=step, idle_s=round(idle, 3),
                    stall_count=count)
        if self.on_stall:
            try:
                self.on_stall(idle)
            except Exception:  # noqa: BLE001 — a broken callback must not
                # kill the watchdog thread; keep watching
                logger.exception("on_stall callback raised")
        return True

    def _watch(self) -> None:
        while not self._stop.wait(self.poll_s):
            self.check()
