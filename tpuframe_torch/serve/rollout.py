"""Live weight rollout (counterpart of ``tpuframe/serve/rollout.py``):
rolling updates that lose no request, a canary gate, and rollback.

A committed checkpoint reaches every replica of a fleet without a restart
and without losing an admitted request: the controller drives the router
(``serve/router.py``) and each replica's ``/swap_weights``
(``serve/replica.py``, which applies ``LMEngine.swap_params`` between
scheduler steps).

The state machine::

    idle --watch sees a committed step--> canary: drain -> swap ->
    readmit (+ a seeded share of the traffic) --> bake: old-vs-new
    TTFT/TPOT, past the canary's first wave, through ``obs compare``'s
    thresholds --rc 0--> roll the
    rest, one replica at a time (drain -> swap -> readmit) --> done
                                          `--rc 1 (or a starved gate)-->
    abort: drain the canary, swap the OLD version back (the replica
    restores the weights it served under it), readmit --> aborted

Invariants:

  zero loss      every phase rides the router's drain and redispatch
                 contract: a draining replica finishes the work it
                 accepted while the router places the rest elsewhere, so
                 every admitted rid retires through a roll.
  bounded mix    at most one replica is in transition at a time; the
                 mixed-version window (first replica on the new version
                 to the last) is ``window_s``, and ``goodput.fleet_stats``
                 recomputes it from the ``rollout_step`` events.
  in place       the JAX swap costs no compile-cache miss; an eager
                 PyTorch replica compiles nothing, answers 0 misses, and
                 copies the weights into the served tensors
                 (``engine.swap_parity_check`` holds that).
  honest gate    promotion needs both sides of the comparison: a gate
                 metric takes part only when both sides carry it, and a
                 bake that never collects enough canary samples rolls
                 back rather than promote blind.

The watch is ``ckpt.checkpoint.committed_world()``, a read-only peek: a
directory mid-commit (no COMMIT), a quarantined ``step_N.corrupt`` or a
torn manifest is invisible, so a partial upload never starts a roll.

Env knobs: ``TPUFRAME_ROLLOUT_WATCH`` (checkpoint directory to poll),
``TPUFRAME_CANARY_FRAC`` (seeded share of traffic to the canary, default
0.25; 0 disables the canary), ``TPUFRAME_ROLLOUT_GATE`` (TTFT/TPOT p90
regression threshold in %, default 25; 0 disables the gate).

No torch import: the controller drives a fleet over HTTP and stays as
light as the router; the checkpoint peek is imported at the first poll.
"""

from __future__ import annotations

import os
import time

from tpuframe_torch.obs import events as obs_events
from tpuframe_torch.obs import tracing
from tpuframe_torch.resilience.policy import RetryPolicy
from tpuframe_torch.serve.router import Router, parse_gauges

ENV_WATCH = "TPUFRAME_ROLLOUT_WATCH"
ENV_CANARY_FRAC = "TPUFRAME_CANARY_FRAC"
ENV_GATE = "TPUFRAME_ROLLOUT_GATE"

DEFAULT_CANARY_FRAC = 0.25
DEFAULT_GATE_PCT = 25.0

ROLLOUT_EVENT_TYPES = ("rollout_step", "rollout_done", "rollout_abort")

# The promotion gate's metric universe: end-to-end TTFT at the router
# plus replica-reported TTFT/TPOT.  Everything else compare_runs knows
# (step times, MFU) is training-side and never participates here.
GATE_METRICS = ("router_ttft_p90_ms", "serve_ttft_p90_ms",
                "serve_tpot_p90_ms")

_SCRAPE_GAUGES = ("tpuframe_serve_queue_depth",
                  "tpuframe_serve_active_slots",
                  "tpuframe_weights_version")


def resolve_watch_dir() -> str | None:
    raw = os.environ.get(ENV_WATCH, "").strip()
    return raw or None


def resolve_canary_frac() -> float:
    raw = os.environ.get(ENV_CANARY_FRAC, "").strip()
    if not raw:
        return DEFAULT_CANARY_FRAC
    try:
        return min(1.0, max(0.0, float(raw)))
    except ValueError:
        return DEFAULT_CANARY_FRAC


def resolve_gate_pct() -> float:
    raw = os.environ.get(ENV_GATE, "").strip()
    if not raw:
        return DEFAULT_GATE_PCT
    try:
        return max(0.0, float(raw))
    except ValueError:
        return DEFAULT_GATE_PCT


def gate_compare(baseline_events: list, canary_events: list, *,
                 pct: float) -> tuple[int, dict]:
    """The promotion gate: diff canary traffic against old-version
    traffic with ``goodput.compare_runs`` and return the ``obs
    compare`` rc contract restricted to the gate metrics — 0 promote,
    1 regression (roll back), 2 no overlapping gate metric (keep
    baking; NEVER promote on 2).  A metric participates only when both
    sides carry it, like every other compare metric."""
    from tpuframe_torch.obs import goodput

    res = goodput.compare_runs(baseline_events, canary_events,
                               thresholds={"serve_pct": pct})
    present = [m for m in GATE_METRICS if m in res["metrics"]]
    if not present:
        return 2, res
    if any(r["metric"] in GATE_METRICS for r in res["regressions"]):
        return 1, res
    return 0, res


class RolloutController:
    """Drives one rolling weight update across a :class:`Router`'s fleet.

    Cooperative, not threaded: ``tick()`` is called once per router
    loop iteration (``Router.run(on_tick=...)``) and advances a
    non-blocking state machine, so request traffic keeps flowing — and
    keeps being measured — all the way through the roll.  The only
    blocking call is the swap POST itself, bounded by its RetryPolicy.

    A replica applies a swap only once it holds no request, so the POST
    waits for whatever the drain left in its hands: ``swap_timeout_s``
    must cover one wave of its requests (a retried POST joins the swap
    already queued, it does not queue a second).

    The bake's gate skips the canary's first wave: of the canary's
    answers it counts only those to requests the router handed it at or
    after its first answer.  The canary is readmitted into the backlog
    that built up while it was out and takes a full wave of it at once;
    that burst's TTFT is the readmission's, not the new weights'.  The
    old side counts every answer after the readmission, as the JAX
    controller counts both.
    """

    def __init__(self, router: Router, *, transport=None,
                 clock=time.monotonic, watch_dir: str | None = None,
                 watch_interval_s: float = 0.25,
                 current_version: int = 0,
                 canary_frac: float | None = None,
                 gate_pct: float | None = None,
                 bake_min_samples: int = 5, bake_timeout_s: float = 20.0,
                 drain_timeout_s: float = 15.0,
                 swap_timeout_s: float = 10.0,
                 relaunch_timeout_s: float = 30.0,
                 poll_interval_s: float = 0.05,
                 swap_seed: int | None = None, seed: int = 0, log=None):
        self.router = router
        self._transport = transport or router._transport
        self._clock = clock
        self.watch_dir = (resolve_watch_dir() if watch_dir is None
                          else watch_dir)
        self.watch_interval_s = watch_interval_s
        self.current_version = int(current_version)
        self.canary_frac = (resolve_canary_frac() if canary_frac is None
                            else min(1.0, max(0.0, float(canary_frac))))
        self.gate_pct = (resolve_gate_pct() if gate_pct is None
                         else max(0.0, float(gate_pct)))
        self.bake_min_samples = max(1, int(bake_min_samples))
        self.bake_timeout_s = bake_timeout_s
        self.drain_timeout_s = drain_timeout_s
        self.swap_timeout_s = swap_timeout_s
        self.relaunch_timeout_s = relaunch_timeout_s
        self.poll_interval_s = poll_interval_s
        # ``seed`` seeds the router's canary traffic split; ``swap_seed``
        # (real-engine fleets) tells the replica which weights to
        # regenerate — None means a metadata-only swap (FakeEngine).
        self.seed = seed
        self.swap_seed = swap_seed
        self._log = log or (lambda *_a: None)
        self._swap_policy = RetryPolicy(
            max_attempts=2, base_delay_s=0.02, max_delay_s=0.25,
            attempt_timeout_s=swap_timeout_s,
            deadline_s=2.0 * swap_timeout_s)

        self.state = "idle"        # idle|rolling|bake|done|aborted
        self.target: int | None = None
        self.world: dict | None = None      # committed_world() peek
        self.history: list = []    # (t, replica, phase)
        self.gate_result: dict | None = None
        self.abort_metric: str | None = None
        self.abort_reason: str | None = None
        self.swap_compile_misses = 0
        self.relaunches = 0
        self.swap_ms: list = []    # (replica, ms of the /swap_weights call)
        self.bake_samples: dict | None = None   # {"old": n, "canary": n}
        self.window_s: float | None = None
        self._plan: list[str] = []
        self._cursor = 0
        self._phase: str | None = None
        self._phase_t = 0.0
        self._last_poll_t = -1e18
        self._last_watch_t = -1e18
        self._rollback = False
        self._swap_to: int | None = None
        self._first_swap_t: float | None = None
        self._last_swap_t: float | None = None
        self._bake_start_idx = 0
        self._bake_start_t = 0.0
        self._canary_name: str | None = None
        # Fleet-operation trace (always sampled — one per roll, never
        # volume): a "rollout" root span open for the whole roll, with
        # every per-replica phase as a note under it, so a request
        # waterfall and the swap that delayed it land in one event
        # stream with the same vocabulary.
        self.trace: str | None = None
        self._root_span: str | None = None
        self._trace_t0 = 0.0

    # -- observability ------------------------------------------------------

    def _emit(self, replica: str, phase: str, version: int) -> None:
        self.history.append((self._clock(), replica, phase))
        obs_events.emit("rollout_step", replica=replica, version=version,
                        phase=phase)
        if self.trace is not None:
            tracing.note(self.trace, phase, span=self._root_span,
                         replica=replica, version=version)
        self._log(f"rollout: {replica} {phase} (v{version})")

    def _close_trace(self, status: str) -> None:
        if self.trace is not None and self._root_span is not None:
            tracing.close_span(
                self.trace, self._root_span,
                1e3 * max(0.0, self._clock() - self._trace_t0),
                status=status, version=self.target)
            self._root_span = None

    def summary(self) -> dict:
        return {
            "state": self.state,
            "version": self.current_version,
            "target": self.target,
            "window_s": self.window_s,
            "swap_compile_misses": self.swap_compile_misses,
            "relaunches": self.relaunches,
            "aborted": self.state == "aborted",
            "abort_metric": self.abort_metric,
            "abort_reason": self.abort_reason,
            "phases": [(rep, phase) for _t, rep, phase in self.history],
            "world": self.world,
            "swap_ms": list(self.swap_ms),
            "bake_samples": self.bake_samples,
        }

    # -- the watch seam -----------------------------------------------------

    def poll_watch(self, now: float) -> int | None:
        """Peek the checkpoint directory through ``committed_world()``:
        only a COMMITTED step with a readable manifest is visible — a
        dir mid-commit, a quarantined ``.corrupt`` or a torn sidecar
        yields None and never triggers a rollout."""
        if self.watch_dir is None:
            return None
        if now - self._last_watch_t < self.watch_interval_s:
            return None
        self._last_watch_t = now
        from tpuframe_torch.ckpt.checkpoint import committed_world

        info = committed_world(self.watch_dir)
        if info is None:
            return None
        step = int(info["step"])
        if step <= self.current_version:
            return None
        self.world = info
        return step

    # -- control ------------------------------------------------------------

    def start(self, target_version: int) -> bool:
        """Begin a roll to ``target_version``.  One roll at a time; the
        canary (when enabled) is the FIRST replica in the plan."""
        if self.state not in ("idle", "done", "aborted"):
            return False
        names = [rep.name for rep in self.router.replicas]
        if not names:
            return False
        self.target = int(target_version)
        self._plan = names
        self._cursor = 0
        self._rollback = False
        self._swap_to = self.target
        self._canary_name = (names[0] if self.canary_frac > 0
                             and len(names) > 1 else None)
        self.trace = tracing.mint(f"rollout-v{self.target}", force=True)
        self._trace_t0 = self._clock()
        self._root_span = tracing.open_span(
            self.trace, "rollout", version=self.target,
            replicas=len(names))
        self.state = "rolling"
        self._enter_phase("drain")
        self._log(f"rollout: v{self.current_version} -> v{self.target} "
                  f"over {names} (canary={self._canary_name})")
        return True

    def done(self) -> bool:
        return self.state in ("done", "aborted")

    def tick(self, now: float | None = None) -> bool:
        """Advance the state machine one notch.  Returns True while the
        rollout still has work (the ``Router.run(on_tick=...)`` keep-
        running signal)."""
        now = self._clock() if now is None else now
        if self.state == "idle":
            target = self.poll_watch(now)
            if target is not None:
                self.start(target)
            return self.state == "rolling"
        if self.state == "rolling":
            self._tick_rolling(now)
        elif self.state == "bake":
            self._tick_bake(now)
        return not self.done()

    # -- the per-replica submachine -----------------------------------------

    def _enter_phase(self, phase: str) -> None:
        self._phase = phase
        self._phase_t = self._clock()
        self._last_poll_t = -1e18

    def _rep_name(self) -> str:
        return self._plan[self._cursor]

    def _probe(self, name: str) -> dict | None:
        """Best-effort one-shot /metrics scrape of one replica (the
        router stops scraping a draining replica; the controller must
        keep watching it through the swap)."""
        rep = self.router._replica(name)
        if rep is None:
            return None
        try:
            status, text = self._transport(rep.url + "/metrics", None,
                                           self.swap_timeout_s)
        except Exception:  # noqa: BLE001 — dead/restarting replica is a
            return None    # normal state here, the caller keeps polling
        if status != 200:
            return None
        return parse_gauges(text if isinstance(text, str) else "",
                            _SCRAPE_GAUGES)

    def _tick_rolling(self, now: float) -> None:
        name = self._rep_name()
        if self._phase == "drain":
            self.router.drain_replica(
                name, reason=f"rollout:v{self._swap_to}")
            if not self._rollback:
                self._emit(name, "drain", self._swap_to)
            self._enter_phase("wait_drain")
            return
        if self._phase == "wait_drain":
            if now - self._last_poll_t < self.poll_interval_s:
                return
            self._last_poll_t = now
            gauges = self._probe(name)
            idle = (gauges is not None
                    and gauges.get("tpuframe_serve_active_slots", 1) == 0
                    and gauges.get("tpuframe_serve_queue_depth", 1) == 0)
            if idle:
                self._enter_phase("swap")
            elif now - self._phase_t > self.drain_timeout_s:
                # Post the swap anyway, loud, not silent: the replica
                # applies it only once it holds no request, so the POST
                # waits for that work (``swap_timeout_s`` must cover it).
                self._log(f"rollout: {name} drain timed out after "
                          f"{self.drain_timeout_s}s; posting the swap")
                self._enter_phase("swap")
            return
        if self._phase == "swap":
            self._do_swap(name)
            return
        if self._phase == "wait_relaunch":
            if now - self._phase_t > self.relaunch_timeout_s:
                self._abort("swap", f"replica {name} did not come back "
                                    f"on v{self._swap_to} within "
                                    f"{self.relaunch_timeout_s}s")
                return
            if now - self._last_poll_t < self.poll_interval_s:
                return
            self._last_poll_t = now
            gauges = self._probe(name)
            if (gauges is not None
                    and int(gauges.get("tpuframe_weights_version", -1))
                    == self._swap_to):
                self.relaunches += 1
                self._note_on_target(name, "relaunched")
                self._readmit(name)
            return

    def _do_swap(self, name: str) -> None:
        rep = self.router._replica(name)
        payload = {"version": self._swap_to}
        # A rollback names only the version: the replica restores the
        # weights it served under it (``serve/replica.py``).
        if self.swap_seed is not None and not self._rollback:
            payload["seed"] = self.swap_seed
        t0 = self._clock()
        try:
            status, body = self._swap_policy.call(
                self._transport, rep.url + "/swap_weights", payload,
                self.swap_timeout_s, op="rollout_swap")
        except Exception as e:  # noqa: BLE001 — the replica died mid-
            # swap (crash_during_swap): wait for the supervisor to
            # relaunch it on the NEW version
            self._emit(name, "swap_failed", self._swap_to)
            self._log(f"rollout: swap on {name} failed "
                      f"({type(e).__name__}) — waiting for relaunch")
            self._enter_phase("wait_relaunch")
            return
        if status != 200 or not isinstance(body, dict):
            err = body.get("error") if isinstance(body, dict) else body
            self._abort("swap", f"replica {name} refused the swap "
                                f"({status}): {err}")
            return
        self.swap_ms.append((name, 1e3 * (self._clock() - t0)))
        self.swap_compile_misses += int(
            body.get("compile_cache_misses") or 0)
        if not self._rollback:
            self._note_on_target(name, "swapped")
        self._readmit(name)

    def _note_on_target(self, name: str, phase: str) -> None:
        t = self._clock()
        if self._first_swap_t is None:
            self._first_swap_t = t
        self._last_swap_t = t
        self._emit(name, phase, self._swap_to)

    def _readmit(self, name: str) -> None:
        self.router.readmit(name)
        if self._rollback:
            self._emit(name, "rolled_back", self._swap_to)
        else:
            self._emit(name, "readmitted", self._swap_to)
        self._advance()

    def _advance(self) -> None:
        """Next replica — or the bake (after the canary), the finish
        line, or the end of a rollback."""
        if self._rollback:
            self.state = "aborted"
            self.router.clear_canary()
            self._close_trace("aborted")
            return
        name = self._rep_name()
        self._cursor += 1
        if name == self._canary_name:
            # Canary is live: steer the seeded fraction at it and bake.
            self.router.set_canary(name, self.canary_frac,
                                   seed=self.seed)
            if self.gate_pct > 0:
                self.state = "bake"
                self._bake_start_idx = len(self.router.completed)
                self._bake_start_t = self._clock()
                return
            # Gate disabled: promote immediately (explicitly asked for).
            self._promote()
            return
        if self._cursor >= len(self._plan):
            self._finish()
            return
        self._enter_phase("drain")

    def _promote(self) -> None:
        self.router.clear_canary()
        self._emit(self._canary_name or self._plan[0], "promoted",
                   self.target)
        if self._cursor >= len(self._plan):
            self._finish()
            return
        self.state = "rolling"
        self._enter_phase("drain")

    def _finish(self) -> None:
        self.router.clear_canary()
        self.window_s = (round(self._last_swap_t - self._first_swap_t, 6)
                         if self._first_swap_t is not None else 0.0)
        self.current_version = self.target
        self.state = "done"
        obs_events.emit("rollout_done", version=self.target,
                        replicas=len(self._plan),
                        window_s=self.window_s)
        self._close_trace("done")
        self._log(f"rollout: done — fleet on v{self.target}, "
                  f"mixed-version window {self.window_s}s")

    # -- the canary gate ----------------------------------------------------

    def _gate_events(self, reqs: list) -> list:
        """Synthesize the minimal typed event stream ``compare_runs``
        reads from one side's completed requests — the same shapes the
        real log carries, so the gate IS the ``obs compare`` contract."""
        evs = []
        for req in reqs:
            body = req.result or {}
            evs.append({"type": "router_request", "id": req.rid,
                        "replica": req.replica,
                        "ttft_ms": req.ttft_ms})
            evs.append({"type": "serve_request", "id": req.rid,
                        "prompt_tokens": len(req.prompt),
                        "output_tokens": len(body.get("tokens") or []),
                        "ttft_ms": body.get("ttft_ms"),
                        "tpot_ms": body.get("tpot_ms")})
        return evs

    def _tick_bake(self, now: float) -> None:
        baked = self.router.completed[self._bake_start_idx:]
        canary = [r for r in baked if r.replica == self._canary_name]
        # The canary's first wave out of the readmission backlog is not
        # counted (class docstring): only what it was handed at or after
        # its first answer.
        new_side = [r for r in canary
                    if r.last_launch_t is not None
                    and r.last_launch_t >= canary[0].done_t]
        old_side = [r for r in baked if r.replica != self._canary_name]
        enough = (len(new_side) >= self.bake_min_samples
                  and len(old_side) >= self.bake_min_samples)
        starved = now - self._bake_start_t > self.bake_timeout_s
        if not enough and not starved:
            return
        if not enough:
            # At the deadline the gate reads every canary answer, the
            # first wave too: a starved bake never promotes, so the wave
            # can only name the metric of the rollback.
            new_side = canary
        rc, res = gate_compare(self._gate_events(old_side),
                               self._gate_events(new_side),
                               pct=self.gate_pct)
        self.gate_result = res
        self.bake_samples = {"old": len(old_side), "canary": len(new_side)}
        if rc == 0 and enough:
            self._log(f"rollout: gate clean over {len(old_side)} old / "
                      f"{len(new_side)} canary samples — promoting")
            self._promote()
            return
        if rc == 1:
            bad = next(r for r in res["regressions"]
                       if r["metric"] in GATE_METRICS)
            self._abort(bad["metric"],
                        bad.get("detail") or f"{bad['metric']} regressed")
            return
        if starved:
            # rc 2 (or too few samples) at the deadline: the gate never
            # saw both sides — roll back rather than promote blind.
            self._abort("insufficient_data",
                        f"gate starved after {self.bake_timeout_s}s "
                        f"({len(old_side)} old / {len(new_side)} canary "
                        f"samples, need {self.bake_min_samples})")

    def _abort(self, metric: str, reason: str) -> None:
        """Regression (or a blind/unrecoverable roll): emit the abort
        with the failing metric, then roll the canary BACK to the old
        version through the same drain→swap→readmit machinery."""
        self.abort_metric = metric
        self.abort_reason = reason
        obs_events.emit("rollout_abort", version=self.target,
                        metric=metric, reason=reason)
        self._log(f"rollout: ABORT v{self.target} — {metric}: {reason}")
        self.router.clear_canary()
        swapped = [rep for _t, rep, phase in self.history
                   if phase in ("swapped", "relaunched")]
        if swapped and self.state in ("rolling", "bake"):
            # Restore every replica already moved (normally just the
            # canary — the bake gates before the rest roll).
            self._rollback = True
            self._swap_to = self.current_version
            self._plan = list(dict.fromkeys(swapped))
            self._cursor = 0
            self.state = "rolling"
            self._enter_phase("drain")
        else:
            self.state = "aborted"
            self._close_trace("aborted")


# ---------------------------------------------------------------------------
# Rolling-update fleet harness: subprocess replicas + router + controller
# (the zero-loss, canary-rollback and mid-swap-kill cases of the tests).
# ---------------------------------------------------------------------------

def rolling_update_smoke(*, replicas: int = 3, n_requests: int = 36,
                         seed: int = 0, slots: int = 2,
                         step_delay_ms: float = 20.0, rate: float = 1000.0,
                         max_new_tokens: int = 8,
                         queue_limit: int | None = 256,
                         hedge_ms: float | None = 5000.0,
                         scrape_interval_s: float = 0.05,
                         target_version: int = 1,
                         start_after_completed: int | None = None,
                         canary_frac: float = 0.34,
                         gate_pct: float | None = None,
                         bake_min_samples: int = 4,
                         bake_timeout_s: float = 20.0,
                         faults_spec: str | None = None,
                         kill_during_swap_rank: int | None = None,
                         watch_dir: str | None = None,
                         events_dir: str | None = None,
                         timeout_s: float = 90.0,
                         ready_timeout_s: float = 30.0,
                         log=None) -> dict:
    """Spawn a fleet of ``FakeEngine`` replicas, drive the seeded loadgen
    through the router,
    and run one live rollout mid-load — returning the router summary,
    the controller summary, replica exit codes and the final scraped
    per-replica versions.

    ``faults_spec`` is armed on EVERY replica (the ``slow_canary`` seam
    self-scopes to whichever replica is serving new weights);
    ``kill_during_swap_rank`` arms ``crash_during_swap`` on one rank and
    the harness plays supervisor: a replica that dies mid-swap is
    relaunched on the SAME port with ``--weights-version`` set to the
    NEW version, which the controller detects and readmits.

    With ``watch_dir`` set, the rollout is triggered the production way:
    the harness "commits" checkpoint ``step_<target_version>`` (manifest
    already on disk, COMMIT written last) once ``start_after_completed``
    requests have retired, and the controller's ``committed_world()``
    poll picks it up.  Without it, ``start()`` is called directly at the
    same trigger point."""
    import shutil
    import subprocess
    import tempfile

    from tpuframe_torch.serve import loadgen
    from tpuframe_torch.serve import router as router_lib

    start_after = (n_requests // 4 if start_after_completed is None
                   else start_after_completed)
    tmpdir = tempfile.mkdtemp(prefix="tpuframe-rollout-")
    procs: list = []
    ports: list = []
    relaunched_ranks: set = set()
    old_proc_id = os.environ.get("TPUFRAME_PROCESS_ID")

    def spawn(rank: int, *, version: int, port: int = 0):
        spec_parts = [s for s in (faults_spec,) if s]
        if (kill_during_swap_rank is not None
                and rank == kill_during_swap_rank
                and rank not in relaunched_ranks):
            spec_parts.append(f"crash_during_swap:rank={rank}")
        ready = os.path.join(tmpdir, f"ready.{rank}")
        if os.path.exists(ready):
            os.remove(ready)
        return router_lib._spawn_replica(
            rank, tmpdir=tmpdir, events_dir=events_dir, engine="fake",
            slots=slots, step_delay_ms=step_delay_ms, stall_timeout_s=2.0,
            faults_spec=",".join(spec_parts) or None,
            weights_version=version, port=port)

    try:
        for rank in range(replicas):
            procs.append(spawn(rank, version=0))
        ports = [router_lib._wait_ready(p, ready,
                                        timeout_s=ready_timeout_s)
                 for p, ready, _log in procs]
        urls = [f"http://127.0.0.1:{port}" for port in ports]
        if events_dir:
            os.environ["TPUFRAME_PROCESS_ID"] = str(replicas + 90)
            obs_events.init(events_dir)
        reqs = loadgen.synthetic_requests(
            n_requests, buckets=(16, 32), rate=rate,
            max_new_tokens=max_new_tokens, vocab_size=256, seed=seed)
        router = Router(urls, queue_limit=queue_limit, hedge_ms=hedge_ms,
                        scrape_interval_s=scrape_interval_s,
                        scrape_timeout_s=0.5, dispatch_timeout_s=30.0,
                        max_inflight_per_replica=max(2, slots))
        ctl = RolloutController(
            router, watch_dir=watch_dir, watch_interval_s=0.05,
            current_version=0, canary_frac=canary_frac,
            gate_pct=gate_pct, bake_min_samples=bake_min_samples,
            bake_timeout_s=bake_timeout_s, drain_timeout_s=10.0,
            swap_timeout_s=5.0, relaunch_timeout_s=ready_timeout_s,
            seed=seed, log=log)
        triggered = False

        def on_tick():
            nonlocal triggered
            if (not triggered
                    and router.counters["completed"] >= start_after):
                triggered = True
                if watch_dir:
                    _commit_fake_checkpoint(watch_dir, target_version)
                else:
                    ctl.start(target_version)
            # Supervisor half of the mid-swap-kill contract: a replica
            # that died rc 42 during the roll comes back on the SAME
            # port serving the NEW version.
            for rank, (proc, _ready, _lg) in enumerate(procs):
                if (proc.poll() is not None and proc.returncode != 0
                        and rank not in relaunched_ranks and triggered
                        and not ctl.done()):
                    relaunched_ranks.add(rank)
                    procs[rank] = spawn(rank, version=ctl.target or
                                        target_version, port=ports[rank])
                    try:
                        router_lib._wait_ready(
                            procs[rank][0], procs[rank][1],
                            timeout_s=ready_timeout_s)
                    except RuntimeError:
                        pass  # controller's relaunch timeout will abort
            if triggered or ctl.watch_dir:
                return ctl.tick()
            return not triggered
        out = router.run(reqs, timeout_s=timeout_s, on_tick=on_tick,
                         log=log)
        out["rollout"] = ctl.summary()
        # Final ground truth straight off each replica's gauge.
        final_versions = {}
        for rank, url in enumerate(urls):
            gauges = None
            try:
                status, text = router._transport(
                    url + "/metrics", None, 2.0)
                if status == 200:
                    gauges = parse_gauges(
                        text if isinstance(text, str) else "",
                        ("tpuframe_weights_version",))
            except Exception:  # noqa: BLE001 — a dead replica reports None
                pass
            final_versions[f"r{rank}"] = (
                int(gauges["tpuframe_weights_version"])
                if gauges and "tpuframe_weights_version" in gauges
                else None)
        out["final_versions"] = final_versions
        out["relaunched_ranks"] = sorted(relaunched_ranks)
        if events_dir:
            obs_events.close()
        for proc, _ready, _lg in procs:
            if proc.poll() is None:
                proc.terminate()
        exit_codes = []
        for proc, _ready, _lg in procs:
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
        for proc, _ready, _lg in procs:
            if proc.poll() is None:
                proc.kill()
        shutil.rmtree(tmpdir, ignore_errors=True)


def _commit_fake_checkpoint(directory: str, step: int, *,
                            processes: int = 1, devices: int = 1) -> None:
    """Make ``step_<step>`` visible to ``committed_world()`` the way the
    checkpoint writer does: manifest first, COMMIT last.  (A caller may
    pre-create the manifest-only directory, to show that the watch
    ignores a checkpoint mid-commit; this then lands the COMMIT.)"""
    import json

    d = os.path.join(directory, f"step_{step:08d}")
    os.makedirs(d, exist_ok=True)
    manifest = os.path.join(d, "manifest.json")
    if not os.path.exists(manifest):
        with open(manifest, "w") as f:
            json.dump({"step": step,
                       "world": {"processes": processes,
                                 "devices": devices}}, f)
    with open(os.path.join(d, "COMMIT"), "w") as f:
        f.write("ok\n")


# ---------------------------------------------------------------------------
# Self-check.
# ---------------------------------------------------------------------------

class _SimFleet:
    """In-process fleet stub for ``check()`` and unit tests: N replicas
    answering /healthz, /metrics (with the version gauge), /generate
    (deterministic TTFT, slower on the new version when poisoned) and
    /swap_weights — the whole controller state machine without a
    process or a socket."""

    def __init__(self, n: int, *, poisoned_ttft_ms: float | None = None):
        self.reps = {f"http://sim/r{i}": {"version": 0}
                     for i in range(n)}
        self.poisoned_ttft_ms = poisoned_ttft_ms
        self.swaps: list = []

    def transport(self, url: str, payload, timeout_s):
        base, _, path = url.rpartition("/")
        rep = self.reps[base]
        if path == "healthz":
            return 200, "ok\n"
        if path == "metrics":
            return 200, ("tpuframe_serve_queue_depth 0\n"
                         "tpuframe_serve_active_slots 0\n"
                         f"tpuframe_weights_version {rep['version']}\n")
        if path == "swap_weights":
            rep["version"] = int(payload["version"])
            self.swaps.append((base, rep["version"]))
            return 200, {"version": rep["version"],
                         "compile_cache_misses": 0}
        if path == "generate":
            ttft = 1.0
            if rep["version"] > 0 and self.poisoned_ttft_ms is not None:
                ttft = self.poisoned_ttft_ms
            return 200, {"rid": payload["rid"], "tokens": [1, 2, 3],
                         "ttft_ms": ttft, "tpot_ms": ttft / 4.0}
        return 404, {"error": f"no handler for {path}"}


def _drive_sim_rollout(*, n: int = 3, poisoned_ttft_ms=None,
                       gate_pct: float = 50.0, canary_frac: float = 0.5,
                       max_iters: int = 20000) -> tuple:
    """Run one complete rollout against the in-process stub fleet;
    returns (controller, router, fleet).  The router and the controller
    run on a virtual clock that advances 1 µs a loop, so the gate sees
    the stub fleet's latencies and not how long a loaded host took to
    run the dispatch threads (on the wall clock, as the JAX helper runs,
    a busy host's queue waits can fail a clean roll's gate)."""
    now = [0.0]

    def clock():
        return now[0]

    fleet = _SimFleet(n, poisoned_ttft_ms=poisoned_ttft_ms)
    router = Router(list(fleet.reps), transport=fleet.transport,
                    queue_limit=10_000, hedge_ms=0.0,
                    scrape_interval_s=0.0, scrape_timeout_s=0.2,
                    dispatch_timeout_s=2.0, max_inflight_per_replica=4,
                    clock=clock)
    ctl = RolloutController(
        router, transport=fleet.transport, clock=clock, current_version=0,
        canary_frac=canary_frac, gate_pct=gate_pct, bake_min_samples=4,
        bake_timeout_s=5.0, drain_timeout_s=2.0, swap_timeout_s=1.0,
        relaunch_timeout_s=2.0, poll_interval_s=0.0, seed=0)
    ctl.start(1)
    rid = 0
    for _ in range(max_iters):
        if rid < 4000 and len(router.pending) < 8:
            router.submit(rid, [1, 2, 3])
            rid += 1
        router.step()
        ctl.tick()
        if ctl.done() and not router.has_work():
            break
        now[0] += 1e-6
        time.sleep(0.0005)
    return ctl, router, fleet


def check() -> list:
    """Host-only rollout checks: event registration, env-knob
    resolution, the state-machine invariants on a simulated fleet, and
    the seeded poisoned-canary positive (a gate that fails to roll back a
    500x slower canary is blind).  The JAX check's source-lint leg (rule
    TF121, the swap seam) waits for the lint rules (ROADMAP.md queue 1,
    item 14).  Returns problem strings; [] means healthy."""
    problems: list = []

    from tpuframe_torch.obs import events as events_lib

    for etype in ROLLOUT_EVENT_TYPES:
        if etype not in events_lib.REQUIRED_FIELDS:
            problems.append(
                f"rollout event type {etype!r} not registered in "
                f"obs.events.REQUIRED_FIELDS")

    if not 0.0 <= resolve_canary_frac() <= 1.0:
        problems.append("TPUFRAME_CANARY_FRAC resolved outside [0, 1]")
    if resolve_gate_pct() < 0:
        problems.append("TPUFRAME_ROLLOUT_GATE resolved below 0")

    # Gate arithmetic: participate-only-when-both, and the rc contract.
    fast = [{"type": "router_request", "id": i, "replica": "r0",
             "ttft_ms": 10.0} for i in range(8)]
    slow = [{"type": "router_request", "id": i, "replica": "r1",
             "ttft_ms": 100.0} for i in range(8)]
    rc, _res = gate_compare(fast, slow, pct=25.0)
    if rc != 1:
        problems.append(f"gate_compare missed a 10x TTFT regression "
                        f"(rc {rc}, want 1)")
    rc, _res = gate_compare(fast, [], pct=25.0)
    if rc != 2:
        problems.append(f"gate_compare promoted with one side empty "
                        f"(rc {rc}, want 2) — the gate must never run "
                        f"blind")

    # State-machine invariants on the clean simulated fleet: every
    # replica drains before it swaps and swaps before it readmits, at
    # most one replica is mid-transition at a time, and the fleet ends
    # on the new version with a zero compile-miss floor.
    ctl, router, fleet = _drive_sim_rollout(gate_pct=50.0)
    if ctl.state != "done":
        problems.append(f"sim rollout did not complete: state "
                        f"{ctl.state} ({ctl.abort_reason})")
    else:
        versions = {rep["version"] for rep in fleet.reps.values()}
        if versions != {1}:
            problems.append(f"sim rollout left mixed versions {versions}")
        if ctl.swap_compile_misses != 0:
            problems.append(f"sim rollout cost "
                            f"{ctl.swap_compile_misses} compile misses")
        order: dict = {}
        for i, (_t, rep, phase) in enumerate(ctl.history):
            order.setdefault(rep, []).append(phase)
        for rep, phases in order.items():
            want_prefix = ["drain", "swapped", "readmitted"]
            got = [p for p in phases if p in want_prefix]
            if got != want_prefix:
                problems.append(f"sim rollout phase order on {rep}: "
                                f"{phases}")
        if router.counters["admitted"] != router.counters["completed"]:
            problems.append(
                f"sim rollout lost requests: "
                f"{router.counters['admitted']} admitted vs "
                f"{router.counters['completed']} completed")

    # Seeded poisoned-canary positive: the gate MUST roll back.
    ctl, _router, fleet = _drive_sim_rollout(poisoned_ttft_ms=500.0,
                                             gate_pct=50.0)
    if ctl.state != "aborted":
        problems.append(
            f"poisoned canary was NOT rolled back (state {ctl.state}) "
            f"— the promotion gate is blind and may not run")
    else:
        if ctl.abort_metric not in GATE_METRICS:
            problems.append(f"rollback named metric "
                            f"{ctl.abort_metric!r}, want one of "
                            f"{GATE_METRICS}")
        versions = {rep["version"] for rep in fleet.reps.values()}
        if versions != {0}:
            problems.append(f"rollback left versions {versions}, "
                            f"want all back on 0")

    from tpuframe_torch.resilience import faults as faults_lib

    for seam, kind in (("slow_canary", "slow"),
                       ("crash_during_swap", "crash")):
        try:
            parsed = faults_lib.parse(seam)
        except ValueError as exc:
            problems.append(f"fault seam {seam} unparseable: {exc}")
            continue
        if not parsed or parsed[0].kind != kind:
            problems.append(f"fault seam {seam}: default kind "
                            f"{parsed[0].kind if parsed else '?'} "
                            f"(want {kind})")

    return problems
