"""One serving replica of the fleet (counterpart of
``tpuframe/serve/replica.py``): engine + scheduler behind the exporter.

A replica is the unit the router (``serve/router.py``) load-balances
over: the continuous-batching :class:`~tpuframe_torch.serve.scheduler.
Scheduler` wrapped in a process whose entire HTTP surface rides the
telemetry exporter (``obs/exporter.py``):

  ``/metrics``   live queue depth / active slots / TTFT percentiles (the
                 router's load + shed signal)
  ``/healthz``   200 while the step loop beats and the replica is not
                 draining; 503 otherwise — the router's drain signal
  ``/generate``  POST ``{"rid", "prompt", "max_new_tokens"}`` → blocks
                 until the scheduler retires the request, returns
                 ``{"rid", "tokens", "ttft_ms", "tpot_ms", "proc"}``
  ``/swap_weights``
                 POST ``{"version"[, "seed"]}`` → blocks until the main
                 loop, with no request left in its hands, applies the hot
                 swap through the engine's ``swap_params`` seam, returns
                 ``{"version",
                 "compile_cache_misses"}``.  The replica also publishes
                 the label-free ``tpuframe_weights_version`` gauge on
                 ``/metrics``, which the router scrapes.

Threading contract: the exporter's HTTP worker threads only parse,
enqueue into the inbox and wait on an event — the *main* thread is the
only one that touches the engine (prefill, insert, decode and the swap
run CUDA work on the real engine).  No thread is created in this module.

Drain semantics (the zero-loss half of the fleet contract): SIGTERM — or
a 503-flipping health probe — marks the replica draining.  ``/generate``
rejects *new* work with 503, ``/healthz`` goes 503 so the router stops
dispatching and re-dispatches as it sees fit, and the main loop keeps
stepping until every request it already accepted has retired and been
answered; only then does it exit 0.  A request is therefore never
acknowledged-and-dropped: it either completes here or was never accepted.

Chaos seams (``resilience/faults.py``): the step loop fires
``replica_slow`` / ``replica_hang`` / ``replica_crash`` once per
iteration with the fault step pinned to the scheduler step count, so
``TPUFRAME_FAULTS="replica_crash:step=3:rank=1"`` deterministically
kills replica 1 (``TPUFRAME_PROCESS_ID=1``) after its third scheduler
step.  ``slow_canary`` fires per iteration but only while the replica
serves a weights version it was not launched with, and
``crash_during_swap`` fires inside the swap application, after the swap
was accepted but before the new version is live.

The :class:`FakeEngine` is the pure-host stand-in for fleet tests:
deterministic token streams that are a function of the prompt alone, so
re-prefill on any replica reproduces them — the idempotence the router's
hedging (first-winner-kept) relies on, as the real engine's greedy
argmax decode does.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import threading
import time

from tpuframe_torch.obs import events as obs_events
from tpuframe_torch.obs import exporter as obs_exporter
from tpuframe_torch.obs import tracing
from tpuframe_torch.resilience import faults
from tpuframe_torch.serve.scheduler import Request, Scheduler

READY_PREFIX = "TPUFRAME_REPLICA_READY"

# Fired once per main-loop iteration, cheap no-ops unless armed.
_FAULT_SEAMS = ("replica_slow", "replica_hang", "replica_crash")


def _compile_misses() -> int:
    """The JAX replica's compile-cache miss counter.  Eager PyTorch has no
    compile cache, so a swap always answers 0 misses (the JAX engine's
    swap is zero recompiles by construction; so is this one: no program
    exists to recompile)."""
    return 0


class FakeEngine:
    """Deterministic pure-host engine with the LMEngine seam contract.

    Token streams are a pure function of the prompt (first token from a
    prompt hash, each decode token from the previous one), so any
    replica re-prefilling the same request produces the same stream —
    the property that makes the router's redispatch/hedging idempotent.
    ``step_delay_s`` models decode cost so fleet runs have real
    queueing behavior without a model.
    """

    def __init__(self, *, slots: int = 2, prompt_buckets=(16, 32),
                 eos_id: int | None = None, step_delay_s: float = 0.0,
                 vocab_size: int = 256):
        self.slots = slots
        self.prompt_buckets = tuple(sorted(prompt_buckets))
        self.eos_id = eos_id
        self.step_delay_s = step_delay_s
        self.vocab_size = vocab_size
        self._last = [0] * slots
        self.last_prefill_ms = 0.0

    def prefill(self, token_ids):
        t0 = time.monotonic()
        first = (sum(int(t) for t in token_ids)
                 + 31 * len(token_ids)) % self.vocab_size
        self.last_prefill_ms = 1e3 * (time.monotonic() - t0)
        return first, ("pcache", len(token_ids)), len(token_ids)

    def insert(self, slot, pcache, length, first_token) -> None:
        self._last[slot] = int(first_token)

    def decode_step(self):
        if self.step_delay_s > 0:
            time.sleep(self.step_delay_s)
        out = []
        for s in range(self.slots):
            self._last[s] = (self._last[s] * 31 + 7) % self.vocab_size
            out.append(self._last[s])
        return out

    def reset(self) -> None:
        self._last = [0] * self.slots


class Replica:
    """The serving fleet's worker: scheduler main loop + exporter surface."""

    def __init__(self, engine, *, stall_timeout_s: float = 2.0,
                 handler_timeout_s: float = 120.0, clock=time.monotonic,
                 weights_version: int = 0):
        self.engine = engine
        self._clock = clock
        self.stall_timeout_s = stall_timeout_s
        self.handler_timeout_s = handler_timeout_s
        self.scheduler = Scheduler(engine)
        self._inbox: list = []               # (Request, threading.Event)
        self._inbox_lock = threading.Lock()
        self._waiters: dict = {}             # rid -> threading.Event
        self._resolved = 0                   # prefix of scheduler.completed
        self._draining = False
        self._last_beat = clock()
        # The served weights version (checkpoint step for real weights).
        # ``_launch_version`` is what this process booted with — the
        # slow_canary seam keys on the difference, so a fault armed
        # fleet-wide slows exactly the replicas serving NEW weights.
        self.weights_version = int(weights_version)
        self._launch_version = int(weights_version)
        self._swap_inbox: list = []          # swap jobs (dicts)
        # (version, seed, weights) the last seeded swap replaced, as
        # served: a swap back to that version with no seed (the rollout's
        # rollback) restores them.  The JAX replica keeps no weights: its
        # rollback moves the version gauge and leaves the new weights
        # serving.  ``_seed`` is the seed of the served weights (None: the
        # launch weights).
        self._held: tuple | None = None
        self._seed: int | None = None
        self.exporter = obs_exporter.start_from_env(health=self.healthy)
        if self.exporter is not None:
            self.exporter.add_handler("/generate", self.handle_generate)
            self.exporter.add_handler("/swap_weights", self.handle_swap)
            self.exporter.add_collector(self._version_sample)

    def _version_sample(self):
        # Label-free on purpose: the router's parse_gauges reads only
        # label-free lines off the scrape.
        return [("tpuframe_weights_version", {},
                 float(self.weights_version))]

    # -- health / drain ---------------------------------------------------

    def healthy(self) -> bool:
        """503 the moment we drain OR the step loop stops beating — the
        router must see a hung replica (main loop stuck, exporter thread
        alive) as unhealthy before any request deadline trips."""
        if self._draining:
            return False
        return (self._clock() - self._last_beat) < self.stall_timeout_s

    @property
    def draining(self) -> bool:
        return self._draining

    def drain(self, signum=None, frame=None) -> None:
        """Graceful drain (the SIGTERM handler): stop accepting, finish
        and answer everything already accepted, then let ``run`` exit."""
        self._draining = True

    # -- the exporter-thread side -----------------------------------------

    def handle_generate(self, body: bytes):
        """POST /generate — runs on an exporter HTTP worker thread.
        Only parses, enqueues and waits; the main loop owns the engine."""
        try:
            msg = json.loads(body.decode() or "{}")
            rid = int(msg["rid"])
            prompt = [int(t) for t in msg["prompt"]]
            max_new = int(msg.get("max_new_tokens", 8))
        except (KeyError, ValueError, TypeError) as e:
            return 400, json.dumps({"error": f"bad request: {e}"}).encode()
        if len(prompt) > max(self.engine.prompt_buckets) or not prompt:
            return 400, json.dumps(
                {"error": f"prompt length {len(prompt)} outside buckets "
                          f"{self.engine.prompt_buckets}"}).encode()
        if self._draining:
            return 503, json.dumps({"error": "draining"}).encode()
        # arrival_t on the SCHEDULER's clock — queue/prefill spans and
        # the serve_request TTFT are deltas against it, so every
        # replica-side duration comes from one monotonic clock source.
        req = Request(rid=rid, prompt=prompt, max_new_tokens=max_new,
                      arrival_t=self.scheduler._clock())
        trace = msg.get("trace")
        if trace is not None:
            # The router's attempt span id arrives as "span": parenting
            # the serve span under it stitches the cross-process tree.
            req.trace = str(trace)
            req.span = tracing.open_span(req.trace, "serve",
                                         parent=msg.get("span"), rid=rid)
        done = threading.Event()
        with self._inbox_lock:
            self._inbox.append((req, done))
        if not done.wait(self.handler_timeout_s):
            # The serve span stays OPEN on purpose: a request the
            # scheduler never answered is exactly what the leaked-span
            # anomaly exists to make loud.
            return 504, json.dumps(
                {"error": "timed out waiting for the scheduler"}).encode()
        if req.trace is not None and req.span is not None:
            tracing.close_span(
                req.trace, req.span,
                1e3 * max(0.0, self.scheduler._clock() - req.arrival_t),
                ttft_ms=round(req.ttft_ms() or 0.0, 3),
                tpot_ms=round(req.tpot_ms(), 3)
                if req.tpot_ms() is not None else None)
        return 200, json.dumps({
            "rid": rid,
            "tokens": [int(t) for t in req.tokens],
            "ttft_ms": req.ttft_ms(),
            "tpot_ms": req.tpot_ms(),
            "proc": os.environ.get("TPUFRAME_PROCESS_ID", "0"),
        }).encode()

    def handle_swap(self, body: bytes):
        """POST /swap_weights — runs on an exporter HTTP worker thread.
        Like /generate it only parses, enqueues and waits: the MAIN loop
        owns the engine, so the swap is applied once the replica holds no
        request (:meth:`_apply_swaps`) and the only-main-thread-touches-
        the-engine contract holds.  A POST of a swap already queued (the
        caller's retry after a timeout) waits on that job and queues no
        second one.  With a ``seed`` the new weights are the port's
        random init drawn from it (``TransformerLM(cfg, seed=seed)``, a
        ``torch.Generator`` seeded with it), not the JAX package's init
        for the same seed.  Without one, a real engine goes back to the
        weights it served under ``version`` before its last seeded swap,
        and refuses a version it holds no weights of."""
        try:
            msg = json.loads(body.decode() or "{}")
            version = int(msg["version"])
            seed = msg.get("seed")
            seed = None if seed is None else int(seed)
        except (KeyError, ValueError, TypeError) as e:
            return 400, json.dumps({"error": f"bad swap: {e}"}).encode()
        with self._inbox_lock:
            job = next((j for j in self._swap_inbox
                        if (j["version"], j["seed"]) == (version, seed)),
                       None)
            if job is None:
                job = {"version": version, "seed": seed, "result": None,
                       "done": threading.Event()}
                self._swap_inbox.append(job)
        if not job["done"].wait(self.handler_timeout_s):
            return 504, json.dumps(
                {"error": "timed out waiting for the swap"}).encode()
        if "error" in (job["result"] or {}):
            return 500, json.dumps(job["result"]).encode()
        return 200, json.dumps(job["result"]).encode()

    # -- the main-loop side ------------------------------------------------

    def _apply_swaps(self) -> None:
        """Apply queued weight swaps on the MAIN loop, between scheduler
        steps, and only while the replica holds no accepted work: nothing
        in its inbox, queued or in a slot.  The rollout's drain probe
        reads the queue and slot gauges, which miss a request in the
        inbox or in its prefill; the JAX replica applies the swap at the
        next step all the same, and the request then decodes on both
        versions (ROADMAP.md queue 3).  The ``crash_during_swap`` seam
        fires after the swap was accepted but before the version flips —
        the window where a kill must leave the supervisor relaunching on
        the NEW version."""
        with self._inbox_lock:
            if self._inbox or self.scheduler.has_work():
                return
            jobs, self._swap_inbox = self._swap_inbox, []
        for job in jobs:
            try:
                faults.fire("crash_during_swap")
                misses0 = _compile_misses()
                if (job["version"], job["seed"]) == (self.weights_version,
                                                     self._seed):
                    pass    # served already: a retry that came too late
                elif job["seed"] is not None:
                    # Real-weights path: regenerate params (stand-in for
                    # a checkpoint restore) and hot-swap them through
                    # the engine's one seam.  The port's init drawn from
                    # the seed, not the JAX package's init for that seed.
                    from tpuframe_torch.models.transformer_lm import (
                        TransformerLM)

                    new_params = TransformerLM(
                        self.engine.cfg, device=self.engine.device,
                        seed=job["seed"]).state_dict()
                    held = self.engine.served_params()
                    self.engine.swap_params(new_params)
                    self._held = (self.weights_version, self._seed, held)
                    self._seed = job["seed"]
                elif (hasattr(self.engine, "served_params")
                      and job["version"] != self.weights_version):
                    if self._held is None or self._held[0] != job["version"]:
                        raise ValueError(
                            f"no weights of version {job['version']} here "
                            f"(serving v{self.weights_version}); a swap to "
                            f"new weights names their seed")
                    _v, seed, weights = self._held
                    self._held = (self.weights_version, self._seed,
                                  self.engine.served_params())
                    self.engine.restore_params(weights)
                    self._seed = seed
                self.weights_version = job["version"]
                job["result"] = {
                    "version": self.weights_version,
                    "compile_cache_misses": _compile_misses() - misses0,
                }
            except Exception as e:  # noqa: BLE001 — a refused swap (bad
                # tree/shape) must answer 500, not kill the serving loop
                job["result"] = {"error": f"{type(e).__name__}: {e}"}
            job["done"].set()

    def _pump_inbox(self) -> int:
        with self._inbox_lock:
            batch, self._inbox = self._inbox, []
        for req, done in batch:
            self._waiters[req.rid] = done
            self.scheduler.submit(req)
        return len(batch)

    def _resolve_completed(self) -> None:
        completed = self.scheduler.completed
        while self._resolved < len(completed):
            req = completed[self._resolved]
            self._resolved += 1
            done = self._waiters.pop(req.rid, None)
            if done is not None:
                done.set()

    def run(self, *, max_steps: int | None = None,
            idle_sleep_s: float = 0.002,
            max_idle_s: float | None = None) -> int:
        """The replica main loop: beat, fire chaos seams, pump the inbox,
        step the scheduler, answer retired requests.  Returns 0 when a
        drain completed with nothing left in flight."""
        sched = self.scheduler
        idle_since = self._clock()
        while True:
            self._last_beat = self._clock()
            faults.set_step(sched.step_count)
            for seam in _FAULT_SEAMS:
                faults.fire(seam)
            if self.weights_version != self._launch_version:
                # Scoped to the NEW version by construction: arm the
                # fault fleet-wide and only the swapped canary slows.
                faults.fire("slow_canary")
            self._apply_swaps()
            self._pump_inbox()
            if sched.has_work():
                sched.step()
                self._resolve_completed()
                idle_since = self._clock()
            elif self._draining:
                break  # drained: every accepted request has been answered
            else:
                if (max_idle_s is not None
                        and self._clock() - idle_since > max_idle_s):
                    break
                time.sleep(idle_sleep_s)
            if max_steps is not None and sched.step_count >= max_steps:
                break
        self._resolve_completed()
        return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m tpuframe_torch.serve.replica",
        description="one serving-fleet replica (engine+scheduler behind "
                    "the telemetry exporter)")
    ap.add_argument("--engine", default="fake", choices=("fake", "tiny-lm"))
    ap.add_argument("--device", default="cuda",
                    help="torch device of the tiny-lm engine; 'cpu' runs "
                         "the plain kernels")
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--step-delay-ms", type=float, default=0.0,
                    help="fake-engine decode cost per step")
    ap.add_argument("--stall-timeout-s", type=float, default=2.0)
    ap.add_argument("--max-steps", type=int, default=None)
    ap.add_argument("--max-idle-s", type=float, default=None,
                    help="exit after this much idle time (orphan guard)")
    ap.add_argument("--ready-file", default=None,
                    help="write the READY line (bound port) here")
    ap.add_argument("--weights-version", type=int, default=0,
                    help="version this replica boots on (a relaunch "
                         "after a mid-swap kill passes the NEW one)")
    args = ap.parse_args(argv)

    faults.reset_from_env()
    obs_events.init()
    if args.engine == "fake":
        engine = FakeEngine(slots=args.slots,
                            step_delay_s=args.step_delay_ms / 1e3)
    else:
        from tpuframe_torch.models.transformer_lm import LMConfig
        from tpuframe_torch.serve.engine import LMEngine

        buckets = (16, 32)
        engine = LMEngine(LMConfig.tiny(), slots=args.slots,
                          prompt_buckets=buckets, decode_block=16,
                          max_context=max(buckets) + 32, device=args.device)

    replica = Replica(engine, stall_timeout_s=args.stall_timeout_s,
                      weights_version=args.weights_version)
    signal.signal(signal.SIGTERM, replica.drain)
    if replica.exporter is None or replica.exporter.port is None:
        print("[replica] no scrape endpoint — set TPUFRAME_METRICS_PORT "
              "(0 = ephemeral) before launching a fleet replica",
              file=sys.stderr)
        return 2
    ready = f"{READY_PREFIX} port={replica.exporter.port} pid={os.getpid()}"
    if args.ready_file:
        tmp = f"{args.ready_file}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            f.write(ready + "\n")
        os.replace(tmp, args.ready_file)
    print(ready, flush=True)

    rc = replica.run(max_steps=args.max_steps, max_idle_s=args.max_idle_s)
    obs_events.close()
    obs_exporter.stop()
    return rc


if __name__ == "__main__":
    sys.exit(main())
