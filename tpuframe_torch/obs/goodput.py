"""Goodput accounting (counterpart of ``tpuframe/obs/goodput.py``): the
offline analysis of a run's event stream.

  - the bucket rollup of a (merged, multi-attempt) log
    (:func:`from_events`), with restart-lost time across attempts;
  - MFU and HBM-roofline use of a step (:func:`mfu`, :func:`hbm_util`)
    against the card's own peaks;
  - the anomaly sweep (:func:`find_anomalies`);
  - the percentile helper the scheduler and router share, and the rollups
    of a serving log (:func:`serve_stats`) and of a fleet's router log
    (:func:`fleet_stats`);
  - the regression sentry (:func:`compare_runs`), which the rollout gate
    calls.

Buckets (seconds; they partition attempt wall time), as the JAX
package's live meter writes them into ``run_end``:

  init        process start to the first step dispatched
  compile     the first train step's wall time
  productive  steps 2..N, the only bucket that moves the loss
  input       time the loop sat blocked on the data pipeline
  ckpt        blocking checkpoint time
  eval        eval passes
  stall       watchdog-detected dead time (``stall`` events)
  other       wall minus the rest

The peaks are one table, :data:`PEAKS`: the H100 SXM's published dense
rates (NVIDIA's data sheet, at 700 W), the same figures as chip_smoke.py's
rooflines.  A log names the hardware it ran on in ``run_start``'s
``generation``; a log that names hardware the table lacks (a TPU log of
the JAX package names ``v5e``) gets no MFU and no HBM use here, neither
recomputed nor read back from its ``run_end``: those numbers would be
against a peak this package does not hold.

The live meter of the trainer (the JAX package's ``GoodputMeter``) comes
with the trainer's run events (ROADMAP.md queue 1).

Pure stdlib, as ``obs.events``.
"""

from __future__ import annotations

from dataclasses import dataclass

BUCKETS = ("init", "compile", "productive", "input", "ckpt", "eval",
           "stall", "other")


@dataclass(frozen=True)
class Peaks:
    """One card's published peaks, dense, per device."""

    bf16_flops: float
    f32_flops: float
    hbm_bytes_per_s: float


# NVIDIA H100 SXM data sheet: 989 TFLOP/s bf16 on the tensor cores (dense),
# 67 TFLOP/s f32 outside them, 3.35 TB/s of HBM3.
PEAKS = {"h100": Peaks(bf16_flops=989e12, f32_flops=67e12,
                       hbm_bytes_per_s=3.35e12)}

DEFAULT_GENERATION = "h100"


def mfu(flops_per_step: float, step_time_s: float, *,
        generation: str = DEFAULT_GENERATION,
        n_devices: int = 1) -> float | None:
    """Model FLOPs Utilization of one step against the bf16 peak of
    ``n_devices`` cards (``flops_per_step`` counts the whole program).
    None when :data:`PEAKS` has no entry for ``generation``."""
    hw = PEAKS.get(generation)
    if hw is None:
        return None
    if step_time_s <= 0 or flops_per_step <= 0 or n_devices <= 0:
        return 0.0
    return flops_per_step / (step_time_s * hw.bf16_flops * n_devices)


def hbm_util(bytes_per_step: float, step_time_s: float, *,
             generation: str = DEFAULT_GENERATION,
             n_devices: int = 1) -> float | None:
    """HBM-roofline use of one step: the bytes it accessed over what the
    cards' HBM could stream in that time, the bandwidth twin of
    :func:`mfu`.  None when :data:`PEAKS` has no entry for
    ``generation``."""
    hw = PEAKS.get(generation)
    if hw is None:
        return None
    if step_time_s <= 0 or bytes_per_step <= 0 or n_devices <= 0:
        return 0.0
    return bytes_per_step / (step_time_s * hw.hbm_bytes_per_s * n_devices)


def flops_fallback(n_params: int, examples_per_step: int,
                   tokens_per_example: int = 1) -> float:
    """Analytic forward+backward flops when no cost model exists: the
    dense 6·N·D estimate (2 flops a parameter forward, 4 backward, per
    processed token or example)."""
    return 6.0 * float(n_params) * float(examples_per_step) \
        * float(tokens_per_example)


# ---------------------------------------------------------------------------
# The bucket rollup of an event stream.
# ---------------------------------------------------------------------------

def _attempts(events: list[dict]) -> list[list[dict]]:
    """Split a merged stream into per-attempt sub-streams (ascending)."""
    by_attempt: dict[int, list[dict]] = {}
    for rec in events:
        by_attempt.setdefault(int(rec.get("attempt", 0)), []).append(rec)
    return [by_attempt[a] for a in sorted(by_attempt)]


def step_times_ms(events: list[dict], *,
                  include_first: bool = False) -> list[float]:
    """Per-step host wall ms from ``step`` events (the first step, the
    compile, is left out unless asked for)."""
    steps = [r for r in events if r.get("type") == "step"]
    if not include_first and steps:
        steps = steps[1:]
    return [float(r["wall_ms"]) for r in steps if "wall_ms" in r]


def _generation(events: list[dict], generation: str | None) -> str:
    start = next((r for r in events if r.get("type") == "run_start"), None)
    return (generation or (start or {}).get("generation")
            or DEFAULT_GENERATION)


def from_events(events: list[dict], *,
                generation: str | None = None) -> dict:
    """Recompute the goodput breakdown from a (merged) event stream.

    An attempt with a ``run_end`` is read from its summary; a crashed one
    is rebuilt from its ``step``, ``ckpt_save`` and ``stall`` events.
    Restart-lost time is the gap between each attempt's last event and
    the next one's first, and ``retrained_steps`` counts the steps a
    relaunch ran again.  MFU and HBM use are kept only for hardware in
    :data:`PEAKS` (``generation``, else the log's, else
    :data:`DEFAULT_GENERATION`)."""
    out: dict = {"attempts": 0, "restart_lost_s": 0.0,
                 "retrained_steps": 0}
    attempts = _attempts(events)
    out["attempts"] = len(attempts)
    if not attempts:
        out["buckets"] = {b: 0.0 for b in BUCKETS}
        out["wall_s"] = 0.0
        out["steps"] = 0
        return out

    for prev, nxt in zip(attempts, attempts[1:]):
        prev_ts = [r["t"] for r in prev if "t" in r]
        nxt_ts = [r["t"] for r in nxt if "t" in r]
        if prev_ts and nxt_ts:
            out["restart_lost_s"] += max(0.0, min(nxt_ts) - max(prev_ts))
        prev_hi = max((int(r["step"]) for r in prev
                       if r.get("type") == "step"), default=0)
        replayed = [int(r["step"]) for r in nxt
                    if r.get("type") == "step" and int(r["step"]) <= prev_hi]
        out["retrained_steps"] += len(replayed)

    resizes = [r for r in events if r.get("type") == "elastic_resize"]
    if resizes:
        out["elastic_resizes"] = len(resizes)
        out["elastic_transitions"] = [
            f"{int(r.get('n_from', 0))}->{int(r.get('n_to', 0))}"
            for r in resizes]

    gen = _generation(events, generation)
    known = gen in PEAKS
    buckets = {b: 0.0 for b in BUCKETS}
    wall = 0.0
    final_step = 0
    n_steps = 0
    util: dict = {}   # mfu_productive, mfu_goodput, hbm_util_productive
    peak_hbm = None
    for stream in attempts:
        end = next((r for r in stream if r.get("type") == "run_end"), None)
        if end is not None:
            g = end.get("goodput", {})
            for k, v in g.get("buckets", {}).items():
                if k in buckets:
                    buckets[k] += float(v)
            wall += float(g.get("wall_s", end.get("wall_s", 0.0)))
            final_step = max(final_step, int(end.get("final_step", 0)))
            n_steps += int(g.get("steps") or
                           sum(1 for r in stream if r.get("type") == "step"))
            for key in ("mfu_productive", "mfu_goodput",
                        "hbm_util_productive"):
                if known and end.get(key) is not None:
                    util[key] = float(end[key])
            if end.get("peak_hbm_bytes") is not None:
                peak_hbm = max(peak_hbm or 0, int(end["peak_hbm_bytes"]))
            continue
        # A crashed attempt: rebuilt from its raw events, attempt-locally.
        ts = [r["t"] for r in stream if "t" in r]
        span = (max(ts) - min(ts)) if len(ts) > 1 else 0.0
        wall += span
        local = {b: 0.0 for b in BUCKETS if b != "other"}
        steps = [r for r in stream if r.get("type") == "step"]
        n_steps += len(steps)
        if steps:
            final_step = max(final_step,
                             max(int(r["step"]) for r in steps))
            local["compile"] += float(steps[0].get("wall_ms", 0.0)) / 1e3
            local["productive"] += sum(
                float(r.get("wall_ms", 0.0)) for r in steps[1:]) / 1e3
            # schema v2: the input wait rides on each step record
            local["input"] += sum(
                float(r.get("input_wait_ms", 0.0)) for r in steps) / 1e3
        for r in stream:
            if r.get("type") == "ckpt_save":
                # ``block_ms`` (v2) is what the step path waited; an async
                # save's ``ms`` runs through its commit, beside training
                blocked = r.get("block_ms")
                if blocked is None:
                    blocked = 0.0 if r.get("async_write") \
                        else r.get("ms", 0.0)
                local["ckpt"] += float(blocked) / 1e3
            elif r.get("type") == "stall":
                local["stall"] += float(r.get("idle_s", 0.0))
        for k, v in local.items():
            buckets[k] += v
        buckets["other"] += max(0.0, span - sum(local.values()))
        for r in stream:
            if r.get("type") == "devmem":
                for dev in r.get("devices", []):
                    b = dev.get("peak_bytes_in_use",
                                dev.get("bytes_in_use"))
                    if b is not None:
                        peak_hbm = max(peak_hbm or 0, int(b))

    out["buckets"] = {k: round(v, 3) for k, v in buckets.items()}
    out["wall_s"] = round(wall, 3)
    out["steps"] = n_steps
    out["final_step"] = final_step
    out.update(util)
    if peak_hbm is not None:
        out["peak_hbm_bytes"] = peak_hbm

    # Recomputed from the cost models in run_start, for logs that never
    # wrote run_end (or wrote it without them).
    if known and ("mfu_productive" not in util
                  or "hbm_util_productive" not in util):
        start = next((r for r in events if r.get("type") == "run_start"),
                     None)
        times = step_times_ms(events)
        if start and times:
            mean_s = sum(times) / len(times) / 1e3
            n_dev = int(start.get("devices", 1))
            if "mfu_productive" not in util and start.get("flops_per_step"):
                out["mfu_productive"] = mfu(
                    float(start["flops_per_step"]), mean_s,
                    generation=gen, n_devices=n_dev)
            if ("hbm_util_productive" not in util
                    and start.get("bytes_per_step")):
                out["hbm_util_productive"] = hbm_util(
                    float(start["bytes_per_step"]), mean_s,
                    generation=gen, n_devices=n_dev)
    return out


# ---------------------------------------------------------------------------
# The anomaly sweep.
# ---------------------------------------------------------------------------

def find_anomalies(events: list[dict], *, slow_factor: float = 3.0,
                   window: int = 16, retry_storm: int = 5,
                   retry_window_s: float = 60.0,
                   mfu_min: float | None = None,
                   blocked_ms: float = 1000.0) -> list[dict]:
    """Flag suspicious shapes in a merged event stream; each finding is
    ``{"kind", "detail", ...anchors}``:

      step_regression    a step slower than ``slow_factor`` x the rolling
                         median of the ``window`` steps before it (the
                         compile step left out);
      stall              every ``stall`` event;
      retry_storm        ``retry_storm`` retries inside
                         ``retry_window_s`` (reported once);
      low_mfu            MFU below ``mfu_min`` (off by default);
      no_run_end         an attempt that never wrote ``run_end``;
      blocked_input      a step that waited over ``blocked_ms`` on input;
      blocked_ckpt       a save that blocked the step path over
                         ``blocked_ms``;
      goodput_invariant  an attempt whose ``run_end`` buckets do not sum
                         to its wall time;
      leaked_span / orphan_span
                         from :func:`tracing.span_anomalies`.
    """
    findings: list[dict] = []

    steps = [r for r in events if r.get("type") == "step"
             and "wall_ms" in r]
    recent: list[float] = []
    for r in steps[1:]:
        ms = float(r["wall_ms"])
        if len(recent) >= 3:
            med = sorted(recent)[len(recent) // 2]
            if med > 0 and ms > slow_factor * med:
                findings.append({
                    "kind": "step_regression", "step": int(r["step"]),
                    "wall_ms": round(ms, 2),
                    "rolling_median_ms": round(med, 2),
                    "detail": f"step {r['step']} took {ms:.1f} ms — "
                              f"{ms / med:.1f}x the rolling median "
                              f"({med:.1f} ms)"})
        recent.append(ms)
        if len(recent) > window:
            recent.pop(0)

    for r in events:
        if r.get("type") == "stall":
            findings.append({
                "kind": "stall", "last_step": r.get("last_step"),
                "idle_s": r.get("idle_s"),
                "detail": f"heartbeat stall: no step for "
                          f"{r.get('idle_s', '?')}s after step "
                          f"{r.get('last_step', '?')}"})

    retries = sorted(float(r["t"]) for r in events
                     if r.get("type") == "retry" and "t" in r)
    lo = 0
    for hi in range(len(retries)):
        while retries[hi] - retries[lo] > retry_window_s:
            lo += 1
        if hi - lo + 1 >= retry_storm:
            findings.append({
                "kind": "retry_storm", "count": hi - lo + 1,
                "window_s": retry_window_s,
                "detail": f"{hi - lo + 1} I/O retries within "
                          f"{retry_window_s:.0f}s — storage backend "
                          f"degraded"})
            break   # one report a stream

    if mfu_min is not None:
        got = from_events(events).get("mfu_productive")
        if got is not None and got < mfu_min:
            findings.append({
                "kind": "low_mfu", "mfu": round(got, 4),
                "threshold": mfu_min,
                "detail": f"MFU {got:.2%} below threshold "
                          f"{mfu_min:.2%}"})

    if blocked_ms is not None:
        for r in events:
            if (r.get("type") == "step"
                    and float(r.get("input_wait_ms") or 0.0) > blocked_ms):
                w = float(r["input_wait_ms"])
                findings.append({
                    "kind": "blocked_input", "step": r.get("step"),
                    "input_wait_ms": round(w, 2), "threshold_ms": blocked_ms,
                    "detail": f"step {r.get('step')} blocked {w:.0f} ms on "
                              f"the input pipeline (> {blocked_ms:.0f} ms)"})
            elif r.get("type") == "ckpt_save":
                blk = r.get("block_ms")
                if blk is None and not r.get("async_write"):
                    blk = r.get("ms")  # schema v1 sync save: all blocking
                if blk is not None and float(blk) > blocked_ms:
                    findings.append({
                        "kind": "blocked_ckpt", "step": r.get("step"),
                        "block_ms": round(float(blk), 2),
                        "threshold_ms": blocked_ms,
                        "detail": f"save at step {r.get('step')} blocked "
                                  f"the step path {float(blk):.0f} ms "
                                  f"(> {blocked_ms:.0f} ms)"})

    for stream in _attempts(events):
        if not any(r.get("type") == "run_end" for r in stream):
            att = stream[0].get("attempt", 0) if stream else 0
            last = max((int(r["step"]) for r in stream
                        if r.get("type") == "step"), default=None)
            findings.append({
                "kind": "no_run_end", "attempt": att, "last_step": last,
                "detail": f"attempt {att} never wrote run_end (died or "
                          f"still running); last seen step: {last}"})
            continue
        for end in (r for r in stream if r.get("type") == "run_end"):
            g = end.get("goodput", {})
            wall = float(g.get("wall_s", end.get("wall_s", 0.0)))
            total = sum(float(v) for v in g.get("buckets", {}).values())
            # ``other`` absorbs the remainder, so the partition is exact
            # up to each bucket's rounding to 3 decimals
            tol = max(0.05, 0.001 * len(g.get("buckets", {})) + 0.01)
            if g.get("buckets") and abs(total - wall) > tol:
                att = end.get("attempt", 0)
                findings.append({
                    "kind": "goodput_invariant", "attempt": att,
                    "wall_s": round(wall, 3), "bucket_sum_s": round(total, 3),
                    "detail": f"attempt {att} goodput buckets sum to "
                              f"{total:.3f}s but wall is {wall:.3f}s — "
                              f"bucket accounting violated (delta "
                              f"{total - wall:+.3f}s)"})

    if any(r.get("type") in ("span_open", "span_close", "span_note")
           for r in events):
        from tpuframe_torch.obs import tracing

        findings.extend(tracing.span_anomalies(events))
    return findings


# ---------------------------------------------------------------------------
# Serving latency accounting (the serve_* and router_* events).
# ---------------------------------------------------------------------------

def _pct(sorted_vals: list, q: float) -> float:
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, int(round(q * (len(sorted_vals) - 1))))
    return float(sorted_vals[idx])


def serve_stats(events: list) -> dict | None:
    """TTFT/TPOT percentiles and token throughput from ``serve_*``
    events; None when the log carries no serving traffic (so training
    summaries stay serving-free).  TTFT = arrival to first token (the
    prefill + queueing number); TPOT = per-token decode cadence after
    the first.  tokens/sec/chip divides by the ``serve_summary`` device
    count — the serving analogue of MFU's per-chip normalization."""
    reqs = [r for r in events if r.get("type") == "serve_request"]
    steps = [r for r in events if r.get("type") == "serve_step"]
    summary = next((r for r in reversed(events)
                    if r.get("type") == "serve_summary"), None)
    if not (reqs or steps or summary is not None):
        return None

    ttft = sorted(float(r["ttft_ms"]) for r in reqs
                  if r.get("ttft_ms") is not None)
    tpot = sorted(float(r["tpot_ms"]) for r in reqs
                  if r.get("tpot_ms") is not None)

    tokens_per_s = None
    n_devices = 1
    if summary is not None:
        n_devices = max(1, int(summary.get("n_devices") or 1))
        if summary.get("tokens_per_s") is not None:
            tokens_per_s = float(summary["tokens_per_s"])
    if tokens_per_s is None and steps:
        # No summary (run died mid-serve): reconstruct from the steps.
        toks = sum(int(r.get("produced") or 0) + int(r.get("admitted") or 0)
                   for r in steps)
        wall_s = sum(float(r.get("wall_ms") or 0.0) for r in steps) / 1e3
        tokens_per_s = toks / wall_s if wall_s > 0 else None

    return {
        "requests": len(reqs),
        "steps": len(steps),
        "output_tokens": sum(int(r.get("output_tokens") or 0)
                             for r in reqs),
        "ttft_ms": {q: round(_pct(ttft, v), 3) for q, v in
                    (("p50", 0.5), ("p90", 0.9), ("p99", 0.99))}
        if ttft else None,
        "tpot_ms": {q: round(_pct(tpot, v), 3) for q, v in
                    (("p50", 0.5), ("p90", 0.9), ("p99", 0.99))}
        if tpot else None,
        "tokens_per_s": round(tokens_per_s, 2)
        if tokens_per_s is not None else None,
        "tokens_per_s_per_chip": round(tokens_per_s / n_devices, 2)
        if tokens_per_s is not None else None,
        "n_devices": n_devices,
    }


def fleet_stats(events: list) -> dict | None:
    """Router-level rollup of the fleet's ``router_*`` events; None when
    the log carries no router traffic.  ``lost`` is the fleet contract's
    headline number — admitted minus retired, which a healthy run keeps
    at zero through drain/redispatch — and shed is reported beside it
    because an explicitly shed request is *not* a lost one (it was never
    acknowledged)."""
    done = [r for r in events if r.get("type") == "router_request"]
    admits = sum(1 for r in events if r.get("type") == "router_admit")
    sheds = sum(1 for r in events if r.get("type") == "router_shed")
    drains = [r for r in events if r.get("type") == "router_drain"]
    hedges = sum(1 for r in events if r.get("type") == "router_hedge")
    redispatches = sum(1 for r in events
                       if r.get("type") == "router_redispatch")
    summary = next((r for r in reversed(events)
                    if r.get("type") == "router_summary"), None)
    if not (done or admits or sheds or summary is not None):
        return None

    with_ttft = sorted((r for r in done if r.get("ttft_ms") is not None),
                       key=lambda r: float(r["ttft_ms"]))
    ttft = [float(r["ttft_ms"]) for r in with_ttft]
    # Exemplars: each percentile row links the ACTUAL request at that
    # rank — its trace id (when traced) and rid — so "p99 regressed"
    # becomes "open this trace's waterfall", not a number with no story.
    exemplars = None
    if with_ttft:
        exemplars = {}
        for q, frac in (("p50", 0.5), ("p90", 0.9), ("p99", 0.99)):
            idx = min(len(with_ttft) - 1,
                      int(round(frac * (len(with_ttft) - 1))))
            rec = with_ttft[idx]
            exemplars[q] = {"id": rec.get("id"),
                            "trace": rec.get("trace"),
                            "ttft_ms": round(float(rec["ttft_ms"]), 3)}
    by_replica: dict = {}
    for r in done:
        name = str(r.get("replica"))
        by_replica[name] = by_replica.get(name, 0) + 1

    # Live-rollout accounting: final per-replica weights version
    # and the mixed-version window — first replica on the new version to
    # last replica on it (the boundedness the rollout controller
    # proves).  None when the log carries no rollout traffic.
    versions = None
    ro_steps = [r for r in events if r.get("type") == "rollout_step"]
    ro_done = next((r for r in reversed(events)
                    if r.get("type") == "rollout_done"), None)
    ro_abort = next((r for r in reversed(events)
                     if r.get("type") == "rollout_abort"), None)
    if ro_steps or ro_done or ro_abort:
        by_rep_version: dict = {}
        swap_ts = []
        for r in ro_steps:
            phase = r.get("phase")
            if phase in ("swapped", "relaunched"):
                by_rep_version[str(r.get("replica"))] = r.get("version")
                if r.get("t") is not None:
                    swap_ts.append(float(r["t"]))
            elif phase == "rolled_back":
                by_rep_version[str(r.get("replica"))] = r.get("version")
        versions = {
            "by_replica": dict(sorted(by_rep_version.items())),
            "target": (ro_done or ro_abort or {}).get("version"),
            "mixed_window_s": round(max(swap_ts) - min(swap_ts), 3)
            if len(swap_ts) >= 2 else 0.0,
            "aborted": ro_abort is not None,
            "abort_metric": ro_abort.get("metric") if ro_abort else None,
        }
    return {
        "requests": len(done),
        "admitted": admits,
        "shed": sheds,
        "lost": admits - len(done),
        "hedged": hedges,
        "redispatched": redispatches,
        "drains": [{"replica": r.get("replica"),
                    "reason": r.get("reason")} for r in drains],
        "by_replica": dict(sorted(by_replica.items())),
        "versions": versions,
        "ttft_ms": {q: round(_pct(ttft, v), 3) for q, v in
                    (("p50", 0.5), ("p90", 0.9), ("p99", 0.99))}
        if ttft else None,
        "ttft_exemplars": exemplars,
    }


# ---------------------------------------------------------------------------
# Run comparison: the regression sentry (``python -m tpuframe_torch.obs
# compare``) and the rollout gate.
# ---------------------------------------------------------------------------

# In the units of the metric each guards: a percentage increase for the
# latencies, an absolute drop for the productive share of wall, a relative
# drop for MFU.
DEFAULT_COMPARE_THRESHOLDS = {
    "step_pct": 25.0,        # step-time p50/p90 increase (%)
    "productive_drop": 0.10,  # absolute drop in productive wall fraction
    "mfu_drop": 0.10,        # relative mfu_productive drop (fraction)
    "serve_pct": 25.0,       # serve TTFT/TPOT p90 increase (%)
}


def _compare_metrics(events: list[dict], *,
                     generation: str | None = None) -> dict:
    """The comparable facts of one merged stream, in one flat dict."""
    out: dict = {}
    times = sorted(step_times_ms(events))
    if times:
        out["step_p50_ms"] = _pct(times, 0.5)
        out["step_p90_ms"] = _pct(times, 0.9)
    summary = from_events(events, generation=generation)
    wall = summary.get("wall_s") or 0.0
    if wall > 0:
        out["productive_frac"] = \
            summary["buckets"].get("productive", 0.0) / wall
    if summary.get("mfu_productive") is not None:
        out["mfu_productive"] = summary["mfu_productive"]
    serve = serve_stats(events)
    if serve is not None:
        if serve.get("ttft_ms"):
            out["serve_ttft_p90_ms"] = serve["ttft_ms"]["p90"]
        if serve.get("tpot_ms"):
            out["serve_tpot_p90_ms"] = serve["tpot_ms"]["p90"]
    fleet = fleet_stats(events)
    if fleet is not None and fleet.get("ttft_ms"):
        # end to end: the router's queue wait + the replica's TTFT
        out["router_ttft_p90_ms"] = fleet["ttft_ms"]["p90"]
    return out


def compare_runs(a_events: list[dict], b_events: list[dict], *,
                 thresholds: dict | None = None,
                 generation: str | None = None) -> dict:
    """Diff run B against baseline A on goodput, step time, MFU and the
    serving percentiles.  Returns ``{"metrics": {name: {"a", "b", ...}},
    "regressions": [...], "improvements": [...]}``; a metric takes part
    only when both runs carry it."""
    th = dict(DEFAULT_COMPARE_THRESHOLDS)
    th.update(thresholds or {})
    ma = _compare_metrics(a_events, generation=generation)
    mb = _compare_metrics(b_events, generation=generation)

    # ``pct_increase`` flags B above A by more than threshold %;
    # ``abs_drop``/``rel_drop`` flag B below A (higher is better).
    checks = (
        ("step_p50_ms", "pct_increase", th["step_pct"]),
        ("step_p90_ms", "pct_increase", th["step_pct"]),
        ("productive_frac", "abs_drop", th["productive_drop"]),
        ("mfu_productive", "rel_drop", th["mfu_drop"]),
        ("serve_ttft_p90_ms", "pct_increase", th["serve_pct"]),
        ("serve_tpot_p90_ms", "pct_increase", th["serve_pct"]),
        ("router_ttft_p90_ms", "pct_increase", th["serve_pct"]),
    )
    out: dict = {"metrics": {}, "regressions": [], "improvements": []}
    for name, kind, threshold in checks:
        a, b = ma.get(name), mb.get(name)
        if a is None or b is None:
            continue
        entry = {"metric": name, "a": round(float(a), 4),
                 "b": round(float(b), 4), "threshold": threshold}
        out["metrics"][name] = entry
        if kind == "pct_increase":
            if a <= 0:
                continue
            delta_pct = 100.0 * (b - a) / a
            entry["delta_pct"] = round(delta_pct, 2)
            if delta_pct > threshold:
                entry["detail"] = (f"{name}: {a:.2f} -> {b:.2f} "
                                   f"(+{delta_pct:.1f}% > {threshold:.0f}%)")
                out["regressions"].append(entry)
            elif delta_pct < -threshold:
                out["improvements"].append(entry)
        elif kind == "abs_drop":
            entry["delta"] = round(float(b - a), 4)
            if a - b > threshold:
                entry["detail"] = (f"{name}: {a:.3f} -> {b:.3f} "
                                   f"(dropped {a - b:.3f} > {threshold})")
                out["regressions"].append(entry)
            elif b - a > threshold:
                out["improvements"].append(entry)
        else:  # rel_drop
            if a <= 0:
                continue
            rel = (a - b) / a
            entry["delta_rel"] = round(rel, 4)
            if rel > threshold:
                entry["detail"] = (f"{name}: {a:.4f} -> {b:.4f} "
                                   f"(-{100 * rel:.1f}% > "
                                   f"{100 * threshold:.0f}%)")
                out["regressions"].append(entry)
            elif rel < -threshold:
                out["improvements"].append(entry)
    return out
