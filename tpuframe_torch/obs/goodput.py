"""Goodput accounting (counterpart of ``tpuframe/obs/goodput.py``), so far
its serving half: the percentile helper the scheduler and router share,
and the offline rollups of a serving log (``serve_stats``) and of a
fleet's router log (``fleet_stats``).  The goodput meter, MFU and the
anomaly sweep come with the trainer's run events (ROADMAP.md queue 1,
item 11).

Pure stdlib, as ``obs.events``.
"""

from __future__ import annotations


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
