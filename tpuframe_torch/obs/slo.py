"""Tail-latency SLO sentry (counterpart of ``tpuframe/obs/slo.py``):
multi-window burn rates over the event log.

The fleet's latency story so far is descriptive (percentile summaries,
`obs compare`'s pairwise thresholds); this module makes it *normative*:
declared TTFT/TPOT objectives evaluated as error budgets, SRE-style.

Spec grammar (``TPUFRAME_SLO``, comma-separated)::

    ttft<=800ms@99%          # 99% of requests see TTFT <= 800 ms
    tpot<=50ms@95%           # 95% of decode cadences <= 50 ms/token

A sample *violates* when its value exceeds the threshold; the error
budget is ``1 - objective`` (for @99%, 1% of traffic may violate).  The
**burn rate** over a window is ``violation_rate / budget`` — burn 1.0
spends the budget exactly at the sustainable pace, burn 14.4 exhausts a
30-day budget in ~2 days.

Multi-window evaluation (``TPUFRAME_SLO_WINDOWS``, default
``60:14.4,300:6,3600:1``, pairs of ``window_seconds:max_burn``): each
window slides over the sample stream (event wall-clock ``t``) and
records its worst burn.  The per-window factors ARE the policy — short
windows tolerate high burn (a brief spike is not an incident), long
windows demand burn near 1 (a sustained slow bleed is).  An SLO is
breached when ANY window's worst burn exceeds its factor — the classic
fast-burn/slow-burn alert pair generalized to N windows.

TTFT samples come from ``router_request.ttft_ms`` (queue-inclusive, the
number users feel) with ``serve_request`` as the single-replica
fallback; TPOT from ``serve_request.tpot_ms``.

rc contract (the JAX package's ``python -m tpuframe.obs slo``, whose
command line the port has not yet): 0 every SLO met, 1 any breached, 2 no
data.
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass

ENV_SLO = "TPUFRAME_SLO"
ENV_WINDOWS = "TPUFRAME_SLO_WINDOWS"

# The JAX package's defaults, generous CPU-fleet ones; a real deployment
# declares its own via TPUFRAME_SLO.
DEFAULT_SLO = "ttft<=1500ms@99%,tpot<=300ms@95%"
DEFAULT_WINDOWS = "60:14.4,300:6,3600:1"

_SPEC_RE = re.compile(
    r"^\s*(ttft|tpot)\s*<=\s*([0-9]+(?:\.[0-9]+)?)\s*ms\s*"
    r"@\s*([0-9]+(?:\.[0-9]+)?)\s*%?\s*$", re.IGNORECASE)


@dataclass(frozen=True)
class SLO:
    """One declared objective: ``metric <= threshold_ms`` for at least
    ``objective`` (fraction) of samples."""

    metric: str          # "ttft" | "tpot"
    threshold_ms: float
    objective: float     # e.g. 0.99

    def __str__(self) -> str:
        return (f"{self.metric}<={self.threshold_ms:g}ms"
                f"@{100.0 * self.objective:g}%")


def parse_slos(text: str) -> list[SLO]:
    """Parse the comma-separated spec grammar; raises ValueError on any
    malformed clause — a silently-dropped SLO is a sentry that lies."""
    slos: list[SLO] = []
    for clause in str(text).split(","):
        if not clause.strip():
            continue
        m = _SPEC_RE.match(clause)
        if m is None:
            raise ValueError(
                f"bad SLO clause {clause.strip()!r} — want e.g. "
                f"'ttft<=800ms@99%'")
        pct = float(m.group(3))
        if not 0.0 < pct < 100.0:
            raise ValueError(f"SLO objective {pct}% outside (0, 100)")
        slos.append(SLO(metric=m.group(1).lower(),
                        threshold_ms=float(m.group(2)),
                        objective=pct / 100.0))
    if not slos:
        raise ValueError("empty SLO spec")
    return slos


def parse_windows(text: str) -> list[tuple[float, float]]:
    """``"60:14.4,300:6"`` -> ``[(60.0, 14.4), (300.0, 6.0)]``."""
    out: list[tuple[float, float]] = []
    for clause in str(text).split(","):
        if not clause.strip():
            continue
        try:
            w, f = clause.split(":")
            window_s, factor = float(w), float(f)
        except ValueError:
            raise ValueError(
                f"bad SLO window {clause.strip()!r} — want "
                f"'window_seconds:max_burn'") from None
        if window_s <= 0 or factor <= 0:
            raise ValueError(f"SLO window {clause.strip()!r} must be "
                             f"positive")
        out.append((window_s, factor))
    if not out:
        raise ValueError("empty SLO window spec")
    return out


def resolve_slos() -> list[SLO]:
    return parse_slos(os.environ.get(ENV_SLO, "").strip() or DEFAULT_SLO)


def resolve_windows() -> list[tuple[float, float]]:
    return parse_windows(os.environ.get(ENV_WINDOWS, "").strip()
                         or DEFAULT_WINDOWS)


def _samples(events: list, metric: str) -> list[tuple[float, float]]:
    """(wall t, value ms) samples for one metric, time-ordered.  TTFT
    prefers the router's queue-inclusive number; a single-replica log
    with no router falls back to ``serve_request``."""
    out: list[tuple[float, float]] = []
    if metric == "ttft":
        out = [(float(r.get("t") or 0.0), float(r["ttft_ms"]))
               for r in events if r.get("type") == "router_request"
               and r.get("ttft_ms") is not None]
        if not out:
            out = [(float(r.get("t") or 0.0), float(r["ttft_ms"]))
                   for r in events if r.get("type") == "serve_request"
                   and r.get("ttft_ms") is not None]
    elif metric == "tpot":
        out = [(float(r.get("t") or 0.0), float(r["tpot_ms"]))
               for r in events if r.get("type") == "serve_request"
               and r.get("tpot_ms") is not None]
    out.sort(key=lambda s: s[0])
    return out


def _worst_burn(samples: list[tuple[float, float]], threshold_ms: float,
                budget: float, window_s: float) -> tuple[float, int]:
    """Max burn rate over every window anchored at a sample, plus the
    sample count of that worst window.  Two-pointer sweep — O(n)."""
    worst, worst_n = 0.0, 0
    lo = 0
    bad_in = 0
    for hi in range(len(samples)):
        if samples[hi][1] > threshold_ms:
            bad_in += 1
        while samples[hi][0] - samples[lo][0] > window_s:
            if samples[lo][1] > threshold_ms:
                bad_in -= 1
            lo += 1
        n = hi - lo + 1
        burn = (bad_in / n) / budget
        if burn > worst or (burn == worst and n > worst_n):
            worst, worst_n = burn, n
    return worst, worst_n


def evaluate(events: list, slos: list[SLO] | None = None,
             windows: list[tuple[float, float]] | None = None) -> dict:
    """Evaluate every SLO over the stream.  Returns::

        {"rc": 0|1|2, "slos": [{"slo", "metric", "samples",
                                "violations", "breached",
                                "windows": [{"window_s", "max_burn",
                                             "burn", "n", "breached"}]}]}

    rc 2 only when NO declared SLO saw a single sample (an empty log
    must not read as "SLOs met").
    """
    slos = resolve_slos() if slos is None else slos
    windows = resolve_windows() if windows is None else windows
    rows = []
    any_data, any_breach = False, False
    for slo in slos:
        samples = _samples(events, slo.metric)
        budget = max(1.0 - slo.objective, 1e-9)
        row = {"slo": str(slo), "metric": slo.metric,
               "samples": len(samples),
               "violations": sum(1 for _t, v in samples
                                 if v > slo.threshold_ms),
               "breached": None, "windows": []}
        if samples:
            any_data = True
            breached = False
            for window_s, factor in windows:
                burn, n = _worst_burn(samples, slo.threshold_ms,
                                      budget, window_s)
                hit = burn > factor
                breached = breached or hit
                row["windows"].append({
                    "window_s": window_s, "max_burn": factor,
                    "burn": round(burn, 3), "n": n, "breached": hit})
            row["breached"] = breached
            any_breach = any_breach or breached
        rows.append(row)
    rc = 2 if not any_data else (1 if any_breach else 0)
    return {"rc": rc, "slos": rows}
