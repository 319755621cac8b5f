"""``python -m tpuframe_torch.obs``: the offline analyzer over structured
event logs (counterpart of ``python -m tpuframe.obs``, with the same
subcommands, arguments, output and exit codes).

Subcommands (each takes a directory of ``events.<host>.jsonl`` files, or
one file):

  summarize  the merged goodput breakdown (bucket seconds and % of wall),
             the step-time distribution, MFU and HBM use (against the
             card's peaks in ``goodput.PEAKS``; a log of other hardware
             says so instead), remat policy, peak memory, run_end
             counters, and the serving and fleet rollups.
             ``--selfcheck`` instead schema-validates event files (the
             repo's ``docs/samples`` when no directory is given, with the
             compare golden pair and the traced-fleet sample).
  merge      one time-ordered multi-host stream to stdout or ``-o``.
  anomalies  step-time regressions against a rolling median, stalls,
             retry storms, low MFU, attempts with no run_end, steps
             blocked on input or a save beyond ``--blocked-ms``, goodput
             buckets that do not sum to wall, leaked and orphan spans.
             Exits 1 when anything is flagged.
  compare    the regression sentry: run B against baseline A on step-time
             p50/p90, the productive share of wall, MFU and the serving
             TTFT/TPOT p90; exits 1 when B regressed, 2 when the runs
             share no metric.
  trace      per-request waterfalls from the span events, with the
             critical path, and the completeness contract (every admitted
             rid one complete root, no orphan or leaked span, phase sums
             within ``--tol-ms`` of the recorded TTFT).  Exits 1 on any
             trace anomaly.
  slo        declared TTFT/TPOT objectives (``--slo`` / TPUFRAME_SLO)
             with multi-window burn rates (``--windows`` /
             TPUFRAME_SLO_WINDOWS).  Exits 0 met, 1 breached, 2 no data.

Examples::

    python -m tpuframe_torch.obs summarize /runs/r7/events
    python -m tpuframe_torch.obs summarize --selfcheck
    python -m tpuframe_torch.obs anomalies /runs/r7/events --mfu-min 0.3
    python -m tpuframe_torch.obs merge /runs/r7/events -o merged.jsonl
    python -m tpuframe_torch.obs compare /runs/baseline /runs/candidate
    python -m tpuframe_torch.obs trace /runs/fleet/events --slowest 3
    python -m tpuframe_torch.obs slo /runs/fleet/events --slo 'ttft<=800ms@99%'
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from tpuframe_torch.obs import events as events_lib
from tpuframe_torch.obs import goodput as goodput_lib
from tpuframe_torch.obs import slo as slo_lib
from tpuframe_torch.obs import tracing


def _fmt_bytes(n: int) -> str:
    for unit in ("B", "KiB", "MiB", "GiB"):
        if n < 1024 or unit == "GiB":
            return f"{n:.2f} {unit}" if unit != "B" else f"{n} B"
        n /= 1024
    return f"{n:.2f} GiB"


def _load(directory: str) -> list[dict]:
    files = events_lib.event_files(directory)
    if not files:
        print(f"[obs] no events.<host>.jsonl under {directory}",
              file=sys.stderr)
        raise SystemExit(2)
    return events_lib.merge(directory)


def _samples_root() -> str:
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    return os.path.join(root, "docs", "samples")


def _sample_paths() -> list[str]:
    """The repo's sample event files (``docs/samples``), the selfcheck's
    default target.  One run per directory: a subdirectory holds a run of
    its own (``samples/serve/``) that validates but does not merge into
    the training run's attempts."""
    base = _samples_root()
    paths = events_lib.event_files(base)
    try:
        subdirs = sorted(os.listdir(base))
    except (FileNotFoundError, NotADirectoryError):
        subdirs = []
    for name in subdirs:
        sub = os.path.join(base, name)
        if os.path.isdir(sub):
            paths.extend(events_lib.event_files(sub))
    return paths


def _selfcheck_compare() -> list[str]:
    """The regression sentry's golden test: the sample fast/slow pair
    flags a regression, and a run against itself does not."""
    fast = os.path.join(_samples_root(), "compare_fast")
    slow = os.path.join(_samples_root(), "compare_slow")
    if not (events_lib.event_files(fast) and events_lib.event_files(slow)):
        return [f"compare golden pair missing under {_samples_root()} "
                f"(compare_fast/ + compare_slow/)"]
    problems: list[str] = []
    a, b = events_lib.merge(fast), events_lib.merge(slow)
    flagged = goodput_lib.compare_runs(a, b)
    if not flagged["regressions"]:
        problems.append("compare(fast, slow) flagged no regression — the "
                        "sentry is blind")
    clean = goodput_lib.compare_runs(a, a)
    for r in clean["regressions"]:
        problems.append(f"compare(fast, fast) flagged {r['metric']} — "
                        f"the sentry false-positives on identity")
    return problems


def _selfcheck_trace() -> list[str]:
    """The tracing plane's golden test: the traced-fleet sample (a
    two-replica fleet run) reconstructs whole: every admitted rid one
    complete root, no orphan or leak, phase sums matching the TTFT."""
    sample = os.path.join(_samples_root(), "traced_fleet")
    if not events_lib.event_files(sample):
        return [f"traced-fleet golden sample missing under {sample}"]
    merged = events_lib.merge(sample)
    problems = [f"traced_fleet: [{p['kind']}] {p['detail']}"
                for p in tracing.verify_traces(merged)]
    traces = tracing.build_traces(merged)
    if not any(tv.complete_roots() for tv in traces.values()):
        problems.append("traced_fleet: no complete request root "
                        "reconstructed")
    return problems


def cmd_selfcheck(directory: str | None) -> int:
    paths = (events_lib.event_files(directory) if directory
             else _sample_paths())
    if not paths:
        print("[obs] selfcheck: no event files found", file=sys.stderr)
        return 1
    problems = events_lib.validate_files(paths)
    if directory is None:
        # the samples' mode also holds the compare sentry to its golden
        # pair and the trace reconstructor to the traced-fleet sample
        problems += _selfcheck_compare()
        problems += _selfcheck_trace()
    for p in problems:
        print(f"OBS {p}")
    print(f"[obs] selfcheck: {len(paths)} file(s), "
          f"{len(problems)} problem(s)")
    return 1 if problems else 0


def cmd_summarize(directory: str, generation: str | None) -> int:
    merged = _load(directory)
    summary = goodput_lib.from_events(merged, generation=generation)
    hosts = sorted({r.get("host", "?") for r in merged})
    start = next((r for r in merged if r.get("type") == "run_start"), None)

    print(f"run: {len(merged)} events, {len(hosts)} host file(s), "
          f"{summary['attempts']} attempt(s)")
    if start is not None:
        print(f"  config={start.get('config')} "
              f"hash={start.get('config_hash', '')[:12]} "
              f"jax={start.get('jax_version')} "
              f"devices={start.get('devices')} mesh={start.get('mesh')}")

    buckets = summary["buckets"]
    wall = summary["wall_s"] or 1e-9
    print(f"goodput breakdown (wall {summary['wall_s']:.1f}s, "
          f"{summary['steps']} steps, final step "
          f"{summary.get('final_step', 0)}):")
    for name in goodput_lib.BUCKETS:
        sec = buckets.get(name, 0.0)
        print(f"  {name:<11} {sec:9.2f}s  {100.0 * sec / wall:5.1f}%")
    if summary["attempts"] > 1:
        print(f"  restart-lost {summary['restart_lost_s']:.2f}s across "
              f"{summary['attempts']} attempts "
              f"({summary['retrained_steps']} steps retrained)")
    if summary.get("elastic_resizes"):
        print(f"  elastic resizes: "
              f"{', '.join(summary['elastic_transitions'])} devices")

    times = sorted(goodput_lib.step_times_ms(merged))
    if times:
        mean = sum(times) / len(times)
        print(f"step time (ms, {len(times)} post-compile steps): "
              f"mean={mean:.2f} p50={goodput_lib._pct(times, 0.5):.2f} "
              f"p90={goodput_lib._pct(times, 0.9):.2f} max={times[-1]:.2f}")

    for key in ("mfu_productive", "mfu_goodput", "hbm_util_productive"):
        if summary.get(key) is not None:
            print(f"{key}: {summary[key]:.4%}")
    gen = goodput_lib._generation(merged, generation)
    if gen not in goodput_lib.PEAKS:
        print(f"mfu: not computed: no peaks for generation {gen!r} "
              f"(have {', '.join(sorted(goodput_lib.PEAKS))})")
    remat = next((r for r in reversed(merged)
                  if r.get("type") == "remat_policy"), None)
    if remat is not None:
        pred = remat.get("predicted_bytes_per_step")
        pred_s = f", predicted {_fmt_bytes(int(pred))}/step" if pred else ""
        print(f"remat policy: {remat.get('policy')} "
              f"(source: {remat.get('source')}{pred_s})")
    if summary.get("peak_hbm_bytes") is not None:
        print(f"peak HBM per device: "
              f"{_fmt_bytes(summary['peak_hbm_bytes'])}")

    end = next((r for r in reversed(merged)
                if r.get("type") == "run_end"), None)
    if end and end.get("counters"):
        print("counters at run_end:")
        for k, v in sorted(end["counters"].items()):
            print(f"  {k} = {v}")

    serve = goodput_lib.serve_stats(merged)
    if serve is not None:
        print(f"serving: {serve['requests']} request(s), "
              f"{serve['steps']} step(s), "
              f"{serve['output_tokens']} output token(s)")
        for key, label in (("ttft_ms", "TTFT"), ("tpot_ms", "TPOT")):
            pcts = serve[key]
            if pcts:
                print(f"  {label} (ms): " + " ".join(
                    f"{q}={pcts[q]:.2f}" for q in ("p50", "p90", "p99")))
        if serve["tokens_per_s"] is not None:
            print(f"  tokens/s: {serve['tokens_per_s']:.2f} "
                  f"({serve['tokens_per_s_per_chip']:.2f} per chip, "
                  f"{serve['n_devices']} device(s))")

    fleet = goodput_lib.fleet_stats(merged)
    if fleet is not None:
        print(f"fleet: {fleet['requests']}/{fleet['admitted']} admitted "
              f"request(s) retired, {fleet['shed']} shed, "
              f"{fleet['lost']} lost, {fleet['hedged']} hedged, "
              f"{fleet['redispatched']} redispatched")
        if fleet["by_replica"]:
            print("  by replica: " + " ".join(
                f"{k}={v}" for k, v in fleet["by_replica"].items()))
        for d in fleet["drains"]:
            print(f"  drain: {d['replica']} ({d['reason']})")
        if fleet["ttft_ms"]:
            pcts = fleet["ttft_ms"]
            print("  router TTFT (ms): " + " ".join(
                f"{q}={pcts[q]:.2f}" for q in ("p50", "p90", "p99")))
        if fleet.get("ttft_exemplars"):
            # the request behind each percentile row, for ``obs trace``
            for q, ex in fleet["ttft_exemplars"].items():
                tid = ex.get("trace")
                link = f"trace {tid}" if tid else "untraced"
                print(f"  {q} exemplar: rid {ex.get('id')} "
                      f"({ex['ttft_ms']:.2f} ms, {link})")
    return 0


def cmd_merge(directory: str, out: str | None) -> int:
    merged = _load(directory)
    fh = open(out, "w") if out else sys.stdout
    try:
        for rec in merged:
            fh.write(json.dumps(rec) + "\n")
    finally:
        if out:
            fh.close()
            print(f"[obs] merged {len(merged)} events -> {out}",
                  file=sys.stderr)
    return 0


def cmd_anomalies(directory: str, args) -> int:
    merged = _load(directory)
    findings = goodput_lib.find_anomalies(
        merged, slow_factor=args.slow_factor, window=args.window,
        retry_storm=args.retry_storm, mfu_min=args.mfu_min,
        blocked_ms=args.blocked_ms)
    for f in findings:
        print(f"ANOMALY [{f['kind']}] {f['detail']}")
    print(f"[obs] anomalies: {len(findings)} finding(s)")
    return 1 if findings else 0


def cmd_compare(args) -> int:
    a = _load(args.a)
    b = _load(args.b)
    thresholds = {
        "step_pct": args.step_pct,
        "productive_drop": args.prod_drop,
        "mfu_drop": args.mfu_drop,
        "serve_pct": args.serve_pct,
    }
    result = goodput_lib.compare_runs(a, b, thresholds=thresholds,
                                      generation=args.gen)
    if not result["metrics"]:
        print("[obs] compare: no overlapping metrics between the two runs",
              file=sys.stderr)
        return 2
    print(f"compare: baseline={args.a} candidate={args.b}")
    for name, m in sorted(result["metrics"].items()):
        delta = m.get("delta_pct")
        delta_s = (f"{delta:+.1f}%" if delta is not None
                   else f"{m.get('delta', m.get('delta_rel', 0.0)):+.4f}")
        print(f"  {name:<20} A={m['a']:<12.4g} B={m['b']:<12.4g} {delta_s}")
    for r in result["regressions"]:
        print(f"COMPARE-REGRESSION [{r['metric']}] {r['detail']}")
    for r in result["improvements"]:
        print(f"compare-improvement [{r['metric']}] "
              f"{r['a']} -> {r['b']}")
    print(f"[obs] compare: {len(result['regressions'])} regression(s), "
          f"{len(result['improvements'])} improvement(s), "
          f"{len(result['metrics'])} metric(s) compared")
    return 1 if result["regressions"] else 0


def _span_label(sp) -> str:
    fields = dict(sp.opened or {})
    fields.update(sp.closed or {})
    extras = []
    for key in ("replica", "cause", "status", "rid", "tokens"):
        if fields.get(key) is not None:
            extras.append(f"{key}={fields[key]}")
    if fields.get("duplicate"):
        extras.append("duplicate")
    name = sp.name or "?"
    return f"{name}" + (f" [{' '.join(extras)}]" if extras else "")


def _print_trace(tid: str, tv, root) -> None:
    total_ms = root.ms or 0.0
    head = f"trace {tid}"
    if root.closed is not None:
        head += (f": total {total_ms:.2f} ms, "
                 f"ttft {float(root.closed.get('ttft_ms') or 0):.2f} ms")
    else:
        head += ": INCOMPLETE (root never closed)"
    print(head)
    t0 = float((root.opened or {}).get("t") or 0.0)
    width = 40
    for row in tracing.waterfall(root):
        sp = row["span"]
        label = "  " * row["depth"] + _span_label(sp)
        off_ms = 1e3 * max(0.0, float((sp.opened or {}).get("t") or t0)
                           - t0)
        if sp.ms is None:
            print(f"  {label:<36} |{'?' * width}| OPEN "
                  f"(+{off_ms:.1f} ms, never closed)")
            continue
        if total_ms > 0:
            start = int(width * min(1.0, off_ms / total_ms))
            span_w = max(1, int(round(width * min(1.0,
                                                  sp.ms / total_ms))))
            bar = (" " * start + "#" * min(span_w, width - start)
                   ).ljust(width)
        else:
            bar = "#".ljust(width)
        print(f"  {label:<36} |{bar}| {sp.ms:.2f} ms "
              f"(+{off_ms:.1f})")
    for rec in tv.notes:
        print(f"  note: {rec.get('note')} "
              + " ".join(f"{k}={rec[k]}" for k in ("replica", "reason")
                         if rec.get(k) is not None))
    path = tracing.critical_path(root)
    print("  critical path: " + " -> ".join(
        f"{sp.name}({sp.ms:.1f}ms)" if sp.ms is not None
        else f"{sp.name}(open)" for sp in path))


def cmd_trace(args) -> int:
    merged = _load(args.dir)
    traces = tracing.build_traces(merged)
    problems = tracing.verify_traces(merged, tol_ms=args.tol_ms)
    roots = []
    for tid, tv in traces.items():
        for sp in tv.roots:
            if sp.name == "request":
                roots.append((tid, tv, sp))
    complete = [x for x in roots if x[2].complete]
    print(f"traces: {len(traces)} trace(s), {len(roots)} request "
          f"root(s), {len(complete)} complete")
    want_tid = args.trace or getattr(args, "trace_id", None)
    if want_tid is not None:
        selected = [x for x in roots if x[0] == want_tid]
        if not selected:
            print(f"[obs] trace: no trace {want_tid!r} in this stream",
                  file=sys.stderr)
            return 2
    elif args.rid is not None:
        tid = tracing.trace_of(merged, args.rid)
        selected = [x for x in roots if x[0] == tid]
        if not selected:
            print(f"[obs] trace: rid {args.rid} has no trace (unsampled "
                  f"or never admitted)", file=sys.stderr)
            return 2
    else:
        selected = sorted(complete,
                          key=lambda x: -(x[2].ms or 0.0))[:args.slowest]
    for tid, tv, root in selected:
        _print_trace(tid, tv, root)
    for pr in problems:
        print(f"TRACE-ANOMALY [{pr['kind']}] {pr['detail']}")
    print(f"[obs] trace: {len(problems)} anomaly(s)")
    return 1 if problems else 0


def cmd_slo(args) -> int:
    merged = _load(args.dir)
    try:
        slos = (slo_lib.parse_slos(args.slo) if args.slo
                else slo_lib.resolve_slos())
        windows = (slo_lib.parse_windows(args.windows) if args.windows
                   else slo_lib.resolve_windows())
    except ValueError as e:
        print(f"[obs] slo: {e}", file=sys.stderr)
        return 2
    result = slo_lib.evaluate(merged, slos, windows)
    for row in result["slos"]:
        status = ("NO DATA" if row["breached"] is None
                  else "BREACHED" if row["breached"] else "met")
        print(f"SLO {row['slo']}: {status} ({row['samples']} sample(s), "
              f"{row['violations']} violation(s))")
        for w in row["windows"]:
            mark = "BREACH" if w["breached"] else "ok"
            print(f"  window {w['window_s']:g}s: worst burn "
                  f"{w['burn']:.3f} over {w['n']} sample(s) "
                  f"(max {w['max_burn']:g}) {mark}")
    print(f"[obs] slo: rc {result['rc']}")
    return result["rc"]


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="python -m tpuframe_torch.obs",
                                description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    sp = sub.add_parser("summarize", help="goodput/MFU/step-time summary")
    sp.add_argument("dir", nargs="?", default=None,
                    help="directory of events.<host>.jsonl files")
    sp.add_argument("--gen", default=None,
                    help="hardware for the MFU recompute (default: the "
                         "run manifest's, else h100)")
    sp.add_argument("--selfcheck", action="store_true",
                    help="schema-validate event files (the repo's samples "
                         "when no dir given) instead of summarizing")

    mp = sub.add_parser("merge", help="time-ordered multi-host merge")
    mp.add_argument("dir")
    mp.add_argument("-o", "--out", default=None)

    ap = sub.add_parser("anomalies", help="flag suspicious run shapes")
    ap.add_argument("dir")
    ap.add_argument("--slow-factor", type=float, default=3.0,
                    help="step regression threshold vs rolling median")
    ap.add_argument("--window", type=int, default=16,
                    help="rolling-median window (steps)")
    ap.add_argument("--retry-storm", type=int, default=5,
                    help="retries within 60s that count as a storm")
    ap.add_argument("--mfu-min", type=float, default=None,
                    help="flag MFU below this fraction (off by default)")
    ap.add_argument("--blocked-ms", type=float, default=1000.0,
                    help="flag steps blocked on input or checkpoint "
                         "saves beyond this many ms (default 1000)")

    cp = sub.add_parser("compare",
                        help="regression sentry: diff run B vs baseline A")
    cp.add_argument("a", help="baseline run's events directory")
    cp.add_argument("b", help="candidate run's events directory")
    cp.add_argument("--step-pct", type=float,
                    default=goodput_lib.DEFAULT_COMPARE_THRESHOLDS[
                        "step_pct"],
                    help="step-time p50/p90 increase (%%) that regresses")
    cp.add_argument("--prod-drop", type=float,
                    default=goodput_lib.DEFAULT_COMPARE_THRESHOLDS[
                        "productive_drop"],
                    help="absolute productive-fraction drop that regresses")
    cp.add_argument("--mfu-drop", type=float,
                    default=goodput_lib.DEFAULT_COMPARE_THRESHOLDS[
                        "mfu_drop"],
                    help="relative MFU drop (fraction) that regresses")
    cp.add_argument("--serve-pct", type=float,
                    default=goodput_lib.DEFAULT_COMPARE_THRESHOLDS[
                        "serve_pct"],
                    help="serve TTFT/TPOT p90 increase (%%) that regresses")
    cp.add_argument("--gen", default=None,
                    help="hardware for the MFU recompute")

    tp = sub.add_parser("trace",
                        help="per-request waterfalls + completeness "
                             "verification from span events")
    tp.add_argument("dir", help="events directory of a traced fleet run")
    tp.add_argument("trace_id", nargs="?", default=None,
                    help="render this trace id (paste from a summary "
                         "exemplar row); default: the slowest")
    tp.add_argument("--trace", default=None,
                    help="render this trace id (default: the slowest)")
    tp.add_argument("--rid", type=int, default=None,
                    help="render the trace of this router rid")
    tp.add_argument("--slowest", type=int, default=3,
                    help="how many slowest traces to render (default 3)")
    tp.add_argument("--tol-ms", type=float, default=5.0,
                    help="phase-sum vs recorded-TTFT tolerance (ms)")

    lp = sub.add_parser("slo",
                        help="tail-latency SLO sentry (multi-window "
                             "burn rates); rc 0 met / 1 breach / 2 no "
                             "data")
    lp.add_argument("dir", help="events directory to evaluate")
    lp.add_argument("--slo", default=None,
                    help="objectives, e.g. 'ttft<=800ms@99%%,"
                         "tpot<=50ms@95%%' (default: TPUFRAME_SLO or "
                         f"'{slo_lib.DEFAULT_SLO}')")
    lp.add_argument("--windows", default=None,
                    help="window_s:max_burn pairs (default: "
                         "TPUFRAME_SLO_WINDOWS or "
                         f"'{slo_lib.DEFAULT_WINDOWS}')")

    args = p.parse_args(argv)
    if args.cmd == "summarize":
        if args.selfcheck:
            return cmd_selfcheck(args.dir)
        if args.dir is None:
            p.error("summarize needs a directory (or --selfcheck)")
        return cmd_summarize(args.dir, args.gen)
    if args.cmd == "merge":
        return cmd_merge(args.dir, args.out)
    if args.cmd == "compare":
        return cmd_compare(args)
    if args.cmd == "trace":
        return cmd_trace(args)
    if args.cmd == "slo":
        return cmd_slo(args)
    return cmd_anomalies(args.dir, args)


if __name__ == "__main__":
    sys.exit(main())
