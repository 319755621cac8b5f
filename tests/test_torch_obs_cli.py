"""The port's offline analyzer (``tpuframe_torch.obs.goodput``'s analysis
half and ``python -m tpuframe_torch.obs``) against the JAX package's, on
every log under ``docs/samples``.

  - ``step_times_ms``, ``from_events``, ``find_anomalies`` and
    ``compare_runs`` give the JAX answers;
  - each CLI subcommand prints the JAX CLI's lines and exits with its code;
  - the one exception is MFU and HBM use: every sample log ran on a TPU
    (``run_start`` names ``v5e``), a generation the port's peak table
    (H100 only) lacks, so the port reports no MFU for them where the JAX
    package reads or computes one against the TPU peak.  The lines that
    differ for that reason are listed by name in ``MFU_LINES``.
"""

import contextlib
import io
import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

from tpuframe.obs import __main__ as jax_cli  # noqa: E402
from tpuframe.obs import events as jax_events  # noqa: E402
from tpuframe.obs import goodput as jax_goodput  # noqa: E402
from tpuframe_torch.obs import __main__ as port_cli  # noqa: E402
from tpuframe_torch.obs import events  # noqa: E402
from tpuframe_torch.obs import goodput  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAMPLES = "docs/samples"
LOGS = [SAMPLES, f"{SAMPLES}/serve", f"{SAMPLES}/traced_fleet",
        f"{SAMPLES}/async_ckpt", f"{SAMPLES}/compare_fast",
        f"{SAMPLES}/compare_slow"]
# the logs whose run_start names the TPU generation v5e
V5E = {SAMPLES, f"{SAMPLES}/async_ckpt", f"{SAMPLES}/compare_fast",
       f"{SAMPLES}/compare_slow"}
MFU_KEYS = ("mfu_productive", "mfu_goodput", "hbm_util_productive")
NO_PEAK = "mfu: not computed: no peaks for generation 'v5e' (have h100)"

# (argv) -> (lines only the JAX CLI prints, lines only the port prints):
# the MFU lines of the v5e logs, and the counts that include them.
MFU_LINES = {
    ("summarize", SAMPLES): (
        ["mfu_productive: 2.5380%", "mfu_goodput: 0.2076%"], [NO_PEAK]),
    ("summarize", f"{SAMPLES}/async_ckpt"): (
        ["mfu_productive: 2.5610%", "mfu_goodput: 0.4568%"], [NO_PEAK]),
    ("summarize", f"{SAMPLES}/compare_fast"): (
        ["mfu_productive: 42.0000%", "mfu_goodput: 3.5000%"], [NO_PEAK]),
    ("summarize", f"{SAMPLES}/compare_slow"): (
        ["mfu_productive: 17.0000%", "mfu_goodput: 2.6600%"], [NO_PEAK]),
    ("compare", f"{SAMPLES}/compare_fast", f"{SAMPLES}/compare_slow"): (
        ["  mfu_productive       A=0.42         B=0.17         +0.5952",
         "COMPARE-REGRESSION [mfu_productive] mfu_productive: 0.4200 -> "
         "0.1700 (-59.5% > 10%)",
         "[obs] compare: 5 regression(s), 0 improvement(s), 6 metric(s) "
         "compared"],
        ["[obs] compare: 4 regression(s), 0 improvement(s), 5 metric(s) "
         "compared"]),
    ("compare", f"{SAMPLES}/compare_fast", f"{SAMPLES}/compare_fast"): (
        ["  mfu_productive       A=0.42         B=0.42         +0.0000",
         "[obs] compare: 0 regression(s), 0 improvement(s), 6 metric(s) "
         "compared"],
        ["[obs] compare: 0 regression(s), 0 improvement(s), 5 metric(s) "
         "compared"]),
    ("compare", f"{SAMPLES}/compare_slow", f"{SAMPLES}/compare_fast",
     "--serve-pct", "5", "--step-pct", "5"): (
        ["  mfu_productive       A=0.17         B=0.42         -1.4706",
         "compare-improvement [mfu_productive] 0.17 -> 0.42",
         "[obs] compare: 0 regression(s), 5 improvement(s), 6 metric(s) "
         "compared"],
        ["[obs] compare: 0 regression(s), 4 improvement(s), 5 metric(s) "
         "compared"]),
    ("compare", SAMPLES, f"{SAMPLES}/async_ckpt"): (
        ["  mfu_productive       A=0.0254       B=0.0256       -0.0091",
         "[obs] compare: 0 regression(s), 0 improvement(s), 4 metric(s) "
         "compared"],
        ["[obs] compare: 0 regression(s), 0 improvement(s), 3 metric(s) "
         "compared"]),
    ("anomalies", SAMPLES, "--mfu-min", "0.5"): (
        ["ANOMALY [low_mfu] MFU 2.54% below threshold 50.00%",
         "[obs] anomalies: 4 finding(s)"],
        ["[obs] anomalies: 3 finding(s)"]),
}

CASES = ([(cmd, log) for cmd in ("summarize", "anomalies", "trace", "slo",
                                 "merge") for log in LOGS]
         + [("compare", f"{SAMPLES}/compare_fast", f"{SAMPLES}/compare_slow"),
            ("compare", f"{SAMPLES}/compare_fast", f"{SAMPLES}/compare_fast"),
            ("compare", SAMPLES, f"{SAMPLES}/async_ckpt"),
            ("compare", f"{SAMPLES}/serve", f"{SAMPLES}/traced_fleet"),
            ("compare", f"{SAMPLES}/compare_slow", f"{SAMPLES}/compare_fast",
             "--serve-pct", "5", "--step-pct", "5"),
            ("summarize", "--selfcheck"),
            ("summarize", "--selfcheck", f"{SAMPLES}/serve"),
            ("anomalies", SAMPLES, "--mfu-min", "0.5"),
            ("anomalies", SAMPLES, "--slow-factor", "1.1", "--window", "4",
             "--blocked-ms", "1"),
            ("trace", f"{SAMPLES}/traced_fleet", "--slowest", "1"),
            ("trace", f"{SAMPLES}/traced_fleet", "--rid", "3"),
            ("trace", f"{SAMPLES}/traced_fleet", "--rid", "999"),
            ("trace", f"{SAMPLES}/traced_fleet", "--tol-ms", "0.001"),
            ("slo", f"{SAMPLES}/traced_fleet", "--slo", "ttft<=5ms@99%"),
            ("slo", f"{SAMPLES}/serve", "--slo", "tpot<=50ms@95%",
             "--windows", "60:2"),
            ("slo", f"{SAMPLES}/serve", "--slo", "nonsense")])


def _run(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            rc = main(list(argv))
        except SystemExit as e:
            rc = e.code
    return rc, out.getvalue().splitlines(), err.getvalue().splitlines()


@pytest.fixture(autouse=True)
def _in_repo(monkeypatch):
    monkeypatch.chdir(REPO)
    for var in ("TPUFRAME_SLO", "TPUFRAME_SLO_WINDOWS"):
        monkeypatch.delenv(var, raising=False)


def _merged(log):
    return events.merge(os.path.join(REPO, log))


# ---------------------------------------------------------------------------
# The analysis functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("log", LOGS)
def test_merge_and_step_times_match_jax(log):
    merged = _merged(log)
    assert merged == jax_events.merge(os.path.join(REPO, log))
    for first in (False, True):
        assert (goodput.step_times_ms(merged, include_first=first)
                == jax_goodput.step_times_ms(merged, include_first=first))


@pytest.mark.parametrize("log", LOGS)
def test_from_events_matches_jax(log):
    merged = _merged(log)
    got, want = goodput.from_events(merged), jax_goodput.from_events(merged)
    if log in V5E:
        assert [k for k in MFU_KEYS if k in want]   # a TPU peak's numbers
        want = {k: v for k, v in want.items() if k not in MFU_KEYS}
    assert not [k for k in MFU_KEYS if k in got]
    assert got == want


@pytest.mark.parametrize("log", LOGS)
@pytest.mark.parametrize("kw", [{}, dict(slow_factor=1.1, window=4,
                                          blocked_ms=1.0, retry_storm=2)])
def test_find_anomalies_matches_jax(log, kw):
    merged = _merged(log)
    assert (goodput.find_anomalies(merged, **kw)
            == jax_goodput.find_anomalies(merged, **kw))


@pytest.mark.parametrize("a,b", [("compare_fast", "compare_slow"),
                                 ("compare_slow", "compare_fast"),
                                 ("compare_fast", "compare_fast"),
                                 ("serve", "traced_fleet")])
def test_compare_runs_matches_jax(a, b):
    ea, eb = _merged(f"{SAMPLES}/{a}"), _merged(f"{SAMPLES}/{b}")
    for th in (None, {"serve_pct": 5.0, "step_pct": 1.0}):
        got = goodput.compare_runs(ea, eb, thresholds=th)
        want = jax_goodput.compare_runs(ea, eb, thresholds=th)
        want["metrics"].pop("mfu_productive", None)
        for key in ("regressions", "improvements"):
            want[key] = [e for e in want[key]
                         if e["metric"] != "mfu_productive"]
        assert got == want
    assert goodput.DEFAULT_COMPARE_THRESHOLDS == \
        jax_goodput.DEFAULT_COMPARE_THRESHOLDS


def test_mfu_against_the_h100_table_only():
    assert goodput.mfu(989e12, 1.0) == 1.0
    assert goodput.mfu(989e12, 0.5, n_devices=4) == 0.5
    assert goodput.hbm_util(3.35e12, 2.0) == 0.5
    assert goodput.mfu(0.0, 1.0) == goodput.hbm_util(1.0, 0.0) == 0.0
    for gen in ("v5e", "v4", "a100"):
        assert goodput.mfu(1e12, 1.0, generation=gen) is None
        assert goodput.hbm_util(1e12, 1.0, generation=gen) is None
    assert goodput.flops_fallback(10, 3, 7) == \
        jax_goodput.flops_fallback(10, 3, 7) == 1260.0
    assert goodput.BUCKETS == jax_goodput.BUCKETS


def test_from_events_recomputes_mfu_for_an_h100_log():
    """A crashed attempt (no run_end) on the card: MFU and HBM use come
    from run_start's cost models over the mean post-compile step."""
    t0 = 100.0
    evs = [{"type": "run_start", "t": t0, "attempt": 0, "devices": 1,
            "generation": "h100", "flops_per_step": 989e12 * 0.25,
            "bytes_per_step": 3.35e12 * 0.1}]
    evs += [{"type": "step", "t": t0 + i, "attempt": 0, "step": i + 1,
             "wall_ms": 1000.0} for i in range(4)]
    got = goodput.from_events(evs)
    assert got["mfu_productive"] == pytest.approx(0.25)
    assert got["hbm_util_productive"] == pytest.approx(0.1)
    assert goodput.from_events(evs, generation="v5e").get(
        "mfu_productive") is None


# ---------------------------------------------------------------------------
# The CLI, line for line
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("argv", CASES, ids=" ".join)
def test_cli_matches_jax(argv):
    rc_j, out_j, err_j = _run(jax_cli.main, argv)
    rc_p, out_p, err_p = _run(port_cli.main, argv)
    assert rc_p == rc_j
    assert err_p == err_j
    jax_only, port_only = MFU_LINES.get(tuple(argv), ([], []))
    assert [x for x in out_j if x not in out_p] == jax_only
    assert [x for x in out_p if x not in out_j] == port_only
    assert ([x for x in out_j if x not in jax_only]
            == [x for x in out_p if x not in port_only])
    assert out_p or err_p


def test_cli_refuses_an_empty_directory_as_jax_does(tmp_path):
    for argv in (("summarize", str(tmp_path)), ("merge", str(tmp_path)),
                 ("compare", str(tmp_path), str(tmp_path))):
        assert _run(port_cli.main, argv) == _run(jax_cli.main, argv)
        assert _run(port_cli.main, argv)[0] == 2


def test_merge_to_a_file(tmp_path):
    got, want = tmp_path / "port.jsonl", tmp_path / "jax.jsonl"
    assert _run(port_cli.main, ("merge", f"{SAMPLES}/traced_fleet", "-o",
                                str(got)))[0] == 0
    assert _run(jax_cli.main, ("merge", f"{SAMPLES}/traced_fleet", "-o",
                               str(want)))[0] == 0
    assert got.read_text() == want.read_text()


def test_validate_files_matches_jax(tmp_path):
    bad = tmp_path / "events.h-p0.jsonl"
    bad.write_text('{"schema": 9, "type": "nope"}\n{"torn\n')
    paths = events.event_files(str(tmp_path)) + events.event_files(
        os.path.join(REPO, SAMPLES, "traced_fleet"))
    assert events.validate_files(paths) == jax_events.validate_files(paths)
    assert events.validate_files(paths)


def test_module_runs_without_jax_in_its_environment():
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX_", "XLA_"))}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run(
        [sys.executable, "-m", "tpuframe_torch.obs", "summarize",
         "--selfcheck"], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.splitlines()[-1].endswith("0 problem(s)")
