"""tpuframe_torch.obs.slo against tpuframe.obs.slo: the spec and window
grammars (errors and their messages included), the env resolution, and
``evaluate``'s burn rates and rc contract on the same streams."""

import random

import pytest

pytest.importorskip("torch")

from tpuframe.obs import slo as jax_slo  # noqa: E402
from tpuframe_torch.obs import slo  # noqa: E402


def _outcome(fn, arg):
    try:
        return ("ok", fn(arg))
    except ValueError as e:
        return ("error", str(e))


def _plain(specs):
    return [(s.metric, s.threshold_ms, s.objective, str(s)) for s in specs]


@pytest.mark.parametrize("text", [
    "ttft<=800ms@99%", "tpot<=50ms@95%", " TTFT <= 12.5 ms @ 99.9 ",
    slo.DEFAULT_SLO, "ttft<=1ms@50%,,tpot<=2ms@90%",
    "ttft<800ms@99%", "latency<=1ms@99%", "ttft<=1ms@0%", "ttft<=1ms@100%",
    "", "ttft<=1ms", ",", "ttft<=1ms@99%,bogus"])
def test_parse_slos_matches_jax(text):
    kind, got = _outcome(slo.parse_slos, text)
    rkind, ref = _outcome(jax_slo.parse_slos, text)
    assert kind == rkind
    if kind == "ok":
        assert _plain(got) == _plain(ref)
    else:
        assert got == ref


@pytest.mark.parametrize("text", [
    "60:14.4,300:6", slo.DEFAULT_WINDOWS, "10:2", "", "60", "a:b",
    "0:1", "60:-1", "60:1:2", " 5 : 0.5 , "])
def test_parse_windows_matches_jax(text):
    assert _outcome(slo.parse_windows, text) == \
        _outcome(jax_slo.parse_windows, text)


def test_defaults_and_env_resolution_match_jax(monkeypatch):
    assert (slo.DEFAULT_SLO, slo.DEFAULT_WINDOWS) == \
        (jax_slo.DEFAULT_SLO, jax_slo.DEFAULT_WINDOWS)
    for env in ({}, {slo.ENV_SLO: "ttft<=5ms@50%", slo.ENV_WINDOWS: "10:2"}):
        monkeypatch.delenv(slo.ENV_SLO, raising=False)
        monkeypatch.delenv(slo.ENV_WINDOWS, raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        assert _plain(slo.resolve_slos()) == _plain(jax_slo.resolve_slos())
        assert slo.resolve_windows() == jax_slo.resolve_windows()


def _rec(etype, t, **fields):
    return {"schema": 2, "type": etype, "t": t, "host": "h-p90", "proc": 90,
            "attempt": 0, **fields}


def _streams():
    rng = random.Random(0)
    mixed = []
    for i in range(300):
        t = 0.5 * i + rng.random()
        mixed.append(_rec("router_request", t, id=i, replica="r0",
                          ttft_ms=rng.choice([10.0, 30.0, 900.0, 2000.0])))
        mixed.append(_rec("serve_request", t, id=i, prompt_tokens=3,
                          output_tokens=4, ttft_ms=5.0,
                          tpot_ms=rng.choice([20.0, 400.0])))
    return {
        "clean": [_rec("router_request", 0.1 * i, id=i, replica="r0",
                       ttft_ms=10.0) for i in range(30)],
        "slow": [_rec("router_request", 0.1 * i, id=i, replica="r0",
                      ttft_ms=500.0) for i in range(30)],
        "spike": [_rec("router_request", 1.0 * i, id=i, replica="r0",
                       ttft_ms=500.0 if i == 7 else 10.0)
                  for i in range(100)],
        "replica_only": [_rec("serve_request", 0.2 * i, id=i,
                              prompt_tokens=3, output_tokens=4,
                              ttft_ms=float(i), tpot_ms=None)
                         for i in range(40)],
        "mixed": mixed,
        "empty": [],
    }


@pytest.mark.parametrize("name", sorted(_streams()))
@pytest.mark.parametrize("specs,windows", [
    ("ttft<=100ms@90%", "60:1"),
    ("ttft<=100ms@99%", "1:60,99:1"),
    (None, None),
    ("ttft<=1500ms@99%,tpot<=300ms@95%", "60:14.4,300:6,3600:1"),
])
def test_evaluate_matches_jax(name, specs, windows):
    stream = _streams()[name]
    port = slo.evaluate(
        stream, None if specs is None else slo.parse_slos(specs),
        None if windows is None else slo.parse_windows(windows))
    ref = jax_slo.evaluate(
        stream, None if specs is None else jax_slo.parse_slos(specs),
        None if windows is None else jax_slo.parse_windows(windows))
    assert port == ref
    if name == "empty":
        assert port["rc"] == 2
    if name == "slow" and specs == "ttft<=100ms@90%":
        assert port["rc"] == 1
        assert port["slos"][0]["windows"][0]["burn"] == pytest.approx(10.0)
