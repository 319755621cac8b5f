"""The port's serving fleet (scheduler telemetry, ``serve/replica.py``,
``serve/router.py``, ``LMEngine.swap_params``) against the JAX package's.

  - both ``Scheduler``s with a fake clock over their ``FakeEngine`` emit
    the same ``serve_step``, ``serve_request`` and span records, envelope
    aside, and the same exporter samples;
  - the ``Router`` cases of tests/test_router.py over fake transports end
    with the same counters and the same events as the JAX ``Router``, and
    the JAX package's ``fleet_stats`` reads the port's router events as
    its own;
  - a replica in process: a draining replica answers 503, ``/generate``
    and ``/swap_weights`` refuse what the JAX replica refuses, and a seeded
    swap on the tiny LM swaps the served weights;
  - ``LMEngine.swap_params`` refuses other keys, shapes or dtypes with the
    JAX engine's messages;
  - ``fleet_smoke``: two ``FakeEngine`` replica processes behind the
    router, ``replica_crash`` on rank 1: nothing lost, a drain;
  - the slice as a whole: a tiny-LM replica on the CPU, with the JAX
    engine's weights through ``params_from_jax``, answers ``/generate``
    over HTTP through the router with the JAX ``LMEngine`` + ``Scheduler``
    tokens for the same seeded requests.
"""

import itertools
import json
import re
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from tpuframe.models import transformer_lm as jax_lm  # noqa: E402
from tpuframe.obs import events as jax_events  # noqa: E402
from tpuframe.obs import goodput as jax_goodput  # noqa: E402
from tpuframe.obs import tracing as jax_tracing  # noqa: E402
from tpuframe.resilience.policy import RetryPolicy as JaxRetryPolicy  # noqa: E402,E501
from tpuframe.serve import replica as jax_replica  # noqa: E402
from tpuframe.serve import router as jax_router  # noqa: E402
from tpuframe.serve import scheduler as jax_scheduler  # noqa: E402
from tpuframe.serve.engine import LMEngine as JaxLMEngine  # noqa: E402
from tpuframe_torch.models.convert import params_from_jax  # noqa: E402
from tpuframe_torch.models.transformer_lm import (LMConfig,  # noqa: E402
                                                  TransformerLM)
from tpuframe_torch.obs import events  # noqa: E402
from tpuframe_torch.obs import exporter  # noqa: E402
from tpuframe_torch.obs import goodput  # noqa: E402
from tpuframe_torch.obs import tracing  # noqa: E402
from tpuframe_torch.resilience.policy import RetryPolicy  # noqa: E402
from tpuframe_torch.serve import loadgen  # noqa: E402
from tpuframe_torch.serve import replica as port_replica  # noqa: E402
from tpuframe_torch.serve import router as port_router  # noqa: E402
from tpuframe_torch.serve import scheduler as port_scheduler  # noqa: E402
from tpuframe_torch.serve.engine import LMEngine  # noqa: E402

PKGS = {
    "port": dict(events=events, tracing=tracing, replica=port_replica,
                 router=port_router, scheduler=port_scheduler,
                 policy=RetryPolicy),
    "jax": dict(events=jax_events, tracing=jax_tracing,
                replica=jax_replica, router=jax_router,
                scheduler=jax_scheduler, policy=JaxRetryPolicy),
}
ENVELOPE = ("schema", "t", "host", "proc", "attempt")
BUCKETS = (16, 32)


def _records(ev_mod, directory, *, drop=(), drop_ids=False):
    """The log's records without the envelope and ``drop``; span ids
    renamed in order of appearance (each package counts its own), or
    dropped with ``drop_ids``."""
    names = {}

    def ren(sid):
        if sid is None:
            return None
        return names.setdefault(sid, f"s{len(names)}")

    out = []
    for r in ev_mod.merge(str(directory)):
        rec = {k: v for k, v in r.items()
               if k not in ENVELOPE and k not in drop}
        for key in ("span", "parent"):
            if key in rec:
                rec[key] = None if drop_ids else ren(rec[key])
        out.append(rec)
    return out


# ---------------------------------------------------------------------------
# Scheduler telemetry
# ---------------------------------------------------------------------------

def _scheduler_run(pkg, directory):
    mods = PKGS[pkg]
    tick = itertools.count()
    clock = lambda: 0.001 * next(tick)  # noqa: E731 — a fake clock
    engine = mods["replica"].FakeEngine(slots=2, prompt_buckets=BUCKETS,
                                        eos_id=3)
    mods["events"].init(str(directory))
    try:
        sched = mods["scheduler"].Scheduler(engine, clock=clock)
        for rid in range(6):
            req = mods["scheduler"].Request(
                rid=rid, prompt=[rid + 1] * (4 + 3 * rid),
                max_new_tokens=1 + rid % 4, arrival_t=clock())
            if rid % 3:                        # two of three traced
                req.trace, req.span = f"t{rid}.test", f"serve{rid}"
            sched.submit(req)
            sched.step()
        while sched.has_work():
            sched.step()
        samples = sorted(sched._load_samples() + sched._latency_samples(),
                         key=repr)
    finally:
        mods["events"].close()
    return (_records(mods["events"], directory, drop=("engine_ms",)),
            samples, [(r.rid, r.tokens) for r in sched.completed])


def test_scheduler_telemetry_matches_jax(tmp_path):
    port = _scheduler_run("port", tmp_path / "port")
    ref = _scheduler_run("jax", tmp_path / "jax")
    assert port == ref
    types = [r["type"] for r in port[0]]
    assert types.count("serve_request") == 6
    assert {"serve_step", "span_open", "span_close"} <= set(types)
    spans = [r for r in port[0] if r["type"] == "span_open"]
    assert {r["name"] for r in spans} == {"queue", "prefill", "decode"}


# ---------------------------------------------------------------------------
# Router cases (tests/test_router.py) on both routers
# ---------------------------------------------------------------------------

def _no_sleep_policy(cls, **kw):
    kw.setdefault("max_attempts", 2)
    kw.setdefault("base_delay_s", 0.001)
    kw.setdefault("max_delay_s", 0.001)
    kw.setdefault("attempt_timeout_s", 5.0)
    kw.setdefault("deadline_s", 10.0)
    return cls(sleep=lambda s: None, **kw)


def _ok_reply(url, payload, timeout_s):
    if url.endswith("/generate"):
        return 200, {"rid": payload["rid"], "tokens": [1, 2],
                     "ttft_ms": 1.0}
    if url.endswith("/healthz"):
        return 200, "ok\n"
    return 200, "tpuframe_serve_queue_depth 0\n# EOF\n"


def _drive(r, timeout_s=10.0):
    deadline = time.monotonic() + timeout_s
    while r.has_work() and time.monotonic() < deadline:
        r.step()
        time.sleep(0.002)
    assert not r.has_work(), "router did not converge"


def _wait(pred, timeout_s=5.0, r=None):
    deadline = time.monotonic() + timeout_s
    while not pred() and time.monotonic() < deadline:
        if r is not None:
            r.step()
        time.sleep(0.002)


def _case_shed_and_redispatch(Router, policy):
    def transport(url, payload, timeout_s):
        if "//a" in url and url.endswith("/generate"):
            raise OSError("down")
        return _ok_reply(url, payload, timeout_s)

    r = Router(["http://a", "http://b"], transport=transport, queue_limit=1,
               hedge_ms=0, scrape_interval_s=1e9,
               dispatch_policy=_no_sleep_policy(policy))
    r.submit(0, [1])
    assert not r.submit(1, [1])
    _drive(r)
    r.summary()
    return r


def _case_generate_503(Router, policy):
    def transport(url, payload, timeout_s):
        if "//a" in url and url.endswith("/generate"):
            return 503, {"error": "draining"}
        return _ok_reply(url, payload, timeout_s)

    r = Router(["http://a", "http://b"], transport=transport, hedge_ms=0,
               scrape_interval_s=1e9)
    r.submit(0, [1])
    _drive(r)
    return r


def _case_healthz_503(Router, policy):
    def transport(url, payload, timeout_s):
        if "//a" in url and url.endswith("/healthz"):
            return 503, "unhealthy\n"
        return _ok_reply(url, payload, timeout_s)

    r = Router(["http://a", "http://b"], transport=transport,
               scrape_interval_s=0.0)
    r._scrape_due(r._clock())
    return r


def _case_scrape_timeout(Router, policy):
    def transport(url, payload, timeout_s):
        if "//a" in url:
            raise OSError("timed out")
        return _ok_reply(url, payload, timeout_s)

    r = Router(["http://a", "http://b"], transport=transport,
               scrape_interval_s=0.0,
               scrape_policy=_no_sleep_policy(policy))
    r._scrape_due(r._clock())
    return r


def _case_all_down(Router, policy):
    def transport(url, payload, timeout_s):
        raise OSError("down")

    r = Router(["http://a"], transport=transport, hedge_ms=0,
               scrape_interval_s=1e9, dispatch_policy=_no_sleep_policy(policy))
    r.submit(0, [1])
    _wait(lambda: r.counters["drains"] >= 1, r=r)
    r.step()
    assert r.has_work() and len(r.pending) == 1
    assert r.summary()["lost"] == 1
    return r


def _case_hedge(Router, policy):
    release = threading.Event()

    def transport(url, payload, timeout_s):
        if url.endswith("/generate") and "//a" in url:
            release.wait(5.0)
            return 200, {"rid": payload["rid"], "tokens": [9],
                         "ttft_ms": 99.0}
        return _ok_reply(url, payload, timeout_s)

    r = Router(["http://a", "http://b"], transport=transport, hedge_ms=30.0,
               scrape_interval_s=1e9)
    r.submit(0, [1])
    _drive(r)
    assert r.completed[0].result["tokens"] == [1, 2]
    release.set()
    _wait(lambda: r.counters["duplicates"] >= 1, r=r)
    return r


def _case_spread(Router, policy):
    seen, hold = [], threading.Event()

    def transport(url, payload, timeout_s):
        if url.endswith("/generate"):
            seen.append(url.rsplit("/", 1)[0])
            hold.wait(5.0)
        return _ok_reply(url, payload, timeout_s)

    r = Router(["http://a", "http://b"], queue_limit=8, transport=transport,
               hedge_ms=0, scrape_interval_s=1e9)
    r.submit(0, [1])
    r.submit(1, [1])
    r.step()
    _wait(lambda: len(seen) >= 2)
    assert sorted(seen) == ["http://a", "http://b"]
    hold.set()
    _drive(r)
    return r


def _case_queue_depth_ties(Router, policy):
    def transport(url, payload, timeout_s):
        if url.endswith("/metrics"):
            depth = 5 if "//a" in url else 0
            return 200, (f"tpuframe_serve_queue_depth {depth}\n"
                         f"tpuframe_weights_version 3\n# EOF\n")
        return _ok_reply(url, payload, timeout_s)

    r = Router(["http://a", "http://b"], transport=transport,
               scrape_interval_s=0.0, hedge_ms=0)
    r._scrape_due(r._clock())
    assert r._replica("r0").queue_depth == 5.0
    assert r._pick().name == "r1"
    r.submit(0, [1])
    _drive(r)
    return r


def _case_inflight_bound(Router, policy):
    hold = threading.Event()

    def transport(url, payload, timeout_s):
        if url.endswith("/generate"):
            hold.wait(5.0)
        return _ok_reply(url, payload, timeout_s)

    r = Router(["http://a"], queue_limit=1, transport=transport, hedge_ms=0)
    assert r.submit(0, [1])
    r.step()
    assert not r.submit(1, [1])
    hold.set()
    _drive(r)
    return r


def _case_no_hedge(Router, policy):
    hold = threading.Event()

    def transport(url, payload, timeout_s):
        if url.endswith("/generate"):
            hold.wait(0.2)
        return _ok_reply(url, payload, timeout_s)

    r = Router(["http://a"], transport=transport, hedge_ms=10.0)
    r.submit(0, [1])
    _drive(r)
    r2 = Router(["http://a", "http://b"], transport=_ok_reply, hedge_ms=0)
    r2.submit(1, [1])
    _drive(r2)
    assert r.counters["hedged"] == r2.counters["hedged"] == 0
    return r


def _case_sampled_out(Router, policy):
    r = Router(["http://a"], transport=_ok_reply, hedge_ms=0,
               scrape_interval_s=1e9)
    r.submit(0, [1])
    _drive(r)
    assert r.completed[0].trace is None
    return r


CASES = {"shed_and_redispatch": _case_shed_and_redispatch,
         "generate_503": _case_generate_503, "healthz_503": _case_healthz_503,
         "scrape_timeout": _case_scrape_timeout, "all_down": _case_all_down,
         "hedge": _case_hedge, "spread": _case_spread,
         "queue_depth_ties": _case_queue_depth_ties,
         "inflight_bound": _case_inflight_bound, "no_hedge": _case_no_hedge,
         "sampled_out": _case_sampled_out}
# timings
VOLATILE = ("ms", "ttft_ms", "wait_ms", "tpot_ms", "wall_ms", "engine_ms",
            "ttft_p50_ms", "ttft_p90_ms", "ttft_p99_ms")


def _router_case(pkg, case, directory, monkeypatch):
    mods = PKGS[pkg]
    monkeypatch.setenv(tracing.ENV_SAMPLE,
                       "0" if case == "sampled_out" else "1")
    mods["events"].init(str(directory))
    try:
        r = CASES[case](mods["router"].Router, mods["policy"])
    finally:
        mods["events"].close()
    recs = _records(mods["events"], directory, drop=VOLATILE, drop_ids=True)
    summary = {k: v for k, v in r.summary().items() if k != "ttft_ms"}
    return (dict(r.counters), summary,
            sorted(json.dumps(x, sort_keys=True) for x in recs),
            sorted((q.rid, q.replica, q.attempts, json.dumps(q.result))
                   for q in r.completed),
            [(rep.name, rep.state, rep.version) for rep in r.replicas])


@pytest.mark.parametrize("case", sorted(CASES))
def test_router_case_matches_jax(case, tmp_path, monkeypatch):
    port = _router_case("port", case, tmp_path / "port", monkeypatch)
    ref = _router_case("jax", case, tmp_path / "jax", monkeypatch)
    assert port == ref
    stream = events.merge(str(tmp_path / "port"))
    for r in stream:
        assert events.validate_record(r) == []
        assert jax_events.validate_record(r) == []
    # the JAX package's offline fleet rollup reads the port's events, and
    # the port's rollup gives its answers
    fleet = jax_goodput.fleet_stats(stream)
    assert fleet == goodput.fleet_stats(stream)
    if fleet is not None:
        ref_fleet = jax_goodput.fleet_stats(
            jax_events.merge(str(tmp_path / "jax")))
        for key in ("requests", "admitted", "shed", "lost", "hedged",
                    "redispatched", "drains", "by_replica"):
            assert fleet[key] == ref_fleet[key], key
    if case == "shed_and_redispatch":
        assert fleet["shed"] == 1 and fleet["redispatched"] == 1
        assert fleet["drains"] == [{"replica": "r0",
                                    "reason": "dispatch OSError"}]


def test_router_ttft_includes_queue_wait():
    hold = threading.Event()

    def transport(url, payload, timeout_s):
        if url.endswith("/generate") and payload["rid"] == 0:
            hold.wait(5.0)
        return _ok_reply(url, payload, timeout_s)

    r = port_router.Router(["http://a"], transport=transport, hedge_ms=0,
                           max_inflight_per_replica=1, scrape_interval_s=1e9)
    r.submit(0, [1])
    r.submit(1, [1])
    r.step()
    time.sleep(0.1)
    hold.set()
    _drive(r)
    later = next(q for q in r.completed if q.rid == 1)
    assert later.ttft_ms >= 100.0
    assert r._clock is time.monotonic
    assert port_scheduler.Scheduler(port_replica.FakeEngine())._clock \
        is time.monotonic


def test_env_resolvers_and_parse_gauges_match_jax(monkeypatch):
    for env in ({}, {"TPUFRAME_ROUTER_QUEUE": "7", "TPUFRAME_HEDGE_MS": "250",
                     "TPUFRAME_ROUTER_REPLICAS": "5"},
                {"TPUFRAME_ROUTER_QUEUE": "junk", "TPUFRAME_HEDGE_MS": "-1",
                 "TPUFRAME_ROUTER_REPLICAS": "0"}):
        for var in ("TPUFRAME_ROUTER_QUEUE", "TPUFRAME_HEDGE_MS",
                    "TPUFRAME_ROUTER_REPLICAS"):
            monkeypatch.delenv(var, raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        for fn in ("resolve_queue_limit", "resolve_hedge_ms",
                   "resolve_replicas"):
            assert getattr(port_router, fn)() == getattr(jax_router, fn)()
    text = ("# TYPE tpuframe_serve_queue_depth gauge\n"
            "tpuframe_serve_queue_depth 3\ntpuframe_serve_active_slots 2\n"
            'labelled{k="v"} 1\nbroken x\nother_metric 9\n# EOF\n')
    names = ("tpuframe_serve_queue_depth", "tpuframe_serve_active_slots",
             "broken", "labelled")
    assert port_router.parse_gauges(text, names) == \
        jax_router.parse_gauges(text, names) == {
            "tpuframe_serve_queue_depth": 3.0,
            "tpuframe_serve_active_slots": 2.0}


def test_http_transport_returns_http_errors_as_answers():
    ex = exporter.MetricsExporter(port=0).start()
    try:
        ex.add_handler("/gen", lambda body: (
            200, json.dumps({"echo": json.loads(body)["x"]}).encode()))
        base = f"http://127.0.0.1:{ex.port}"
        for mod in (port_router, jax_router):
            assert mod.http_transport(f"{base}/gen", {"x": 5}, 2.0) == \
                (200, {"echo": 5})
            assert mod.http_transport(f"{base}/missing", {"x": 1},
                                      2.0)[0] == 404
            assert mod.http_transport(f"{base}/healthz", None, 2.0) == \
                (200, "ok\n")
    finally:
        ex.stop()


def test_router_check_is_clean():
    assert port_router.check() == []
    assert port_router.ROUTER_EVENT_TYPES == jax_router.ROUTER_EVENT_TYPES


# ---------------------------------------------------------------------------
# A replica in process
# ---------------------------------------------------------------------------

def _replica_session(pkg):
    mods = PKGS[pkg]
    rep = mods["replica"].Replica(mods["replica"].FakeEngine(slots=2),
                                  handler_timeout_s=10.0, weights_version=1)
    pump = threading.Thread(target=rep.run, kwargs=dict(max_idle_s=30.0),
                            daemon=True)
    pump.start()
    calls = [
        ("gen", b"not json"), ("gen", json.dumps({"prompt": [1]}).encode()),
        ("gen", json.dumps({"rid": 1, "prompt": []}).encode()),
        ("gen", json.dumps({"rid": 1, "prompt": [1] * 33}).encode()),
        ("gen", json.dumps({"rid": 2, "prompt": [4, 5, 6],
                            "max_new_tokens": 4}).encode()),
        ("swap", b"{}"), ("swap", json.dumps({"version": "x"}).encode()),
        ("swap", json.dumps({"version": 3}).encode()),
        ("swap", json.dumps({"version": 4, "seed": 1}).encode()),
    ]
    out = []
    try:
        for kind, body in calls:
            fn = rep.handle_generate if kind == "gen" else rep.handle_swap
            status, raw = fn(body)
            msg = json.loads(raw.decode())
            if status == 200 and kind == "gen":
                msg = {k: msg[k] for k in ("rid", "tokens", "proc")}
            elif status != 200:
                msg = sorted(msg)          # error texts name each class
            out.append((kind, status, msg))
        out.append(("healthy", rep.healthy(), rep.weights_version))
        rep.drain()
        out.append(("gen", *rep.handle_generate(json.dumps(
            {"rid": 9, "prompt": [1]}).encode())))
        out.append(("healthy", rep.healthy(), rep.draining))
    finally:
        rep.drain()
        pump.join(10.0)
    assert not pump.is_alive()
    out.append(("version", rep._version_sample()))
    return out


def test_replica_in_process_matches_jax(monkeypatch):
    monkeypatch.delenv("TPUFRAME_METRICS_PORT", raising=False)
    monkeypatch.delenv("TPUFRAME_METRICS_TEXTFILE", raising=False)
    monkeypatch.delenv("TPUFRAME_PROCESS_ID", raising=False)
    port = _replica_session("port")
    assert port == _replica_session("jax")
    statuses = [s for kind, s, *_ in port if kind in ("gen", "swap")]
    assert statuses == [400, 400, 400, 400, 200, 400, 400, 200, 500, 503]
    assert port[4][2]["tokens"] and port[7][2] == {
        "version": 3, "compile_cache_misses": 0}


def test_seeded_swap_on_the_tiny_lm_replica():
    engine = LMEngine(LMConfig.tiny(), slots=2, prompt_buckets=BUCKETS,
                      decode_block=16, max_context=64, device="cpu")
    rep = port_replica.Replica(engine, handler_timeout_s=30.0)
    pump = threading.Thread(target=rep.run, kwargs=dict(max_idle_s=30.0),
                            daemon=True)
    pump.start()
    try:
        before = [v.clone() for v in engine.model.state_dict().values()]
        status, body = rep.handle_swap(json.dumps(
            {"version": 5, "seed": 7}).encode())
        assert (status, json.loads(body)) == (
            200, {"version": 5, "compile_cache_misses": 0})
        want = LMEngine(LMConfig.tiny(), slots=2, prompt_buckets=BUCKETS,
                        decode_block=16, max_context=64, device="cpu",
                        seed=7).model.state_dict()
        got = engine.model.state_dict()
        assert all(torch.equal(got[k], want[k]) for k in want)
        assert not all(torch.equal(a, b) for a, b in zip(before,
                                                         got.values()))
        status, body = rep.handle_generate(json.dumps(
            {"rid": 0, "prompt": [1, 2, 3], "max_new_tokens": 3}).encode())
        assert status == 200 and len(json.loads(body)["tokens"]) == 3
        assert rep._version_sample() == [("tpuframe_weights_version", {},
                                          5.0)]
    finally:
        rep.drain()
        pump.join(30.0)


@pytest.fixture(scope="module")
def jax_engine():
    return JaxLMEngine(jax_lm.LMConfig.tiny(), slots=2,
                       prompt_buckets=BUCKETS, decode_block=16,
                       max_context=max(BUCKETS) + 32, seed=0,
                       enable_persistent_cache=False)


def _port_engine(jax_engine, **kw):
    params = params_from_jax(jax.tree.map(np.asarray, jax_engine.params))
    return LMEngine(LMConfig.tiny(), params, slots=2, prompt_buckets=BUCKETS,
                    decode_block=16, max_context=max(BUCKETS) + 32,
                    device="cpu", **kw)


def test_swap_params_refusals_match_jax(jax_engine):
    port = _port_engine(jax_engine)
    good = TransformerLM(port.cfg, device="cpu", seed=3).state_dict()

    def refusal(engine, params):
        with pytest.raises(ValueError) as e:
            engine.swap_params(params)
        return str(e.value)

    jparams = jax_engine.params
    leaves, treedef = jax.tree.flatten(jparams)
    missing = dict(good)
    missing.pop(next(iter(missing)))
    assert refusal(port, missing) == refusal(
        jax_engine, {"other": jparams})
    leaf_msg = re.compile(
        r"^swap_params: leaf \d+ is \(.*\)/(float32|bfloat16), engine "
        r"compiled for \(.*\)/float32 — a shape-changing update needs a "
        r"new engine, not a hot swap$")
    for bad in ("shape", "dtype"):
        key = "lm_head.weight"
        port_bad = dict(good)
        port_bad[key] = (good[key][:1] if bad == "shape"
                         else good[key].to(torch.bfloat16))
        jax_bad = list(leaves)
        jax_bad[-1] = (jax_bad[-1][:1] if bad == "shape"
                       else jax_bad[-1].astype("bfloat16"))
        got = refusal(port, port_bad)
        want = refusal(jax_engine, jax.tree.unflatten(treedef, jax_bad))
        assert leaf_msg.match(got) and leaf_msg.match(want), (got, want)
    port.swap_params(good)                     # the right shape is taken


def test_fleet_smoke_crash_loses_nothing(tmp_path):
    out = port_router.fleet_smoke(replicas=2, n_requests=12, kill_rank=1,
                                  events_dir=str(tmp_path), timeout_s=60.0)
    assert out["lost"] == 0 and out["requests"] == 12
    assert out["drains"] >= 1 and not out["timed_out"]
    assert out["exit_codes"] == [0, 42]
    merged = events.merge(str(tmp_path))
    procs = {r["proc"] for r in merged}
    assert procs == {0, 1, 92}                 # one file a process
    crash = [r for r in merged if r["type"] == "fault_injected"]
    assert [(r["proc"], r["seam"]) for r in crash] == [(1, "replica_crash")]
    assert jax_goodput.fleet_stats(merged)["lost"] == 0


# ---------------------------------------------------------------------------
# The slice as a whole
# ---------------------------------------------------------------------------

def test_tiny_lm_replica_answers_with_jax_tokens(jax_engine, monkeypatch,
                                                 tmp_path):
    reqs = loadgen.synthetic_requests(8, buckets=BUCKETS, vocab_size=512,
                                      max_new_tokens=6, seed=0, rate=50.0)
    sched = jax_scheduler.Scheduler(jax_engine)
    jax_engine.reset()
    for r in reqs:
        sched.submit(jax_scheduler.Request(rid=r.rid, prompt=list(r.prompt),
                                           max_new_tokens=r.max_new_tokens))
    while sched.has_work():
        sched.step()
    want = {r.rid: [int(t) for t in r.tokens] for r in sched.completed}

    monkeypatch.setenv("TPUFRAME_METRICS_PORT", "0")
    monkeypatch.setenv(tracing.ENV_SAMPLE, "1")
    exporter.stop()
    open_before = tracing.open_span_count()   # earlier cases' leftovers
    events.init(str(tmp_path))
    rep = port_replica.Replica(_port_engine(jax_engine),
                               handler_timeout_s=60.0)
    pump = threading.Thread(target=rep.run, kwargs=dict(max_idle_s=60.0),
                            daemon=True)
    pump.start()
    try:
        r = port_router.Router([f"http://127.0.0.1:{rep.exporter.port}"],
                               hedge_ms=0, scrape_interval_s=0.05)
        out = r.run(reqs, timeout_s=60.0)
        scrape = port_router.http_transport(
            f"http://127.0.0.1:{rep.exporter.port}/metrics", None, 5.0)[1]
    finally:
        rep.drain()
        pump.join(30.0)
        exporter.stop()
        events.close()
    assert out["lost"] == 0 and out["requests"] == len(reqs)
    got = {q.rid: q.result["tokens"] for q in r.completed}
    assert got == want
    assert "tpuframe_serve_queue_depth 0" in scrape
    assert f"tpuframe_open_spans {open_before}\n" in scrape
    merged = events.merge(str(tmp_path))
    assert tracing.verify_traces(merged) == []
    assert jax_tracing.verify_traces(merged) == []
