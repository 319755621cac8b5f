"""The port's live weight rollout (``tpuframe_torch.serve.rollout``)
against the JAX package's (``tpuframe.serve.rollout``).

  - ``gate_compare`` gives the JAX rc and metrics on the same events;
  - the env knobs resolve as the JAX ones do;
  - on the in-process ``_SimFleet``, the port's controller runs the JAX
    controller's roll: the same ``(replica, phase)`` history, final state,
    abort metric, swaps and versions, clean, poisoned, with the gate off,
    and on one replica; a starved gate rolls back; the watch stays blind
    to a checkpoint mid-commit, torn or quarantined;
  - ``check() == []``;
  - a replica applies a swap only with no accepted request in its hands:
    the drain's idle probe misses a request in its prefill, and the JAX
    replica then decodes that request on both versions (ROADMAP.md queue
    3);
  - ``rolling_update_smoke`` over ``FakeEngine`` replica processes: a clean
    roll loses nothing, ignoring a manifest-only checkpoint until its
    COMMIT lands; a slow canary is rolled back; a replica killed mid-swap
    is relaunched on the new version.  No case bounds a latency: the
    processes share this host's cores.
"""

import json
import threading
import time

import pytest

torch = pytest.importorskip("torch")

from tpuframe.serve import replica as jax_replica  # noqa: E402
from tpuframe.serve import rollout as jax_rollout  # noqa: E402
from tpuframe.serve.router import Router as JaxRouter  # noqa: E402
from tpuframe_torch.obs import events  # noqa: E402
from tpuframe_torch.obs import goodput  # noqa: E402
from tpuframe_torch.obs import tracing  # noqa: E402
from tpuframe_torch.serve import replica as port_replica  # noqa: E402
from tpuframe_torch.serve import rollout  # noqa: E402
from tpuframe_torch.serve.router import Router  # noqa: E402

PKGS = {"port": (rollout, Router), "jax": (jax_rollout, JaxRouter)}


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for k in (rollout.ENV_WATCH, rollout.ENV_CANARY_FRAC, rollout.ENV_GATE):
        monkeypatch.delenv(k, raising=False)
    events.close()
    yield
    events.close()


def _reqs(replica, ttft, tpot, n=8):
    return ([{"type": "router_request", "id": i, "replica": replica,
              "ttft_ms": ttft} for i in range(n)]
            + [{"type": "serve_request", "id": i, "ttft_ms": ttft,
                "tpot_ms": tpot, "output_tokens": 4} for i in range(n)])


# ---------------------------------------------------------------------------
# The gate and the knobs
# ---------------------------------------------------------------------------

GATE_CASES = [
    (_reqs("r1", 10.0, 2.0), _reqs("r0", 10.5, 2.1), 25.0),
    (_reqs("r1", 10.0, 2.0), _reqs("r0", 40.0, 2.0), 25.0),
    (_reqs("r1", 10.0, 2.0), _reqs("r0", 10.0, 9.0), 100.0),
    (_reqs("r1", 10.0, 2.0), [], 25.0),
    ([], _reqs("r0", 10.0, 2.0), 25.0),
    ([{"type": "router_request", "id": i, "replica": "r1", "ttft_ms": 10.0}
      for i in range(8)], _reqs("r0", 10.0, 99.0), 25.0),
    (_reqs("r1", 10.0, 2.0, n=3), _reqs("r0", 5.0, 1.0, n=5), 10.0),
]


@pytest.mark.parametrize("case", range(len(GATE_CASES)))
def test_gate_compare_matches_jax(case):
    base, canary, pct = GATE_CASES[case]
    got = rollout.gate_compare(base, canary, pct=pct)
    assert got == jax_rollout.gate_compare(base, canary, pct=pct)
    assert got[0] == [0, 1, 1, 2, 2, 0, 0][case]
    assert rollout.GATE_METRICS == jax_rollout.GATE_METRICS
    assert rollout.ROLLOUT_EVENT_TYPES == jax_rollout.ROLLOUT_EVENT_TYPES
    for etype in rollout.ROLLOUT_EVENT_TYPES:
        assert etype in events.REQUIRED_FIELDS


@pytest.mark.parametrize("frac,gate,watch", [
    (None, None, None), ("0.5", "10", "/ck/dir"), ("junk", "-3", "  "),
    ("7", "abc", "/x"), ("-1", "0", None)])
def test_env_knobs_resolve_as_jax(monkeypatch, frac, gate, watch):
    for var, val in ((rollout.ENV_CANARY_FRAC, frac),
                     (rollout.ENV_GATE, gate), (rollout.ENV_WATCH, watch)):
        if val is None:
            monkeypatch.delenv(var, raising=False)
        else:
            monkeypatch.setenv(var, val)
    for fn in ("resolve_canary_frac", "resolve_gate_pct",
               "resolve_watch_dir"):
        assert getattr(rollout, fn)() == getattr(jax_rollout, fn)()
    assert (rollout.DEFAULT_CANARY_FRAC, rollout.DEFAULT_GATE_PCT) == (
        jax_rollout.DEFAULT_CANARY_FRAC, jax_rollout.DEFAULT_GATE_PCT)


# ---------------------------------------------------------------------------
# The controller on the simulated fleet
# ---------------------------------------------------------------------------

def _sim(pkg, *, n=3, poisoned_ttft_ms=None, gate_pct=50.0,
         canary_frac=0.5, fleet=None):
    """``_drive_sim_rollout`` of either package, both on the port's
    virtual clock (1 µs a loop): on the wall clock a loaded host's queue
    waits reach the gate's router TTFT, and the JAX helper's clean roll
    can then abort.  ``fleet`` replaces the package's ``_SimFleet``."""
    mod, router_cls = PKGS[pkg]
    now = [0.0]
    if fleet is None:
        fleet = mod._SimFleet(n, poisoned_ttft_ms=poisoned_ttft_ms)
    router = router_cls(list(fleet.reps), transport=fleet.transport,
                        queue_limit=10_000, hedge_ms=0.0,
                        scrape_interval_s=0.0, scrape_timeout_s=0.2,
                        dispatch_timeout_s=2.0, max_inflight_per_replica=4,
                        clock=lambda: now[0])
    ctl = mod.RolloutController(
        router, transport=fleet.transport, clock=lambda: now[0],
        current_version=0, canary_frac=canary_frac, gate_pct=gate_pct,
        bake_min_samples=4, bake_timeout_s=5.0, drain_timeout_s=2.0,
        swap_timeout_s=1.0, relaunch_timeout_s=2.0, poll_interval_s=0.0,
        seed=0)
    ctl.start(1)
    rid = 0
    for _ in range(20000):
        if rid < 4000 and len(router.pending) < 8:
            router.submit(rid, [1, 2, 3])
            rid += 1
        router.step()
        ctl.tick()
        if ctl.done() and not router.has_work():
            break
        now[0] += 1e-6
        time.sleep(0.0005)
    return {"history": [(rep, phase) for _t, rep, phase in ctl.history],
            "state": ctl.state, "abort_metric": ctl.abort_metric,
            "version": ctl.current_version, "target": ctl.target,
            "misses": ctl.swap_compile_misses,
            "versions": {url: rep["version"]
                         for url, rep in fleet.reps.items()},
            "swaps": fleet.swaps,
            "lost": router.counters["admitted"]
            - router.counters["completed"]}


SIM_CASES = [dict(gate_pct=50.0), dict(poisoned_ttft_ms=500.0, gate_pct=50.0),
             dict(gate_pct=0.0), dict(n=1, gate_pct=50.0),
             dict(n=2, gate_pct=50.0), dict(canary_frac=0.0, gate_pct=50.0)]


@pytest.mark.parametrize("kw", SIM_CASES, ids=str)
def test_sim_rollout_matches_jax(kw):
    got = _sim("port", **kw)
    assert got == _sim("jax", **kw)
    assert got["lost"] == 0 and got["misses"] == 0
    poisoned = "poisoned_ttft_ms" in kw
    assert got["state"] == ("aborted" if poisoned else "done")
    assert set(got["versions"].values()) == {0 if poisoned else 1}
    if poisoned:
        assert got["abort_metric"] in rollout.GATE_METRICS
        assert got["history"][-1] == ("r0", "rolled_back")



def test_starved_gate_rolls_back_as_jax_does():
    def run(pkg):
        mod, router_cls = PKGS[pkg]
        fleet = mod._SimFleet(2)
        router = router_cls(list(fleet.reps), transport=fleet.transport,
                            scrape_interval_s=0.0, hedge_ms=0.0)
        clock = [0.0]
        ctl = mod.RolloutController(
            router, transport=fleet.transport, clock=lambda: clock[0],
            current_version=0, canary_frac=0.5, gate_pct=25.0,
            bake_min_samples=5, bake_timeout_s=1.0, drain_timeout_s=10.0,
            poll_interval_s=0.0)
        ctl.start(1)
        for _ in range(50):
            if ctl.state == "bake":
                break
            clock[0] += 0.01
            ctl.tick()
        clock[0] += 5.0        # the bake's deadline passes with no traffic
        for _ in range(20):
            ctl.tick()
            if ctl.done():
                break
        return (ctl.state, ctl.abort_metric, [(r, p) for _t, r, p in
                                              ctl.history], fleet.swaps)

    got = run("port")
    assert got == run("jax")
    assert got[:2] == ("aborted", "insufficient_data")


def _write_step(root, step, *, commit=True, torn=False, suffix=""):
    d = root / f"step_{step:08d}{suffix}"
    d.mkdir(parents=True, exist_ok=True)
    body = json.dumps({"step": step, "world": {"processes": 1,
                                                "devices": 1}})
    (d / "manifest.json").write_text(body[: len(body) // 2] if torn
                                     else body)
    if commit:
        (d / "COMMIT").write_text("ok\n")


def test_watch_ignores_partial_checkpoints_as_jax_does(tmp_path):
    def run(pkg, root):
        mod, router_cls = PKGS[pkg]
        fleet = mod._SimFleet(2)
        router = router_cls(list(fleet.reps), transport=fleet.transport,
                            scrape_interval_s=1e9)
        ctl = mod.RolloutController(router, transport=fleet.transport,
                                    watch_dir=str(root),
                                    watch_interval_s=0.0)
        _write_step(root, 1, commit=False)        # mid-commit
        _write_step(root, 2, torn=True)           # torn manifest
        _write_step(root, 3, suffix=".corrupt")   # quarantined
        ticks = [ctl.tick() for _ in range(3)]
        idle = (ctl.state, ctl.target)
        _write_step(root, 4)
        ticks.append(ctl.tick())
        return ticks, idle, ctl.state, ctl.target, ctl.world

    got = run("port", tmp_path / "port")
    assert got == run("jax", tmp_path / "jax")
    assert got == ([False] * 3 + [True], ("idle", None), "rolling", 4,
                   {"step": 4, "processes": 1, "devices": 1})


def _roll_payloads(pkg, fleet):
    """The ``/swap_weights`` payloads of one roll of ``pkg``'s controller
    (``swap_seed=7``) on the stub ``fleet``, and the controller."""
    mod, router_cls = PKGS[pkg]
    payloads = []

    def transport(url, payload, timeout_s):
        if url.endswith("/swap_weights"):
            payloads.append(dict(payload))
        return fleet.transport(url, payload, timeout_s)

    router = router_cls(list(fleet.reps), transport=transport,
                        queue_limit=10_000, hedge_ms=0.0,
                        scrape_interval_s=0.0)
    ctl = mod.RolloutController(
        router, transport=transport, canary_frac=0.5, gate_pct=50.0,
        bake_min_samples=4, poll_interval_s=0.0, swap_seed=7)
    ctl.start(1)
    for rid in range(4000):
        if ctl.done():
            break
        router.submit(rid, [1, 2, 3])
        router.step()
        ctl.tick()
    return payloads, ctl


def test_rollback_names_only_the_version_as_jax_does():
    """The roll's swap carries the new weights' seed, the rollback's only
    the old version, as the JAX controller's; the replica restores the
    weights it served under that version
    (``test_rollback_restores_the_weights_the_replica_served``)."""
    got, ctl = _roll_payloads("port", rollout._SimFleet(
        2, poisoned_ttft_ms=500.0))
    want, _ = _roll_payloads("jax", jax_rollout._SimFleet(
        2, poisoned_ttft_ms=500.0))
    assert got == want == [{"version": 1, "seed": 7}, {"version": 0}]
    assert ctl.state == "aborted"
    assert [rep for rep, _ms in ctl.summary()["swap_ms"]] == ["r0", "r0"]
    assert min(ctl.summary()["bake_samples"].values()) >= 4


class _BurstFleet:
    """Stub fleet whose new-version replica takes its first ``wave``
    requests together (each waits until all have arrived) and answers
    them 500x slower, then answers as fast as the old version: the
    readmission burst, and nothing wrong with the weights."""

    def __init__(self, mod, wave):
        self.sim = mod._SimFleet(2)
        self.reps = self.sim.reps
        self.swaps = self.sim.swaps
        self.wave = threading.Barrier(wave, timeout=30.0)
        self.left = wave
        self.lock = threading.Lock()

    def transport(self, url, payload, timeout_s):
        base = url.rpartition("/")[0]
        burst = False
        if url.endswith("/generate") and self.reps[base]["version"] > 0:
            with self.lock:
                burst, self.left = self.left > 0, self.left - 1
        status, body = self.sim.transport(url, payload, timeout_s)
        if burst:
            self.wave.wait()
            body = dict(body, ttft_ms=500.0, tpot_ms=125.0)
        return status, body


def test_bake_skips_the_canarys_first_wave():
    """The gate skips the canary's first wave (what it was handed before
    its first answer), so a burst at readmission does not roll back a
    clean canary; the JAX gate counts the burst and rolls it back.  A canary
    slow on every answer is still rolled back (``test_sim_rollout_
    matches_jax``, ``test_slow_canary_is_rolled_back``)."""
    got = _sim("port", fleet=_BurstFleet(rollout, 4))
    want = _sim("jax", fleet=_BurstFleet(jax_rollout, 4))
    assert got["state"] == "done" and got["lost"] == 0
    assert set(got["versions"].values()) == {1}
    assert want["state"] == "aborted"
    assert want["abort_metric"] in rollout.GATE_METRICS


def test_check_is_clean():
    assert rollout.check() == []


def _swap_during_prefill(replica_mod, monkeypatch):
    """A request's prefill blocks until a swap was posted; returns the
    weights version each engine call of the request saw, the load gauges
    read during the prefill, and the two answers."""
    monkeypatch.delenv("TPUFRAME_METRICS_PORT", raising=False)
    monkeypatch.delenv("TPUFRAME_METRICS_TEXTFILE", raising=False)
    in_prefill, release = threading.Event(), threading.Event()
    seen = []

    class Engine(replica_mod.FakeEngine):
        def prefill(self, ids):
            seen.append(rep.weights_version)
            in_prefill.set()
            release.wait(30.0)
            return super().prefill(ids)

        def decode_step(self):
            seen.append(rep.weights_version)
            return super().decode_step()

    rep = replica_mod.Replica(Engine(slots=2), handler_timeout_s=30.0)
    pump = threading.Thread(target=rep.run, kwargs=dict(max_idle_s=30.0),
                            daemon=True)
    pump.start()
    out = {}
    gen = threading.Thread(target=lambda: out.update(gen=rep.handle_generate(
        json.dumps({"rid": 0, "prompt": [1, 2, 3],
                    "max_new_tokens": 6}).encode())))
    swap = threading.Thread(target=lambda: out.update(swap=rep.handle_swap(
        json.dumps({"version": 1}).encode())))
    try:
        gen.start()
        assert in_prefill.wait(30.0)
        gauges = {name: v for name, _l, v in rep.scheduler._load_samples()}
        swap.start()
        while not rep._swap_inbox:
            threading.Event().wait(0.005)
        release.set()
        gen.join(30.0)
        swap.join(30.0)
    finally:
        release.set()
        rep.drain()
        pump.join(30.0)
    return seen, gauges, out


def test_swap_waits_for_the_request_in_the_replicas_hands(monkeypatch):
    seen, gauges, out = _swap_during_prefill(port_replica, monkeypatch)
    # the drain's idle probe would read this replica as idle...
    assert gauges["tpuframe_serve_queue_depth"] == 0.0
    assert gauges["tpuframe_serve_active_slots"] == 0.0
    # ...yet the request runs on one version, and the swap comes after it
    assert seen == [0] * 6
    assert out["gen"][0] == 200 and out["swap"][0] == 200
    assert json.loads(out["swap"][1])["version"] == 1
    # the reference applies the swap between two decode steps
    jax_seen, _g, jax_out = _swap_during_prefill(jax_replica, monkeypatch)
    assert jax_seen[0] == 0 and jax_seen[-1] == 1
    assert jax_out["gen"][0] == 200


def _pumped(replica):
    pump = threading.Thread(target=replica.run,
                            kwargs=dict(max_idle_s=30.0), daemon=True)
    pump.start()
    return pump


def _swap(replica, **msg):
    status, body = replica.handle_swap(json.dumps(msg).encode())
    return status, json.loads(body)


def test_rollback_restores_the_weights_the_replica_served(monkeypatch):
    """A swap back to the version a seeded swap replaced, with no seed,
    puts the weights served under it back bit for bit; a seeded POST of
    what the replica serves already (a late retry) changes nothing; a
    version it holds no weights of is refused."""
    from tpuframe_torch.models.transformer_lm import LMConfig
    from tpuframe_torch.serve.engine import LMEngine

    monkeypatch.delenv("TPUFRAME_METRICS_PORT", raising=False)
    monkeypatch.delenv("TPUFRAME_METRICS_TEXTFILE", raising=False)
    kw = dict(slots=2, prompt_buckets=(16, 32), decode_block=16,
              max_context=64, device="cpu")
    engine = LMEngine(LMConfig.tiny(), **kw)
    rep = port_replica.Replica(engine, handler_timeout_s=30.0)
    pump = _pumped(rep)

    def served():
        return {k: v.clone() for k, v in engine.model.state_dict().items()}

    def same(a, b):
        return all(torch.equal(a[k], b[k]) for k in a)

    try:
        v0 = served()
        v1 = LMEngine(LMConfig.tiny(), seed=7, **kw).model.state_dict()
        assert _swap(rep, version=1, seed=7) == (
            200, {"version": 1, "compile_cache_misses": 0})
        assert same(served(), v1) and not same(served(), v0)
        assert _swap(rep, version=1, seed=7)[0] == 200     # late retry
        assert _swap(rep, version=0) == (
            200, {"version": 0, "compile_cache_misses": 0})
        assert same(served(), v0)
        status, body = _swap(rep, version=5)
        assert status == 500 and "no weights of version 5" in body["error"]
        assert rep.weights_version == 0 and same(served(), v0)
        assert _swap(rep, version=1)[0] == 200      # the roll again
        assert same(served(), v1)
    finally:
        rep.drain()
        pump.join(30.0)


def test_a_retried_swap_joins_the_queued_one(monkeypatch):
    """Two POSTs of one swap while the replica holds a request (the
    controller's RetryPolicy after a timeout) queue one job, and both
    answer once it is applied."""
    monkeypatch.delenv("TPUFRAME_METRICS_PORT", raising=False)
    monkeypatch.delenv("TPUFRAME_METRICS_TEXTFILE", raising=False)
    in_prefill, release = threading.Event(), threading.Event()
    applied = []

    class Engine(port_replica.FakeEngine):
        def prefill(self, ids):
            in_prefill.set()
            release.wait(30.0)
            return super().prefill(ids)

    rep = port_replica.Replica(Engine(slots=2), handler_timeout_s=30.0)
    real_fire = port_replica.faults.fire

    def fire(seam):
        if seam == "crash_during_swap":
            applied.append(rep.weights_version)
        return real_fire(seam)

    monkeypatch.setattr(port_replica.faults, "fire", fire)
    pump = _pumped(rep)
    out = []
    gen = threading.Thread(target=rep.handle_generate, args=(json.dumps(
        {"rid": 0, "prompt": [1, 2, 3], "max_new_tokens": 4}).encode(),))
    posts = [threading.Thread(target=lambda: out.append(
        _swap(rep, version=1))) for _ in range(2)]
    try:
        gen.start()
        assert in_prefill.wait(30.0)
        for t in posts:
            t.start()
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline and sum(
                len(job["done"]._cond._waiters)
                for job in list(rep._swap_inbox)) < 2:
            time.sleep(0.005)      # until both POSTs wait on a job
        assert len(rep._swap_inbox) == 1
        release.set()
        for t in (gen, *posts):
            t.join(30.0)
    finally:
        release.set()
        rep.drain()
        pump.join(30.0)
    assert out == [(200, {"version": 1, "compile_cache_misses": 0})] * 2
    assert applied == [0]


# ---------------------------------------------------------------------------
# Fake-engine fleets in processes
# ---------------------------------------------------------------------------

ROLL = dict(replicas=2, n_requests=24, seed=7, slots=2, step_delay_ms=20.0,
            rate=1000.0, max_new_tokens=8, queue_limit=256, hedge_ms=5000.0,
            canary_frac=0.5, bake_min_samples=4, timeout_s=60.0,
            ready_timeout_s=60.0)
# Both versions of a FakeEngine serve alike, so a clean canary's gap is
# the host's noise, which on a loaded test host passes 50% at these
# sample sizes: the clean rolls gate at 1000%.  The slow canary (0.2 s a
# loop against a 20 ms step) regresses TPOT ~10x, far past 100%.
CLEAN_GATE, SLOW_GATE = 1000.0, 100.0
SLOW_CANARY = "slow_canary:times=1000:delay_s=0.2"


def _rid_exact(merged):
    admits = [r["id"] for r in merged if r["type"] == "router_admit"]
    dones = [r["id"] for r in merged if r["type"] == "router_request"]
    assert sorted(admits) == sorted(set(admits)) == sorted(dones)


def test_clean_roll_loses_nothing_and_waits_for_the_commit(tmp_path):
    watch = tmp_path / "ck"
    _write_step(watch, 1, commit=False)   # on disk before the fleet starts
    out = rollout.rolling_update_smoke(events_dir=str(tmp_path / "ev"),
                                       watch_dir=str(watch),
                                       gate_pct=CLEAN_GATE, **ROLL)
    ro = out["rollout"]
    assert ro["state"] == "done" and ro["version"] == 1
    assert ro["world"]["step"] == 1
    assert out["admitted"] == ROLL["n_requests"] and out["lost"] == 0
    assert out["shed"] == 0 and not out["timed_out"]
    assert out["final_versions"] == {"r0": 1, "r1": 1}
    assert ro["relaunches"] == 0 and out["exit_codes"] == [0, 0]
    assert ro["window_s"] is not None and ro["window_s"] > 0.0
    merged = events.merge(str(tmp_path / "ev"))
    assert events.validate_files(events.event_files(str(tmp_path / "ev"))) \
        == []
    _rid_exact(merged)
    # the roll began only after the trigger: a quarter retired, COMMIT
    done_t = sorted(r["t"] for r in merged if r["type"] == "router_request")
    steps = [r for r in merged if r["type"] == "rollout_step"]
    assert done_t[ROLL["n_requests"] // 4 - 1] <= steps[0]["t"]
    assert sorted(r["replica"] for r in steps if r["phase"] == "swapped") \
        == ["r0", "r1"]
    v = goodput.fleet_stats(merged)["versions"]
    assert v["by_replica"] == {"r0": 1, "r1": 1} and not v["aborted"]
    assert tracing.verify_traces(merged) == []
    roots = [sp for tv in tracing.build_traces(merged).values()
             for sp in tv.roots if sp.name == "rollout"]
    assert [sp.closed["status"] for sp in roots] == ["done"]


def test_slow_canary_is_rolled_back(tmp_path):
    out = rollout.rolling_update_smoke(
        events_dir=str(tmp_path / "ev"), faults_spec=SLOW_CANARY,
        gate_pct=SLOW_GATE, **ROLL)
    ro = out["rollout"]
    assert ro["state"] == "aborted" and ro["aborted"]
    assert ro["abort_metric"] in rollout.GATE_METRICS
    assert out["final_versions"] == {"r0": 0, "r1": 0}
    assert tuple(ro["phases"][-1]) == ("r0", "rolled_back")
    assert out["admitted"] == ROLL["n_requests"] and out["lost"] == 0
    assert not out["timed_out"] and out["exit_codes"] == [0, 0]
    merged = events.merge(str(tmp_path / "ev"))
    _rid_exact(merged)
    (abort,) = [r for r in merged if r["type"] == "rollout_abort"]
    assert abort["metric"] == ro["abort_metric"] and abort["version"] == 1
    v = goodput.fleet_stats(merged)["versions"]
    assert v["aborted"] and v["by_replica"]["r0"] == 0


def test_replica_killed_mid_swap_comes_back_on_the_new_version(tmp_path):
    out = rollout.rolling_update_smoke(events_dir=str(tmp_path / "ev"),
                                       kill_during_swap_rank=1,
                                       gate_pct=CLEAN_GATE, **ROLL)
    ro = out["rollout"]
    assert out["relaunched_ranks"] == [1] and ro["relaunches"] == 1
    assert ro["state"] == "done" and ro["version"] == 1
    assert out["final_versions"] == {"r0": 1, "r1": 1}
    assert out["admitted"] == ROLL["n_requests"] and out["lost"] == 0
    merged = events.merge(str(tmp_path / "ev"))
    _rid_exact(merged)
    steps = [r for r in merged if r["type"] == "rollout_step"]
    assert [r["replica"] for r in steps if r["phase"] == "swap_failed"] \
        == ["r1"]
    assert [r["replica"] for r in steps if r["phase"] == "relaunched"] \
        == ["r1"]
    assert goodput.fleet_stats(merged)["versions"]["by_replica"] == {
        "r0": 1, "r1": 1}
