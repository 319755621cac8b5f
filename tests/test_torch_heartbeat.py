"""The port's stall watchdog (tpuframe_torch.obs.heartbeat and the
trainer's stall abort) and its process id, against the JAX package.

  - ``Heartbeat`` at the JAX test's timings (tests/test_observability.py):
    the stall event and re-arm, arming after the first beat, a callback
    that raises; the port's and the JAX watchdog log the same stalls;
  - a gloo wait releases the GIL: the watchdog thread ends a rank with
    ``os._exit(13)`` while its main thread is blocked in ``all_reduce``;
  - the port's trainer with one rank hung in a two-rank gloo world exits
    13 on both ranks within its stall timeout plus a few polls (the JAX
    twin is tests/test_fault_tolerance.py::test_stall_becomes_clean_abort);
  - outside a process group, the event log's ``proc`` and file name and
    the ``rank=`` faults that fire follow ``TPUFRAME_PROCESS_ID``, as in
    the JAX package.
"""

import os
import subprocess
import sys
import textwrap
import time

import pytest

pytest.importorskip("torch")

from tpuframe.obs import events as jax_events  # noqa: E402
from tpuframe.obs.heartbeat import Heartbeat as JaxHeartbeat  # noqa: E402
from tpuframe.resilience import faults as jax_faults  # noqa: E402
from tpuframe_torch.launch.launcher import LocalCluster  # noqa: E402
from tpuframe_torch.obs import events  # noqa: E402
from tpuframe_torch.obs.heartbeat import Heartbeat  # noqa: E402
from tpuframe_torch.parallel import bootstrap  # noqa: E402
from tpuframe_torch.resilience import faults  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = {"port": (Heartbeat, events), "jax": (JaxHeartbeat, jax_events)}


def _wait_for(pred, timeout_s=5.0):
    deadline = time.monotonic() + timeout_s
    while not pred() and time.monotonic() < deadline:
        time.sleep(0.02)
    return pred()


def _stall_records(ev_mod, path):
    return [{k: r[k] for k in ("last_step", "stall_count")}
            for r in ev_mod.read_file(path) if r["type"] == "stall"]


def _rearm_run(pkg, directory):
    """The JAX test's scenario: stall, beat (re-arm), stall again."""
    hb_cls, ev_mod = PACKAGES[pkg]
    log = ev_mod.init(str(directory))
    h = hb_cls(timeout_s=0.08, poll_s=0.02)
    h.start()
    try:
        # the first stall's event written (the JAX watchdog counts the
        # stall before it writes the event with the current step)
        assert _wait_for(lambda: _stall_records(ev_mod, log.path))
        assert h.stall_count == 1 and h.stalled
        h.beat(7)  # recovery re-arms the watchdog...
        assert not h.stalled
        # ...so it reports again
        assert _wait_for(lambda: h.stall_count >= 2)
    finally:
        h.stop()
        ev_mod.close()
    assert all(ev_mod.validate_record(r) == []
               for r in ev_mod.read_file(log.path))
    return _stall_records(ev_mod, log.path)


def test_stall_event_and_rearm_match_jax(tmp_path):
    port = _rearm_run("port", tmp_path / "port")
    ref = _rearm_run("jax", tmp_path / "jax")
    assert port == ref == [{"last_step": 0, "stall_count": 1},
                           {"last_step": 7, "stall_count": 2}]


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_arms_only_after_the_first_beat(pkg):
    hb_cls, _ = PACKAGES[pkg]
    h = hb_cls(timeout_s=0.08, poll_s=0.02, arm_after_first_beat=True)
    h.start()
    try:
        time.sleep(0.3)               # the first step: unbounded
        assert h.stall_count == 0 and not h.stalled
        h.beat(1)
        assert _wait_for(lambda: h.stall_count == 1)
    finally:
        h.stop()


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_raising_callback_keeps_the_watchdog_alive(pkg):
    hb_cls, _ = PACKAGES[pkg]
    calls = []

    def on_stall(idle):
        calls.append(idle)
        raise RuntimeError("broken callback")

    h = hb_cls(timeout_s=0.08, poll_s=0.02, on_stall=on_stall)
    h.start()
    try:
        assert _wait_for(lambda: len(calls) == 1)
        h.beat(3)
        assert _wait_for(lambda: len(calls) == 2)   # thread still watching
        assert h._thread.is_alive()
        assert all(idle > 0.08 for idle in calls)
    finally:
        h.stop()


def test_check_brings_the_deadline_forward():
    """The trainer's failure path: one poll, run now, with slack."""
    h = Heartbeat(timeout_s=10.0, poll_s=1.0, arm_after_first_beat=True)
    assert not h.check(slack_s=100.0)        # not armed before a beat
    h.beat(1)
    time.sleep(0.05)
    h.beat(2)
    assert 0.04 < h.last_interval_s < 1.0
    assert not h.check(slack_s=1.0)          # 10 s away
    assert h.check(slack_s=10.0)             # within the slack: a stall
    assert h.stalled and h.stall_count == 1
    assert not h.check(slack_s=10.0)         # latched until the next beat


_GLOO_BLOCKED = textwrap.dedent("""
    import os, sys, time
    import torch
    import torch.distributed as dist
    from tpuframe_torch.obs.heartbeat import Heartbeat

    rank, port = int(sys.argv[1]), sys.argv[2]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=2, rank=rank)
    if rank == 1:
        time.sleep(30)                     # the peer that never arrives
        os._exit(0)

    def abort(idle):
        print(f"STALL {idle:.2f}", flush=True)
        os._exit(13)

    h = Heartbeat(timeout_s=1.0, poll_s=0.1, on_stall=abort).start()
    h.beat(1)
    dist.all_reduce(torch.ones(4))         # blocks: rank 1 is asleep
    print("all_reduce returned", flush=True)
""")


def test_watchdog_fires_while_main_thread_waits_in_gloo():
    """A gloo wait releases the GIL, and ``os._exit`` from the watchdog
    thread ends the process while the main thread is still blocked."""
    from tpuframe_torch.launch.launcher import _free_port

    port = str(_free_port())
    env = {**os.environ, "PYTHONPATH": REPO}
    procs = [subprocess.Popen([sys.executable, "-c", _GLOO_BLOCKED, str(r),
                               port], cwd=REPO, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(2)]
    try:
        t0 = time.monotonic()
        out, err = procs[0].communicate(timeout=60)
        waited = time.monotonic() - t0
        assert procs[0].returncode == 13, err
        assert "STALL" in out and "all_reduce returned" not in out
        assert waited < 25, waited           # long before rank 1 wakes
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.communicate()


def test_hung_rank_stalls_both_ranks_to_rc_13(tmp_path):
    """Rank 1 hangs after step 3; rank 1's watchdog aborts it, rank 0's
    collective loses its peer within one beat interval of its own
    deadline, and both exit 13 with the STALL line."""
    timeout_s, poll_s = 3.0, 0.2
    t0 = time.monotonic()
    with pytest.raises(RuntimeError) as excinfo:
        LocalCluster(2, timeout=120, extra_env={
            "TPUFRAME_DIST_BACKEND": "gloo",
            "TPUFRAME_HANG_STEP": "3", "TPUFRAME_HANG_RANK": "1",
            "TPUFRAME_STALL_TIMEOUT_S": str(timeout_s),
            "TPUFRAME_STALL_POLL_S": str(poll_s),
            "PYTHONPATH": REPO,
        }).launch([
            sys.executable, "-m", "tpuframe_torch.train", "--config",
            "smoke", "--device", "cpu", "--set", "total_steps=30",
            "--set", "eval_every=1000", "--set", "global_batch=16",
            "--set", "log_every=1",
            "--set", 'dataset_kwargs={"synthetic_size": 64}'])
    elapsed = time.monotonic() - t0
    msg = str(excinfo.value)
    for rank in (0, 1):
        part = msg.split(f"--- rank {rank} ")[1].split("--- rank")[0]
        assert part.startswith("(exit 13)"), msg
        assert "STALL: no step completed" in part, msg
    assert "FAULT INJECTION: hanging at step 3" in msg
    # start-up and three steps, then the stall window and a few polls:
    # nowhere near the process group's 30-minute timeout
    assert elapsed < 60, elapsed


def _fault_fires(mod, spec):
    reg = mod.FaultRegistry(mod.parse(spec))
    try:
        reg.fire("host")
    except mod.InjectedFault:
        return True
    return False


def test_process_id_outside_a_group_matches_jax(tmp_path, monkeypatch):
    """Fault 1(b): a fleet replica has no process group, so its event
    file, ``proc`` and ``rank=`` faults follow ``TPUFRAME_PROCESS_ID``."""
    bootstrap.shutdown()
    monkeypatch.setenv("TPUFRAME_PROCESS_ID", "3")
    assert bootstrap.process_index() == 3
    port = events.EventLog(str(tmp_path / "port"))
    ref = jax_events.EventLog(str(tmp_path / "jax"))
    try:
        assert (port.proc, port.host) == (ref.proc, ref.host)
        assert port.host.endswith("-p3")
        assert os.path.basename(port.path) == os.path.basename(ref.path)
    finally:
        port.close()
        ref.close()
    for spec in ("host:rank=3", "host:rank=0", "host", "host:rank=1"):
        assert _fault_fires(faults, spec) == _fault_fires(jax_faults, spec), \
            spec
    assert _fault_fires(faults, "host:rank=3")
    assert not _fault_fires(faults, "host:rank=0")
    monkeypatch.delenv("TPUFRAME_PROCESS_ID")
    assert bootstrap.process_index() == 0
    assert _fault_fires(faults, "host:rank=0")
