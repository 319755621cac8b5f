"""tpuframe_torch.resilience against tpuframe.resilience: the fault grammar,
the retry policy under a fake clock, the preemption guard, the storage
layer's retries, and the preemption contract through the port's trainer in
process: SIGTERM at step 3 → a committed checkpoint and ``SystemExit(14)``
→ a resume that ends at step 6 with the per-step losses of a straight run,
bit for bit (f32 on the CPU: the same arithmetic in the same order, and
dropout drawn from ``dropout_seed(seed, step, rank)``).
"""

import dataclasses
import os
import signal

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tpuframe.resilience import faults as jax_faults  # noqa: E402
from tpuframe_torch import ckpt  # noqa: E402
from tpuframe_torch import train as port_train  # noqa: E402
from tpuframe_torch.data import gcs  # noqa: E402
from tpuframe_torch.resilience import (RC_PREEMPTED,  # noqa: E402
                                       PreemptionGuard, RetryPolicy, faults)
from tpuframe_torch.resilience import policy  # noqa: E402
from tpuframe_torch.resilience.policy import is_retryable  # noqa: E402


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    """No armed fault and no retry count leaks into or out of a test."""
    for var in ("TPUFRAME_FAULTS", "TPUFRAME_FAULT_STEP",
                "TPUFRAME_FAULT_ONCE", "TPUFRAME_ASYNC_CKPT"):
        monkeypatch.delenv(var, raising=False)
    faults.reset_from_env({})
    policy.COUNTERS.clear()
    yield
    faults.reset_from_env({})
    policy.COUNTERS.clear()


SPECS = [
    "gcs_read:step=13:kind=ioerror",
    "ckpt_shard:kind=corrupt,ckpt_shard:kind=torn",
    "host:step=20:kind=sigterm:once=1:times=3",
    "host:step=3:kind=sigterm",
    "slow_gcs:delay_s=0.5:times=2",
    "crash_during_upload",
    "sigterm_pending_upload:times=1",
    "host:kind=partial_sigterm:k=2:rank=0",
    "replica_crash,replica_hang,replica_slow,slow_canary,crash_during_swap",
    "gcs_list:kind=hang,gcs_stat:kind=slow,gcs_delete:kind=sigint",
    " gcs_write:once=0 , ",
    "",
]
BAD_SPECS = ["tpu_melt:step=1", "gcs_read:kind=explode", "gcs_read:when=later",
             "host:step", "host:kind=partial_sigterm:k=0", "host:step=x"]


@pytest.mark.parametrize("spec", SPECS)
def test_grammar_parses_as_the_jax_package_does(spec):
    got = [dataclasses.asdict(f) for f in faults.parse(spec)]
    want = [dataclasses.asdict(f) for f in jax_faults.parse(spec)]
    assert got == want


@pytest.mark.parametrize("spec", BAD_SPECS)
def test_grammar_rejects_as_the_jax_package_does(spec):
    with pytest.raises(ValueError) as want:
        jax_faults.parse(spec)
    with pytest.raises(ValueError) as got:
        faults.parse(spec)
    assert str(got.value) == str(want.value)


def test_removed_aliases_raise_with_the_spelling():
    with pytest.raises(RuntimeError, match=r"host:step=7:kind=crash:once=1"):
        faults.reset_from_env({"TPUFRAME_FAULT_STEP": "7",
                               "TPUFRAME_FAULT_ONCE": "1"})
    with pytest.raises(RuntimeError, match="TPUFRAME_FAULT_ONCE"):
        faults.reset_from_env({"TPUFRAME_FAULT_ONCE": "1"})
    reg = faults.reset_from_env(
        {"TPUFRAME_FAULTS": "host:step=7:kind=crash:once=1"})
    assert [(f.seam, f.kind, f.step, f.once) for f in reg.faults] == [
        ("host", "crash", 7, True)]
    reg.set_resumed(True)
    assert reg.faults == []


def test_registry_fires_per_times_and_step():
    reg = faults.FaultRegistry(faults.parse("gcs_read:times=2,"
                                            "gcs_write:step=4"))
    for _ in range(2):
        with pytest.raises(faults.InjectedFault):
            reg.fire("gcs_read")
    reg.fire("gcs_read")                # spent
    reg.fire("gcs_write")               # step 0: not armed yet
    reg.set_step(4)
    with pytest.raises(faults.InjectedFault, match="step 4"):
        reg.fire("gcs_write")


def test_mangle_corrupt_and_torn():
    reg = faults.FaultRegistry(
        faults.parse("ckpt_shard:kind=corrupt,ckpt_shard:kind=torn"))
    data = bytes(range(64))
    bad = reg.mangle("ckpt_shard", data)
    assert len(bad) == len(data) and bad != data
    want = jax_faults.FaultRegistry(jax_faults.parse(
        "ckpt_shard:kind=corrupt")).mangle("ckpt_shard", data)
    assert bad == want
    assert len(reg.mangle("ckpt_shard", data)) == len(data) // 2
    assert reg.mangle("ckpt_shard", data) == data


def test_rank_gate_uses_the_torch_world():
    reg = faults.FaultRegistry(faults.parse("gcs_read:rank=1,"
                                            "gcs_write:rank=0"))
    reg.fire("gcs_read")                # rank 0 of a world of one
    with pytest.raises(faults.InjectedFault):
        reg.fire("gcs_write")


class _FakeTime:
    def __init__(self):
        self.now = 0.0
        self.sleeps = []

    def clock(self):
        return self.now

    def sleep(self, s):
        self.sleeps.append(s)
        self.now += s


class _FixedRng:
    """uniform() returns the upper bound: deterministic jitter."""

    def uniform(self, a, b):
        return b


def _policy(ft, **kw):
    kw.setdefault("max_attempts", 4)
    kw.setdefault("base_delay_s", 0.1)
    kw.setdefault("max_delay_s", 10.0)
    kw.setdefault("deadline_s", 1000.0)
    return RetryPolicy(clock=ft.clock, sleep=ft.sleep, rng=_FixedRng(), **kw)


def test_transient_failure_recovers():
    ft, calls = _FakeTime(), []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise ConnectionResetError("peer reset")
        return "ok"

    assert _policy(ft).call(flaky, op="t") == "ok"
    assert len(calls) == 3
    assert policy.counters("retry.") == {"retry.t.retries": 2,
                                         "retry.t.recovered": 1}


def test_backoff_is_exponential_with_cap():
    ft = _FakeTime()

    def always():
        raise TimeoutError("slow")

    with pytest.raises(TimeoutError):
        _policy(ft, max_attempts=6, max_delay_s=1.0).call(always, op="t")
    np.testing.assert_allclose(ft.sleeps, [0.3, 0.9, 1.0, 1.0, 1.0])
    assert policy.counters("retry.t.exhausted") == {"retry.t.exhausted": 1}


def test_deadline_stops_retrying_early():
    ft, calls = _FakeTime(), []

    def always():
        calls.append(1)
        ft.now += 30.0
        raise TimeoutError("slow")

    with pytest.raises(TimeoutError):
        _policy(ft, max_attempts=100, deadline_s=60.0).call(always, op="t")
    assert len(calls) < 5
    assert policy.counters()["retry.t.exhausted"] == 1


def test_non_retryable_raises_at_once():
    ft, calls = _FakeTime(), []

    def missing():
        calls.append(1)
        raise FileNotFoundError("no such object")

    with pytest.raises(FileNotFoundError):
        _policy(ft).call(missing, op="t")
    assert len(calls) == 1 and ft.sleeps == []


def test_wrap_and_decorator_name_the_op():
    ft, calls = _FakeTime(), []

    @policy.retrying(_policy(ft), op="deco")
    def flaky():
        calls.append(1)
        if len(calls) < 2:
            raise OSError("EIO")
        return 7

    assert flaky() == 7
    assert policy.counters("retry.deco") == {"retry.deco.retries": 1,
                                             "retry.deco.recovered": 1}


def test_classification():
    assert is_retryable(ConnectionResetError("x"))
    assert is_retryable(TimeoutError("x"))
    assert is_retryable(OSError("generic I/O"))
    assert is_retryable(faults.InjectedFault("x"))
    assert not is_retryable(FileNotFoundError("x"))
    assert not is_retryable(PermissionError("x"))
    assert not is_retryable(ValueError("x"))
    assert not is_retryable(NotImplementedError("gs://"))
    assert is_retryable(type("ServiceUnavailable", (Exception,), {})("503"))


def test_gcs_read_retries_injected_ioerrors(tmp_path, monkeypatch):
    p = tmp_path / "obj.bin"
    p.write_bytes(b"payload")
    monkeypatch.setenv("TPUFRAME_FAULTS", "gcs_read:kind=ioerror:times=2")
    faults.reset_from_env()
    monkeypatch.setattr(gcs._POLICY, "sleep", lambda s: None)
    assert gcs.read_bytes(str(p)) == b"payload"
    assert policy.counters("retry.") == {"retry.gcs_read.retries": 2,
                                         "retry.gcs_read.recovered": 1}


def test_gcs_local_operations(tmp_path):
    d = str(tmp_path / "a" / "b")
    gcs.makedirs(d)
    f = gcs.join(d, "x.bin")
    assert not gcs.exists(f) and gcs.mtime(f) == 0.0
    gcs.write_bytes(f, b"one")
    gcs.write_bytes(f, b"two")          # atomic replace, no .tmp left
    assert gcs.read_bytes(f) == b"two" and gcs.listdir(d) == ["x.bin"]
    assert gcs.mtime(f) > 0
    gcs.rename_tree(d, d + ".corrupt")
    assert gcs.listdir(str(tmp_path / "a")) == ["b.corrupt"]
    assert gcs.listdir(d) == []
    gcs.delete(gcs.join(d + ".corrupt", "x.bin"))
    gcs.delete(gcs.join(d + ".corrupt", "x.bin"))   # absent: no-op
    gcs.delete_tree(str(tmp_path / "a"))
    assert not os.path.exists(tmp_path / "a")
    with pytest.raises(FileNotFoundError):
        gcs.read_bytes(str(tmp_path / "absent"))
    assert policy.counters("retry.") == {}


@pytest.mark.parametrize("op", [lambda: gcs.read_bytes("gs://b/k"),
                                lambda: gcs.write_bytes("gs://b/k", b""),
                                lambda: gcs.listdir("gs://b"),
                                lambda: gcs.exists("gs://b/k")])
def test_gcs_bucket_paths_raise_naming_the_roadmap_item(op):
    with pytest.raises(NotImplementedError, match="item 4"):
        op()


def test_guard_turns_sigterm_into_a_flag():
    with PreemptionGuard() as guard:
        assert guard.active and not guard.requested
        os.kill(os.getpid(), signal.SIGTERM)
        assert guard.requested and guard.signal_name == "SIGTERM"
    assert not guard.active


def test_second_sigint_escalates():
    guard = PreemptionGuard().install()
    try:
        os.kill(os.getpid(), signal.SIGINT)
        assert guard.requested
        with pytest.raises(KeyboardInterrupt):
            os.kill(os.getpid(), signal.SIGINT)
        assert not guard.active
    finally:
        guard.uninstall()


def test_second_sigterm_reaches_the_handler_from_before_the_guard():
    """The supervisor's kill after the grace window: the second SIGTERM is
    re-delivered with the guard uninstalled (here to a recording handler
    in place of the default action, which would end the test process)."""
    seen = []
    old = signal.signal(signal.SIGTERM, lambda s, f: seen.append(s))
    try:
        guard = PreemptionGuard().install()
        os.kill(os.getpid(), signal.SIGTERM)
        assert guard.requested and seen == []
        os.kill(os.getpid(), signal.SIGTERM)
        assert seen == [signal.SIGTERM] and not guard.active
    finally:
        signal.signal(signal.SIGTERM, old)


def test_reassert_takes_the_signal_back():
    guard = PreemptionGuard().install()
    try:
        signal.signal(signal.SIGTERM, lambda s, f: None)
        guard.reassert()
        os.kill(os.getpid(), signal.SIGTERM)
        assert guard.requested
    finally:
        guard.uninstall()
    assert signal.getsignal(signal.SIGTERM) is not guard._handle


def _cfg(tmp_path, **over):
    """mnist_single cut to seconds: batch 16, the ConvNet with its
    dropout (drawn from the step's seed, so a resume redraws the same
    masks)."""
    over = {"global_batch": 16, "total_steps": 6, "eval_every": 1000,
            "log_every": 2, "ckpt_every": 10, "dataset_kwargs":
                {"synthetic_size": 128}, "ckpt_dir": str(tmp_path / "ck"),
            **over}
    return port_train.get_config("mnist_single").with_overrides(**over)


@pytest.mark.parametrize("async_write", [False, True])
def test_sigterm_mid_run_checkpoints_exits_14_and_resumes_exactly(
        tmp_path, monkeypatch, capsys, async_write):
    straight = port_train.train(_cfg(tmp_path / "a", ckpt_dir=None),
                                device="cpu")
    before = signal.getsignal(signal.SIGTERM)
    monkeypatch.setenv("TPUFRAME_FAULTS", "host:step=3:kind=sigterm")
    cfg = _cfg(tmp_path, ckpt_async=async_write)
    with pytest.raises(SystemExit) as ei:
        port_train.train(cfg, device="cpu")
    assert ei.value.code == RC_PREEMPTED
    ck = str(tmp_path / "ck")
    assert (tmp_path / "ck" / "step_00000003" / "COMMIT").exists()
    assert ckpt.latest_step(ck) == 3
    assert ckpt.committed_world(ck) == {"step": 3, "processes": 1,
                                        "devices": 1}
    assert "preempted (SIGTERM): checkpoint committed at step 3" in \
        capsys.readouterr().out
    # the guard is gone: the handler from before the run is back
    assert signal.getsignal(signal.SIGTERM) is before

    monkeypatch.delenv("TPUFRAME_FAULTS")
    resumed = port_train.train(cfg, device="cpu")
    assert "resumed from step 3" in capsys.readouterr().out
    assert resumed["step"] == 6 and len(resumed["losses"]) == 3
    assert resumed["losses"] == straight["losses"][3:]
    assert ckpt.latest_step(ck) == 6     # the final state is saved


def test_sigterm_with_an_upload_in_flight_flushes_before_rc_14(
        tmp_path, monkeypatch):
    """SIGTERM lands as the step-2 snapshot starts writing (slowed by
    slow_gcs): rc 14 only after flush() committed it, and the resume
    continues exactly."""
    straight = port_train.train(_cfg(tmp_path / "a", ckpt_dir=None),
                                device="cpu")
    monkeypatch.setenv("TPUFRAME_ASYNC_CKPT", "1")
    monkeypatch.setenv("TPUFRAME_FAULTS", "sigterm_pending_upload:times=1,"
                                          "slow_gcs:delay_s=0.2:times=2")
    cfg = _cfg(tmp_path, ckpt_every=2)
    with pytest.raises(SystemExit) as ei:
        port_train.train(cfg, device="cpu")
    assert ei.value.code == RC_PREEMPTED
    assert (tmp_path / "ck" / "step_00000002" / "COMMIT").exists()
    assert not (tmp_path / "ck" / "step_00000002.corrupt").exists()
    monkeypatch.delenv("TPUFRAME_FAULTS")
    resumed = port_train.train(cfg, device="cpu")
    assert resumed["losses"] == straight["losses"][2:]


def test_track_best_needs_a_ckpt_dir():
    cfg = port_train.get_config("mnist_single").with_overrides(
        track_best=True)
    with pytest.raises(ValueError, match="track_best=True needs ckpt_dir"):
        port_train.build_harness(cfg, device="cpu")
