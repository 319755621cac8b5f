"""tpuframe_torch.ckpt: the JAX package's checkpoint cases
(``tests/test_data_ckpt.py``, ``tests/test_resilience.py``,
``tests/test_chaos.py``) on the port, then across the two packages on the
CPU: each restores what the other wrote, with its CRCs verified, and each
catches a shard the other wrote corrupt.

Checkpoints are bytes: every comparison is exact (f32, integers and bf16
bit for bit), and the two packages write byte-identical shard files for
the same tree.
"""

import json
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402
import optax  # noqa: E402

from tpuframe import ckpt as jax_ckpt  # noqa: E402
from tpuframe.obs import events as jax_events  # noqa: E402
from tpuframe.parallel import step as jax_step  # noqa: E402
from tpuframe.resilience import faults as jax_faults  # noqa: E402
from tpuframe_torch import ckpt  # noqa: E402
from tpuframe_torch import models as port_models  # noqa: E402
from tpuframe_torch.ckpt import checkpoint as ckpt_mod  # noqa: E402
from tpuframe_torch.obs import events  # noqa: E402
from tpuframe_torch.parallel import step as port_step  # noqa: E402
from tpuframe_torch.resilience import PreemptionGuard, faults  # noqa: E402
from tpuframe_torch.resilience import policy  # noqa: E402
from tpuframe_torch.utils.config import get_config  # noqa: E402
from tpuframe_torch.utils.optim import build_optimizer  # noqa: E402


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.delenv("TPUFRAME_FAULTS", raising=False)
    faults.reset_from_env({})
    jax_faults.reset_from_env({})
    yield
    faults.reset_from_env({})
    jax_faults.reset_from_env({})
    events.close()


def _arrays(seed=0):
    """One tree as numpy: f32, int32 (0-d and 1-d) and bf16 (as f32
    values that bf16 holds exactly)."""
    rng = np.random.default_rng(seed)
    return {
        "params": {"w": rng.standard_normal((3, 4)).astype(np.float32),
                   "b": rng.standard_normal(4).astype(np.float32)},
        "half": (rng.integers(-64, 64, (2, 5)) / 8).astype(np.float32),
        "count": np.asarray(7, np.int32),
        "ids": rng.integers(0, 1000, 6).astype(np.int32),
    }


def _port_tree(seed=0):
    a = _arrays(seed)
    return {"params": {k: torch.from_numpy(v) for k, v in
                       a["params"].items()},
            "half": torch.from_numpy(a["half"]).to(torch.bfloat16),
            "count": torch.from_numpy(a["count"]),
            "ids": torch.from_numpy(a["ids"])}


def _jax_tree(seed=0):
    a = _arrays(seed)
    return {"params": {k: jnp.asarray(v) for k, v in a["params"].items()},
            "half": jnp.asarray(a["half"]).astype(jnp.bfloat16),
            "count": jnp.asarray(a["count"]), "ids": jnp.asarray(a["ids"])}


def _assert_trees_equal(got: dict, want: dict):
    flat_g, flat_w = ckpt_mod._flatten(got), ckpt_mod._flatten(want)
    assert [n for n, _ in flat_g] == [n for n, _ in flat_w]
    for (name, g), (_, w) in zip(flat_g, flat_w):
        assert g.dtype == w.dtype, name
        assert torch.equal(g, w), name


def _toy_state(scale=1.0):
    """A tiny port TrainState (convnet, sgd): model, trace, count, step."""
    cfg = get_config("mnist_single")
    model = port_models.get_model("convnet", dtype="float32", device="cpu",
                                  seed=0, dropout=0.0)
    with torch.no_grad():
        for p in model.parameters():
            p.mul_(scale)
    state = port_step.TrainState(model, build_optimizer(cfg, model), step=4,
                                 seed=11)
    for i, t in enumerate(state.opt.moments["trace"]):
        t.fill_(0.5 * i * scale)
    state.opt.count = 4
    return state


def test_round_trip_is_exact_for_f32_int_and_bf16(tmp_path):
    tree = {**_port_tree(), "n": 5, "x": np.arange(3.0)}
    ckpt.save(str(tmp_path), 3, tree)
    out = ckpt.restore(str(tmp_path), 3)
    assert out["half"].dtype == torch.bfloat16
    _assert_trees_equal({k: v for k, v in out.items() if k not in "nx"},
                        _port_tree())
    assert out["n"].item() == 5 and out["n"].dtype == torch.int64
    assert torch.equal(out["x"], torch.arange(3.0, dtype=torch.float64))
    # with a target, Python numbers come back as Python numbers
    again = ckpt.restore(str(tmp_path), 3, target=tree)
    assert again["n"] == 5 and isinstance(again["n"], int)


def test_train_state_round_trip_in_place(tmp_path):
    src = _toy_state()
    ckpt.save(str(tmp_path), 4, src.to_tree())
    dst = _toy_state(scale=3.0)
    trace_ids = [id(t) for t in dst.opt.moments["trace"]]
    params = list(dst.model.parameters())
    dst.load_tree(ckpt.restore(str(tmp_path), 4, target=dst.to_tree()))
    assert (dst.step, dst.seed, dst.opt.count) == (4, 11, 4)
    # in place: the optimizer's lists still hold the live tensors
    assert [id(t) for t in dst.opt.moments["trace"]] == trace_ids
    assert list(dst.model.parameters()) == params
    _assert_trees_equal(dst.to_tree()["model"], src.to_tree()["model"])
    for a, b in zip(dst.opt.moments["trace"], src.opt.moments["trace"]):
        assert torch.equal(a, b)


def test_leaf_names_follow_the_train_state_layout(tmp_path):
    ckpt.save(str(tmp_path), 4, _toy_state().to_tree())
    names = json.loads((tmp_path / "step_00000004" / "manifest.json")
                       .read_text())["leaf_order"]
    assert "model/conv1.weight" in names and "opt/count" in names
    assert "opt/trace/fc2.bias" in names
    assert names[-2:] == ["seed", "step"]


def test_manifest_and_files_equal_the_jax_packages(tmp_path):
    ckpt.save(str(tmp_path / "port"), 1, _port_tree())
    jax_ckpt.save(str(tmp_path / "jax"), 1, _jax_tree())
    dirs = {k: tmp_path / k / "step_00000001" for k in ("port", "jax")}
    got, want = (json.loads((dirs[k] / "manifest.json").read_text())
                 for k in ("port", "jax"))
    assert set(got) == set(want)
    assert got["leaf_order"] == want["leaf_order"]
    assert got["crc_algo"] == want["crc_algo"] == "crc32c"
    assert set(got["world"]) == set(want["world"])
    for name, entry in want["leaves"].items():
        assert set(got["leaves"][name]) == set(entry)
        for key in ("shape", "dtype"):
            assert got["leaves"][name][key] == entry[key], (name, key)
    assert got["leaves"]["half"]["dtype"] == "bfloat16"
    # the same bytes: the same CRCs and the same shard files
    assert got["crc"] == want["crc"]
    for fname in want["crc"]:
        assert ((dirs["port"] / fname).read_bytes()
                == (dirs["jax"] / fname).read_bytes()), fname


def test_port_checkpoint_restores_in_the_jax_package(tmp_path):
    """port → JAX: ``tpuframe.ckpt.restore`` with its CRC check, leaf for
    leaf, bf16 included; and a whole port TrainState."""
    ckpt.save(str(tmp_path), 2, _port_tree())
    out = jax_ckpt.restore(str(tmp_path), 2)
    want = _port_tree()
    assert out["half"].dtype == ml_dtypes.bfloat16
    np.testing.assert_array_equal(
        out["half"].view(np.int16),
        want["half"].view(torch.int16).numpy())
    for name in ("count", "ids"):
        np.testing.assert_array_equal(out[name], want[name].numpy())
        assert out[name].dtype == np.int32
    for k, v in want["params"].items():
        np.testing.assert_array_equal(out["params"][k], v.numpy())

    state = _toy_state()
    ckpt.save(str(tmp_path / "ts"), 4, state.to_tree())
    tree = jax_ckpt.restore(str(tmp_path / "ts"), 4)
    assert int(tree["step"]) == 4 and int(tree["opt"]["count"]) == 4
    for k, v in state.model.state_dict().items():
        np.testing.assert_array_equal(tree["model"][k], v.numpy())


def test_jax_checkpoint_restores_in_the_port(tmp_path):
    """JAX → port: the nested dict of a JAX TrainState, its PRNG key leaf
    as its uint32 key data."""
    state = jax_step.TrainState.create(
        {"w": jnp.arange(12.0).reshape(3, 4), "b": jnp.ones(())},
        optax.adam(1e-3))
    jax_ckpt.save(str(tmp_path), 10, state)
    out = ckpt.restore(str(tmp_path), 10)
    assert set(out) == {"step", "params", "opt_state", "rng"}
    assert torch.equal(out["params"]["w"], torch.arange(12.0).reshape(3, 4))
    assert out["step"].item() == 0 and out["step"].dtype == torch.int32
    assert out["rng"].dtype == torch.uint32
    jax_ckpt.save(str(tmp_path / "t"), 1, _jax_tree())
    _assert_trees_equal(ckpt.restore(str(tmp_path / "t"), 1), _port_tree())


def test_each_package_catches_the_others_corrupt_shard(tmp_path,
                                                       monkeypatch, capsys):
    ckpt.save(str(tmp_path / "p"), 1, _port_tree())
    monkeypatch.setenv("TPUFRAME_FAULTS", "ckpt_shard:kind=corrupt")
    faults.reset_from_env()
    ckpt.save(str(tmp_path / "p"), 2, _port_tree())
    with pytest.raises(IOError, match="CRC"):
        jax_ckpt.restore(str(tmp_path / "p"), 2)
    step, _ = jax_ckpt.CheckpointManager(str(tmp_path / "p")) \
        .restore_latest()
    assert step == 1 and (tmp_path / "p" / "step_00000002.corrupt").is_dir()

    monkeypatch.delenv("TPUFRAME_FAULTS")
    faults.reset_from_env()
    for s in (1, 2):
        jax_ckpt.save(str(tmp_path / "j"), s, _jax_tree())
    shard = tmp_path / "j" / "step_00000002" / "half.shard_0.npy"
    raw = bytearray(shard.read_bytes())
    raw[-1] ^= 0xFF
    shard.write_bytes(bytes(raw))
    with pytest.raises(IOError, match="CRC"):
        ckpt.restore(str(tmp_path / "j"), 2)
    step, tree = ckpt.CheckpointManager(str(tmp_path / "j")).restore_latest()
    assert step == 1
    _assert_trees_equal(tree, _port_tree())
    assert "quarantined" in capsys.readouterr().out


def test_crc_detects_corruption(tmp_path):
    ckpt.save(str(tmp_path), 5, _port_tree())
    victim = next((tmp_path / "step_00000005").glob("*.npy"))
    raw = bytearray(victim.read_bytes())
    raw[-1] ^= 0xFF
    victim.write_bytes(bytes(raw))
    with pytest.raises(IOError, match="CRC"):
        ckpt.restore(str(tmp_path), 5)
    ckpt.restore(str(tmp_path), 5, verify_crc=False)


def test_torn_checkpoint_is_invisible(tmp_path):
    ckpt.save(str(tmp_path), 1, _port_tree())
    torn = tmp_path / "step_00000002"
    torn.mkdir()
    (torn / "manifest.json").write_text("{}")
    assert ckpt.latest_step(str(tmp_path)) == 1
    assert ckpt.in_flight_step(str(tmp_path)) == 2
    with pytest.raises(FileNotFoundError, match="no committed"):
        ckpt.restore(str(tmp_path), 2)
    step, _ = ckpt.CheckpointManager(str(tmp_path)).restore_latest()
    assert step == 1


def test_corrupt_latest_walks_back_and_quarantines(tmp_path, capsys):
    for s in (1, 2):
        ckpt.save(str(tmp_path), s, _port_tree(s))
    shard = next((tmp_path / "step_00000002").glob("*.npy"))
    raw = bytearray(shard.read_bytes())
    raw[len(raw) // 2] ^= 0xFF
    shard.write_bytes(bytes(raw))
    step, tree = ckpt.CheckpointManager(str(tmp_path)).restore_latest(
        target=_port_tree())
    assert step == 1
    _assert_trees_equal(tree, _port_tree(1))
    assert (tmp_path / "step_00000002.corrupt").is_dir()
    assert not (tmp_path / "step_00000002").exists()
    assert ckpt.latest_step(str(tmp_path)) == 1
    assert ckpt.in_flight_step(str(tmp_path)) is None
    assert "quarantined" in capsys.readouterr().out


def test_torn_manifest_walks_back(tmp_path):
    for s in (1, 2):
        ckpt.save(str(tmp_path), s, _port_tree())
    (tmp_path / "step_00000002" / "manifest.json").write_bytes(
        b'{"leaves": {"trunc')
    step, _ = ckpt.CheckpointManager(str(tmp_path)).restore_latest()
    assert step == 1 and (tmp_path / "step_00000002.corrupt").is_dir()


def test_all_checkpoints_bad_returns_none(tmp_path):
    ckpt.save(str(tmp_path), 1, _port_tree())
    for shard in (tmp_path / "step_00000001").glob("*.npy"):
        shard.unlink()
    assert ckpt.CheckpointManager(str(tmp_path)).restore_latest() is None
    assert (tmp_path / "step_00000001.corrupt").is_dir()
    assert ckpt.CheckpointManager(str(tmp_path / "empty")) \
        .restore_latest() is None


def test_structure_mismatch_raises_and_quarantines_nothing(tmp_path):
    ckpt.save(str(tmp_path), 1, _port_tree())
    mgr = ckpt.CheckpointManager(str(tmp_path))
    with pytest.raises(ValueError, match="structure mismatch"):
        mgr.restore_latest(target={"nope": torch.zeros(3)})
    bad_shape = {**_port_tree(), "ids": torch.zeros(7, dtype=torch.int32)}
    with pytest.raises(ValueError, match="shape"):
        mgr.restore_latest(target=bad_shape)
    assert (tmp_path / "step_00000001").is_dir()


def test_retention_keeps_the_newest(tmp_path):
    mgr = ckpt.CheckpointManager(str(tmp_path), every_steps=10, keep=2)
    assert not mgr.should_save(5) and not mgr.should_save(0)
    assert mgr.maybe_save(5, _port_tree()) is None
    for step in (10, 20, 30):
        assert mgr.maybe_save(step, _port_tree()) is not None
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_00000020", "step_00000030"]
    assert ckpt.committed_world(str(tmp_path)) == {
        "step": 30, "processes": 1, "devices": 1}


def test_save_best_keeps_a_single_record(tmp_path):
    mgr = ckpt.CheckpointManager(str(tmp_path), every_steps=10)
    t1, t2 = _port_tree(1), _port_tree(2)
    assert mgr.save_best(10, t1, 1.5) is True
    assert mgr.save_best(20, t2, 2.0) is False
    assert mgr.save_best(30, t2, 0.5) is True
    assert [p.name for p in (tmp_path / "best").iterdir() if p.is_dir()] \
        == ["step_00000030"]
    step, tree = mgr.restore_best(target=t1)
    assert step == 30
    _assert_trees_equal(tree, t2)
    mgr2 = ckpt.CheckpointManager(str(tmp_path / "m2"))
    assert mgr2.save_best(1, t1, 0.7, mode="max") is True
    assert mgr2.save_best(2, t2, 0.6, mode="max") is False
    assert mgr2.restore_best()[0] == 1
    with pytest.raises(ValueError, match="contradicts"):
        mgr2.save_best(3, t1, 0.1, mode="min")
    with pytest.raises(ValueError, match="mode"):
        mgr2.save_best(3, t1, 0.1, mode="best")
    assert ckpt.CheckpointManager(str(tmp_path / "m3")).restore_best() \
        is None


def test_async_save_commits_in_order_and_its_snapshot_holds(tmp_path):
    """The port's in-place hazard on the CPU: the live tensors are updated
    in place right after each save, and the checkpoint still holds the
    values of its own step."""
    mgr = ckpt.CheckpointManager(str(tmp_path), every_steps=10, keep=2,
                                 async_write=True)
    tree = _port_tree()
    saved_w = tree["params"]["w"].clone()
    for step in (10, 20, 30):
        mgr.maybe_save(step, tree)
        with torch.no_grad():
            tree["params"]["w"].add_(1.0)        # the next step, in place
            tree["half"].add_(1.0)
    mgr.wait_pending()
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_00000020", "step_00000030"]
    step, out = mgr.restore_latest(target=tree)
    assert step == 30
    assert torch.equal(out["params"]["w"], saved_w + 2.0)
    assert torch.equal(out["half"], _port_tree()["half"] + 2.0)


def test_flush_commits_and_a_sync_flush_is_trivial(tmp_path):
    mgr = ckpt.CheckpointManager(str(tmp_path), async_write=True)
    mgr.save(1, _port_tree())
    assert mgr.flush(deadline_s=30.0) is True
    assert (tmp_path / "step_00000001" / "COMMIT").exists()
    assert mgr._pending == []
    sync = ckpt.CheckpointManager(str(tmp_path / "s"))
    sync.save(1, _port_tree())
    assert sync.flush(deadline_s=0.0) is True


def test_flush_past_its_deadline_quarantines(tmp_path, monkeypatch, capsys):
    """The worker hangs in its first write (slow_gcs kind hang): flush
    returns within its deadline and leaves nothing that looks durable.
    The hung daemon thread never wakes, so it cannot recreate the
    directory."""
    monkeypatch.setenv("TPUFRAME_FAULTS", "slow_gcs:kind=hang:times=1")
    faults.reset_from_env()
    mgr = ckpt.CheckpointManager(str(tmp_path), async_write=True)
    mgr.save(1, _port_tree())
    t0 = time.perf_counter()
    assert mgr.flush(deadline_s=0.5) is False
    assert time.perf_counter() - t0 < 5.0
    assert (tmp_path / "step_00000001.corrupt").is_dir()
    assert not (tmp_path / "step_00000001").exists()
    assert ckpt.latest_step(str(tmp_path)) is None
    assert ckpt.in_flight_step(str(tmp_path)) is None
    assert mgr._pending == []
    assert "quarantined" in capsys.readouterr().out


def test_crash_during_upload_leaves_a_torn_step(tmp_path, monkeypatch):
    """The crash seam between the shard files and the sidecar (its
    ``os._exit`` replaced by an exception, to keep the test process): the
    files are on disk, nothing acknowledges them, resume never sees the
    step."""
    def crash(rc):
        raise RuntimeError(f"process exited {rc}")

    monkeypatch.setattr(faults.os, "_exit", crash)
    mgr = ckpt.CheckpointManager(str(tmp_path), async_write=True)
    mgr.save(1, _port_tree())
    mgr.wait_pending()
    monkeypatch.setenv("TPUFRAME_FAULTS", "crash_during_upload")
    faults.reset_from_env()
    mgr.save(2, _port_tree())
    with pytest.raises(RuntimeError, match="save step 2.*exited 42"):
        mgr.wait_pending()
    torn = tmp_path / "step_00000002"
    assert list(torn.glob("*.npy")) and not (torn / "crc_0.json").exists()
    assert not (torn / "COMMIT").exists()
    assert ckpt.latest_step(str(tmp_path)) == 1
    assert ckpt.in_flight_step(str(tmp_path)) == 2
    assert mgr.restore_latest()[0] == 1


def test_storage_faults_are_retried_under_a_save(tmp_path, monkeypatch):
    monkeypatch.setenv("TPUFRAME_FAULTS", "gcs_write:kind=ioerror:times=2,"
                                          "gcs_read:kind=ioerror")
    faults.reset_from_env()
    monkeypatch.setattr(ckpt_mod.gcs._POLICY, "sleep", lambda s: None)
    policy.COUNTERS.clear()
    ckpt.save(str(tmp_path), 1, _port_tree())
    _assert_trees_equal(ckpt.restore(str(tmp_path), 1), _port_tree())
    assert policy.counters("retry.gcs_write") == {
        "retry.gcs_write.retries": 2, "retry.gcs_write.recovered": 1}
    assert policy.counters("retry.gcs_read.retries") == {
        "retry.gcs_read.retries": 1}


def test_events_validate_in_the_jax_schema(tmp_path, monkeypatch):
    """ckpt_save (sync and async), ckpt_restore, fault_injected, retry and
    preempt, as the port emits them, pass the JAX package's validator and
    read back through both packages' readers."""
    assert events.emit("ckpt_save", step=0) is None     # no log: no-op
    log = events.init(str(tmp_path / "ev"))
    assert events.enabled() and events.get() is log
    monkeypatch.setenv("TPUFRAME_FAULTS", "gcs_read:kind=ioerror")
    faults.reset_from_env()
    monkeypatch.setattr(ckpt_mod.gcs._POLICY, "sleep", lambda s: None)
    ckpt.CheckpointManager(str(tmp_path / "ck")).save(1, _port_tree())
    amgr = ckpt.CheckpointManager(str(tmp_path / "ck"), async_write=True)
    amgr.save(2, _port_tree())
    amgr.wait_pending()
    amgr.restore_latest()
    with PreemptionGuard() as guard:
        guard._handle(15, None)
    events.close()
    assert not events.enabled()
    recs = events.merge(str(tmp_path / "ev"))
    assert recs == jax_events.merge(str(tmp_path / "ev"))
    assert [r["type"] for r in recs] == [
        "fault_injected", "retry", "retry", "ckpt_save", "ckpt_save",
        "ckpt_restore", "preempt"]
    for rec in recs:
        assert jax_events.validate_record(rec) == [], rec
        assert events.validate_record(rec) == []
        assert rec["schema"] == jax_events.SCHEMA_VERSION
    saves = [r for r in recs if r["type"] == "ckpt_save"]
    assert [r["async_write"] for r in saves] == [False, True]
    assert saves[1]["write_ms"] <= saves[1]["ms"]
    assert events.REQUIRED_FIELDS == jax_events.REQUIRED_FIELDS
    assert events.validate_record({"type": "nope"}) != []


def test_optimizer_load_state_dict_refuses_another_optimizers_state():
    state = _toy_state()
    sd = state.opt.state_dict()
    with pytest.raises(ValueError, match="optimizer state holds"):
        state.opt.load_state_dict({"count": 1, "mu": sd["trace"],
                                   "nu": sd["trace"]})
    with pytest.raises(ValueError, match="parameters differ"):
        state.opt.load_state_dict({"count": 1, "trace": {}})
    bad = dict(sd["trace"])
    bad["fc2.bias"] = torch.zeros(3)
    with pytest.raises(ValueError, match="fc2.bias: shape"):
        state.opt.load_state_dict({"count": 1, "trace": bad})
