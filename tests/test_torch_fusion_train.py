"""The port's trainer with ``TPUFRAME_FUSION_THRESHOLD`` against the JAX
harness's step with ``fusion_threshold``, the run event, and the program
check.

Step parity: a 2-rank gloo world of the port's step (``fusion_threshold``
set: the staged pass on gradient hooks, then the statistics and metrics
through ``fused_mean_``) against the JAX step on a data=2 mesh of virtual
CPU devices with the same threshold (``staged_pmean``), for two models:

  - the tiny Bottleneck ResNet of ``test_torch_image_train.py`` (both of
    the port's BN modes against the JAX ``bn="flax"`` model), two steps
    of nesterov SGD; losses within 1e-5, parameters and running
    statistics within 1e-5 absolute (that file's tolerances: f32
    summation order only);
  - the tiny LM of ``lm_smoke`` (f32, adamw), two steps.  With a
    threshold both harnesses differentiate a local loss (no collective
    inside it) and average the gradients; with no ``-100`` labels that is
    the global valid-token mean.  Losses within 1e-5, parameters within
    1e-5 absolute (``test_torch_train.py``'s f32 tolerances).

The trainer runs: ``fusion_threshold`` run events; ``TPUFRAME_CHECK_SPMD=1``
with the ranks' thresholds differing exits non-zero on both ranks with the
divergence message before step 1, and with equal thresholds trains.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tpuframe import models as jax_models  # noqa: E402
from tpuframe import train as jax_train  # noqa: E402
from tpuframe.models import resnet as jax_resnet  # noqa: E402
from tpuframe.parallel import mesh as jax_mesh  # noqa: E402
from tpuframe.parallel import step as jax_step  # noqa: E402
from tpuframe.utils import build_optimizer as jax_build_optimizer  # noqa: E402
from tpuframe.utils.config import TrainConfig as JaxTrainConfig  # noqa: E402
from tpuframe_torch import train as port_train  # noqa: E402
from tpuframe_torch.data import datasets  # noqa: E402
from tpuframe_torch.launch.launcher import LocalCluster  # noqa: E402
from tpuframe_torch.models.convert import (params_from_jax,  # noqa: E402
                                           resnet_from_jax)
from tpuframe_torch.obs import events  # noqa: E402
from tpuframe_torch.parallel import fusion  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# small enough that each model's gradients span several buckets
THRESHOLD = 4096
IMG = {"image_size": 32, "synthetic_size": 64, "num_classes": 4}
LM_DATA = {"seq_len": 32, "vocab_size": 64, "synthetic_size": 16}


def _img_cfg(bn):
    return dict(name="img", model="resnet50", model_kwargs={"bn": bn},
                dataset="imagenet", dataset_kwargs=IMG, optimizer="sgd",
                base_lr=0.4, warmup_steps=1, schedule="cosine",
                weight_decay=1e-4, label_smoothing=0.1, global_batch=8,
                total_steps=10, augment="none")


def _lm_cfg():
    return dict(name="lm", model="transformer-lm",
                model_kwargs={"tiny": True, "vocab_size": 64},
                dataset="lm_text", dataset_kwargs=LM_DATA,
                optimizer="adamw", base_lr=3e-3,
                scale_lr_by_batch=False, schedule="constant", global_batch=4,
                weight_decay=0.1, grad_clip_norm=1.0)


def _jax_image_steps(monkeypatch):
    """Two JAX harness steps of the tiny ResNet on a data=2 mesh with
    ``fusion_threshold``: (losses, final state_dict, init state_dict)."""
    monkeypatch.setenv(fusion.ENV_VAR, str(THRESHOLD))
    model = jax_resnet.ResNet(stage_sizes=(1, 1),
                              block_cls=jax_resnet.Bottleneck, num_classes=4,
                              width=8, bn="flax")
    v = jax.tree.map(np.asarray, model.init(
        jax.random.key(0), jnp.zeros((2, 32, 32, 3)), train=True))
    jcfg = JaxTrainConfig(**_img_cfg("flax"))
    tx = jax_build_optimizer(jcfg, v["params"])
    state = jax_step.TrainState.create(
        v["params"], tx, model_state={"batch_stats": v["batch_stats"]})
    mesh = jax_mesh.make_mesh(jax_mesh.MeshSpec(data=2),
                              devices=jax.devices()[:2])
    step = jax_step.make_train_step(jax_train.make_loss_fn(jcfg, model), tx,
                                    mesh, donate=False,
                                    fusion_threshold=THRESHOLD)
    train, _ = datasets.imagenet(None, **IMG)
    losses = []
    for i in range(2):
        b = train[np.arange(8 * i, 8 * i + 8)]
        state, m = step(state, {k: jnp.asarray(x) for k, x in b.items()})
        losses.append(float(m["loss"]))
    final = resnet_from_jax(jax.tree.map(np.asarray, state.params),
                            jax.tree.map(np.asarray,
                                         state.model_state["batch_stats"]))
    return losses, final, resnet_from_jax(v["params"], v["batch_stats"])


def _jax_lm_steps(monkeypatch):
    """Two JAX harness steps of the tiny LM on a data=2 mesh with
    ``fusion_threshold`` (the knob set, so the JAX loss is local too):
    (losses, final params as the port's state_dict, init)."""
    monkeypatch.setenv(fusion.ENV_VAR, str(THRESHOLD))
    jcfg = JaxTrainConfig(**_lm_cfg())
    model = jax_models.get_model("transformer-lm", dtype=jnp.float32,
                                 **jcfg.model_kwargs)
    params = jax.tree.map(np.asarray, model.init(
        jax.random.key(0), jnp.zeros((1, 32), jnp.int32))["params"])
    tx = jax_build_optimizer(jcfg, params)
    state = jax_step.TrainState.create(params, tx)
    mesh = jax_mesh.make_mesh(jax_mesh.MeshSpec(data=2, seq=1),
                              devices=jax.devices()[:2])
    step = jax_step.make_train_step(jax_train.make_loss_fn(jcfg, model), tx,
                                    mesh, donate=False,
                                    fusion_threshold=THRESHOLD)
    train, _ = datasets.lm_text(None, **LM_DATA)
    losses = []
    for i in range(2):
        b = train[np.arange(4 * i, 4 * i + 4)]
        state, m = step(state, {k: jnp.asarray(x) for k, x in b.items()})
        losses.append(float(m["loss"]))
    return (losses, params_from_jax(jax.tree.map(np.asarray, state.params)),
            params_from_jax(params))


# One rank of the 2-rank gloo world: each case's two steps with the
# threshold, on this rank's half of each batch.  Rank 0 writes the
# losses, the state and the reducer's counts.
_DP_WORKER = r"""
import json, os, sys
import numpy as np
import torch
import torch.distributed as dist
from tpuframe_torch import train as port_train
from tpuframe_torch.data import datasets
from tpuframe_torch.models import resnet as port_resnet
from tpuframe_torch.models import transformer_lm as torch_lm
from tpuframe_torch.parallel import step as port_step
from tpuframe_torch.utils.config import TrainConfig
from tpuframe_torch.utils.optim import build_optimizer

rank, port, out, cases = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
threshold = int(os.environ["TPUFRAME_FUSION_THRESHOLD"])
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        world_size=2, rank=rank)
calls = [0]
_real = dist.all_reduce


def _counting(*a, **k):
    calls[0] += 1
    return _real(*a, **k)


dist.all_reduce = _counting
result = {}
for case in json.loads(cases):
    cfg = TrainConfig(**case["cfg"])
    if case["kind"] == "image":
        ds, _ = datasets.imagenet(None, **cfg.dataset_kwargs)
        model = port_resnet.ResNet((1, 1), port_resnet.Bottleneck,
                                   num_classes=4, width=8,
                                   bn=cfg.model_kwargs["bn"], device="cpu")
        rows = lambda i: np.arange(8 * i + 4 * rank, 8 * i + 4 * rank + 4)
    else:
        ds, _ = datasets.lm_text(None, **cfg.dataset_kwargs)
        model = torch_lm.TransformerLM(torch_lm.LMConfig.tiny(vocab_size=64),
                                       device="cpu")
        rows = lambda i: np.arange(4 * i + 2 * rank, 4 * i + 2 * rank + 2)
    model.load_state_dict(torch.load(case["init"]))
    state = port_step.TrainState(model, build_optimizer(cfg, model))
    step = port_step.make_train_step(port_train.make_loss_fn(cfg),
                                     fusion_threshold=threshold)
    losses, counts = [], []
    for i in range(2):
        calls[0] = 0
        m = step(state, {k: torch.from_numpy(v)
                         for k, v in ds[rows(i)].items()})
        losses.append(float(m["loss"]))
        counts.append({"calls": calls[0], "early": step.reducer.early,
                       "buckets": len(step.reducer.buckets)})
    result[case["name"]] = {"losses": losses, "counts": counts, "state": {
        k: v.tolist() for k, v in model.state_dict().items()}}
if rank == 0:
    with open(out, "w") as f:
        json.dump(result, f)
dist.destroy_process_group()
"""


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """The JAX steps and the port's 2-rank run of every case."""
    mp = pytest.MonkeyPatch()
    try:
        img = _jax_image_steps(mp)
        lm = _jax_lm_steps(mp)
    finally:
        mp.undo()
    root = tmp_path_factory.mktemp("fusion_train")
    torch.save(img[2], root / "img.pt")
    torch.save(lm[2], root / "lm.pt")
    cases = [{"name": f"image-{bn}", "kind": "image", "cfg": _img_cfg(bn),
              "init": str(root / "img.pt")} for bn in ("flax", "fused")]
    cases.append({"name": "lm", "kind": "lm", "cfg": _lm_cfg(),
                  "init": str(root / "lm.pt")})
    out = root / "rank0.json"
    port = str(_free_port())
    env = {**os.environ, "PYTHONPATH": REPO,
           fusion.ENV_VAR: str(THRESHOLD)}
    procs = [subprocess.Popen(
        [sys.executable, "-c", _DP_WORKER, str(r), port, str(out),
         json.dumps(cases)], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(2)]
    for p in procs:
        _, err = p.communicate(timeout=240)
        assert p.returncode == 0, err
    got = json.loads(out.read_text())
    want = {"image-flax": img, "image-fused": img, "lm": lm}
    return got, want


def _assert_state_close(got: dict, want: dict):
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(np.asarray(got[k]), w.numpy(), atol=1e-5,
                                   rtol=0, err_msg=k)


@pytest.mark.parametrize("name", ["image-flax", "image-fused", "lm"])
def test_two_rank_fused_steps_match_the_jax_data2_mesh(two_ranks, name):
    got, want = two_ranks
    losses, final, _ = want[name]
    np.testing.assert_allclose(got[name]["losses"], losses, atol=1e-5,
                               rtol=0)
    if name == "lm":
        got_state = {k: v for k, v in got[name]["state"].items()
                     if k in final}
        assert set(final) <= set(got[name]["state"])
        _assert_state_close(got_state, final)
    else:
        _assert_state_close(got[name]["state"], final)


@pytest.mark.parametrize("name", ["image-flax", "image-fused", "lm"])
def test_a_fused_step_is_one_collective_a_bucket(two_ranks, name):
    """Each step: the gradient buckets, then one bucket of statistics and
    metrics (all f32 and under the threshold here); buckets start inside
    the backward."""
    got, _ = two_ranks
    for counts in got[name]["counts"]:
        assert counts["buckets"] > 1
        assert counts["calls"] == counts["buckets"] + 1
        assert 1 <= counts["early"] <= counts["buckets"]


@pytest.fixture
def clean(monkeypatch):
    for var in (events.ENV_DIR, fusion.ENV_VAR, "TPUFRAME_CHECK_SPMD",
                "TPUFRAME_FAULTS", "TPUFRAME_ATTEMPT"):
        monkeypatch.delenv(var, raising=False)
    yield monkeypatch
    events.close()


@pytest.mark.parametrize("knob", [None, "65536"])
def test_fusion_threshold_run_event(clean, tmp_path, knob):
    if knob is not None:
        clean.setenv(fusion.ENV_VAR, knob)
    clean.setenv(events.ENV_DIR, str(tmp_path))
    cfg = port_train.get_config("mnist_single").with_overrides(
        total_steps=1, global_batch=8, eval_every=1, eval_batches=1,
        dataset_kwargs={"synthetic_size": 64})
    port_train.train(cfg, device="cpu")
    recs = [r for r in events.merge(str(tmp_path))
            if r["type"] == "fusion_threshold"]
    want = ((None, "default") if knob is None else (int(knob), "env"))
    assert [(r["threshold"], r["source"]) for r in recs] == [want]


def test_padded_docs_are_refused_with_a_threshold(clean):
    clean.setenv(fusion.ENV_VAR, "65536")
    cfg = port_train.get_config("lm_smoke").with_overrides(
        mesh={"data": 1, "seq": 1},
        dataset_kwargs={**LM_DATA, "padded_docs": True})
    with pytest.raises(ValueError, match="padded_docs with "
                                         "TPUFRAME_FUSION_THRESHOLD"):
        port_train.make_loss_fn(cfg)
    clean.delenv(fusion.ENV_VAR)
    port_train.make_loss_fn(cfg)


def test_adasum_with_the_knob_is_refused(clean):
    clean.setenv(fusion.ENV_VAR, "65536")
    cfg = port_train.get_config("smoke").with_overrides(
        mesh={"data": 1}, grad_reduce="adasum",
        dataset_kwargs={"synthetic_size": 64})
    with pytest.raises(ValueError, match="adasum.*fusion_threshold"):
        port_train.build_harness(cfg, device="cpu")


# A rank of the program-check run: this rank's threshold from argv, then
# the trainer.
_SPMD_WORKER = r"""
import os, sys
rank = int(os.environ["TPUFRAME_PROCESS_ID"])
os.environ["TPUFRAME_FUSION_THRESHOLD"] = sys.argv[1 + rank]
from tpuframe_torch import train
train.main(["--config", "smoke", "--device", "cpu", "--set",
            'mesh={"data": 2}', "--set", "total_steps=2", "--set",
            'dataset_kwargs={"synthetic_size": 64}', "--set",
            "global_batch=8", "--set", "eval_every=2", "--set",
            "eval_batches=1"])
print("TRAINED", flush=True)
"""


@pytest.mark.parametrize("thresholds", [("65536", "65536"),
                                        ("65536", "4096")],
                         ids=["equal", "divergent"])
def test_check_spmd_catches_a_divergent_threshold(thresholds):
    cluster = LocalCluster(2, timeout=180, extra_env={
        "PYTHONPATH": REPO, "TPUFRAME_CHECK_SPMD": "1",
        "TPUFRAME_DIST_BACKEND": "gloo"})
    argv = [sys.executable, "-c", _SPMD_WORKER, *thresholds]
    if thresholds[0] == thresholds[1]:
        results = cluster.launch(argv)
        assert all("TRAINED" in r.stdout for r in results)
        return
    with pytest.raises(RuntimeError) as e:
        cluster.launch(argv)
    msg = str(e.value)
    for r in range(2):
        assert f"--- rank {r} (exit 1) ---" in msg
    assert msg.count("SPMD divergence in 'train_step:program'") == 2
    assert "[train 1]" not in msg and "TRAINED" not in msg
