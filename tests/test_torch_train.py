"""tpuframe_torch's training slice against the JAX package's.

Step parity: the JAX harness's own pieces (``tpuframe.train.make_loss_fn``,
``tpuframe.utils.build_optimizer``, ``step.make_train_step(mesh=None)``)
train a tiny LM (``attn_impl="pallas"`` in interpret mode, ``remat``) for
five steps; the port trains the same flax init (``params_from_jax``) on the
same batches.  Losses, parameters and Adam moments are compared.  Each JAX
step is built once for the module.

Tolerances.  f32: 1e-5 absolute; the two differ in summation order only.
bf16: the frameworks round the bf16 activations at other places (flax's
GELU runs its arithmetic in bf16, the port's in f32 with one rounding;
matmul accumulation orders differ), which moves the loss by ~1e-3 and
Adam's sign-like updates of the smallest gradients; so losses within 5e-3,
and the parameter updates and moments within 5% in relative L2.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from tpuframe import models as jax_models  # noqa: E402
from tpuframe import train as jax_train  # noqa: E402
from tpuframe.parallel import step as jax_step  # noqa: E402
from tpuframe.utils import build_optimizer as jax_build_optimizer  # noqa: E402
from tpuframe.utils.config import TrainConfig as JaxTrainConfig  # noqa: E402
from tpuframe_torch import models as port_models  # noqa: E402
from tpuframe_torch import train as port_train  # noqa: E402
from tpuframe_torch.data import datasets  # noqa: E402
from tpuframe_torch.models import transformer_lm as torch_lm  # noqa: E402
from tpuframe_torch.models.convert import (adam_state_from_jax,  # noqa: E402
                                           params_from_jax)
from tpuframe_torch.parallel import step as port_step  # noqa: E402
from tpuframe_torch.utils.config import TrainConfig  # noqa: E402
from tpuframe_torch.utils.optim import build_optimizer  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 5
MODEL_KW = {"tiny": True, "vocab_size": 64, "attn_impl": "pallas",
            "remat": True}


def _common(fused, dtype):
    # bf16 runs at a learning rate whose updates lie below a bf16 step of
    # the weights: only f32 master weights keep them.
    return dict(name="parity", model="transformer-lm", model_kwargs=MODEL_KW,
                dataset="lm_text",
                dataset_kwargs={"seq_len": 64, "vocab_size": 64,
                                "synthetic_size": 64},
                optimizer="adamw",
                base_lr=3e-3 if dtype == "float32" else 1e-5,
                scale_lr_by_batch=False, warmup_steps=2, schedule="cosine",
                weight_decay=0.1, grad_clip_norm=1.0, global_batch=4,
                total_steps=10, compute_dtype=dtype, fused_xent=fused)


def _batches():
    train_ds, _ = datasets.lm_text(None, seq_len=64, vocab_size=64,
                                   synthetic_size=64)
    return [train_ds[np.arange(4 * i, 4 * i + 4)] for i in range(STEPS)]


def _tree_np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module", params=[(True, "float32"),
                                        (False, "float32"),
                                        (True, "bfloat16"),
                                        (False, "bfloat16")],
                ids=["fused-f32", "dense-f32", "fused-bf16", "dense-bf16"])
def runs(request):
    """Both packages' five steps from one init: (jax, port) dicts."""
    fused, dtype = request.param
    common = _common(fused, dtype)
    jcfg = JaxTrainConfig(**common)
    model = jax_models.get_model("transformer-lm", dtype=jnp.dtype(dtype),
                                 **MODEL_KW)
    params = model.init(jax.random.key(0),
                        jnp.zeros((1, 64), jnp.int32))["params"]
    tx = jax_build_optimizer(jcfg, params)
    state = jax_step.TrainState.create(params, tx)
    step = jax_step.make_train_step(jax_train.make_loss_fn(jcfg, model), tx,
                                    None, donate=False)
    batches = _batches()
    jax_losses = []
    for b in batches:
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
        jax_losses.append(float(m["loss"]))

    init = params_from_jax(_tree_np(params))
    cfg = TrainConfig(**common)
    lm = torch_lm.TransformerLM(
        torch_lm.LMConfig.tiny(**{k: v for k, v in MODEL_KW.items()
                                  if k != "tiny"}, dtype=dtype),
        device="cpu")
    lm.load_state_dict(init)
    pstate = port_step.TrainState(lm, build_optimizer(cfg, lm))
    train_step = port_step.make_train_step(port_train.make_loss_fn(cfg))
    port_losses = [float(train_step(pstate, {k: torch.from_numpy(v)
                                             for k, v in b.items()})["loss"])
                   for b in batches]
    opt = state.opt_state
    return dtype, init, {
        "losses": np.array(jax_losses),
        "params": params_from_jax(_tree_np(state.params)),
        "adam": adam_state_from_jax(
            _tree_np(optax.tree_utils.tree_get(opt, "mu")),
            _tree_np(optax.tree_utils.tree_get(opt, "nu")), STEPS),
    }, {
        "losses": np.array(port_losses),
        "params": lm.state_dict(),
        "adam": pstate.opt.state_dict(),
        "dtypes": {p.dtype for p in lm.parameters()},
    }


def _rel_l2(got: dict, want: dict, base: dict | None = None) -> float:
    num = den = 0.0
    for k, w in want.items():
        g = got[k]
        if base is not None:
            g, w = g - base[k], w - base[k]
        num += float((g - w).double().square().sum())
        den += float(w.double().square().sum())
    return (num / den) ** 0.5


def test_losses_match_jax(runs):
    dtype, _, want, got = runs
    atol = 1e-5 if dtype == "float32" else 5e-3
    np.testing.assert_allclose(got["losses"], want["losses"], atol=atol,
                               rtol=0)


def test_params_and_adam_moments_match_jax(runs):
    dtype, init, want, got = runs
    assert got["adam"]["count"] == want["adam"]["count"] == STEPS
    if dtype == "float32":
        for k, w in want["params"].items():
            np.testing.assert_allclose(got["params"][k].numpy(), w.numpy(),
                                       atol=1e-5, rtol=0, err_msg=k)
        for moment in ("mu", "nu"):
            for k, w in want["adam"][moment].items():
                np.testing.assert_allclose(
                    got["adam"][moment][k].numpy(), w.numpy(), atol=1e-5,
                    rtol=0, err_msg=f"{moment} {k}")
    else:
        assert _rel_l2(got["params"], want["params"], init) < 0.05
        for moment in ("mu", "nu"):
            assert _rel_l2(got["adam"][moment], want["adam"][moment]) < 0.05


def test_bf16_step_moves_the_f32_master_weights(runs):
    """Every parameter stays f32 under a bf16 config, and the step's
    updates (at lr <= 1e-5, below a bf16 step of almost every weight)
    are kept: stored in bf16 they would have been dropped."""
    dtype, init, want, got = runs
    assert got["dtypes"] == {torch.float32}
    if dtype != "bfloat16":
        return
    moved = total = lost = 0
    for k, w in got["params"].items():
        if k == "final_ln.weight" or k.endswith("_ln.weight"):
            continue
        d = w - init[k]
        moved += int((d != 0).sum())
        total += d.numel()
        lost += int((w.bfloat16() == init[k].bfloat16()).sum())
        # the port's update follows the JAX step's, in sign
        wd = want["params"][k] - init[k]
        agree = (torch.sign(d) == torch.sign(wd)).float().mean()
        assert agree > 0.95, k
    assert moved / total > 0.9
    assert lost / total > 0.9


def test_remat_recompute_draws_the_same_dropout_masks():
    """Masks come from (dropout_seed, layer, site) inside each block, so
    the checkpoint's recompute sees the mask the forward drew: grads with
    remat equal grads without it."""
    torch.manual_seed(0)
    ids = torch.randint(0, 512, (2, 32))
    grads = {}
    for remat in (False, True):
        lm = torch_lm.TransformerLM(torch_lm.LMConfig.tiny(
            dropout=0.1, remat=remat, attn_impl="pallas"), device="cpu")
        loss = lm(ids, train=True, dropout_seed=7).square().mean()
        loss.backward()
        grads[remat] = (float(loss.detach()), [p.grad.clone() for p in
                                      lm.parameters()])
    assert grads[False][0] == grads[True][0]
    for a, b in zip(grads[False][1], grads[True][1]):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)
    with torch.no_grad():
        other = float(lm(ids, train=True, dropout_seed=8).square().mean())
        plain = float(lm(ids).square().mean())
    assert other != grads[True][0] and plain != grads[True][0]
    with pytest.raises(ValueError, match="dropout_seed"):
        lm(ids, train=True)


# A worker of the 2-rank gloo run: rank r of 2 steps on its half of each
# batch.  Rank 0 writes its losses and parameters.
_DP_WORKER = r"""
import json, sys
import numpy as np
import torch
import torch.distributed as dist
from tpuframe_torch import train as port_train
from tpuframe_torch.data import datasets
from tpuframe_torch.models import transformer_lm as torch_lm
from tpuframe_torch.parallel import step as port_step
from tpuframe_torch.utils.config import TrainConfig
from tpuframe_torch.utils.optim import build_optimizer

rank, port, out, cases = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        world_size=2, rank=rank)
result = {}
for case in json.loads(cases):
    cfg = TrainConfig(**case["cfg"])
    ds, _ = datasets.lm_text(None, **cfg.dataset_kwargs)
    lm = torch_lm.TransformerLM(torch_lm.LMConfig.tiny(
        vocab_size=64, attn_impl="pallas"), device="cpu", seed=0)
    state = port_step.TrainState(lm, build_optimizer(cfg, lm))
    step = port_step.make_train_step(port_train.make_loss_fn(cfg))
    losses = []
    for i in range(2):
        rows = np.arange(4 * i, 4 * i + 4)[2 * rank:2 * rank + 2]
        m = step(state, {k: torch.from_numpy(v) for k, v in ds[rows].items()})
        losses.append(float(m["loss"]))
    result[case["name"]] = {"losses": losses, "params": {
        k: v.tolist() for k, v in lm.state_dict().items()}}
if rank == 0:
    with open(out, "w") as f:
        json.dump(result, f)
dist.destroy_process_group()
"""


def _dp_cases():
    base = dict(name="dp", model="transformer-lm", dataset="lm_text",
                optimizer="adamw", base_lr=3e-3, scale_lr_by_batch=False,
                schedule="constant", global_batch=4, weight_decay=0.1,
                grad_clip_norm=1.0)
    kw = {"seq_len": 32, "vocab_size": 64, "synthetic_size": 16}
    return [{"name": "packed-dense", "cfg": dict(
                base, dataset_kwargs=kw, fused_xent=False)},
            {"name": "padded-fused", "cfg": dict(
                base, dataset_kwargs=dict(kw, padded_docs=True),
                fused_xent=True)}]


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_rank_gloo_step_equals_one_rank_step(tmp_path):
    """Two ranks on half a batch each take the same steps as one rank on
    the whole batch, with padded documents too: the valid-token mean is
    global (its numerator and denominator summed over the world), not a
    mean of per-rank means."""
    cases = _dp_cases()
    out = tmp_path / "rank0.json"
    port = str(_free_port())
    env = {**os.environ, "PYTHONPATH": REPO}
    procs = [subprocess.Popen(
        [sys.executable, "-c", _DP_WORKER, str(r), port, str(out),
         json.dumps(cases)], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(2)]
    for p in procs:
        _, err = p.communicate(timeout=240)
        assert p.returncode == 0, err
    two = json.loads(out.read_text())

    for case in cases:
        cfg = TrainConfig(**case["cfg"])
        ds, _ = datasets.lm_text(None, **cfg.dataset_kwargs)
        if cfg.dataset_kwargs.get("padded_docs"):
            # the halves hold unequal valid-token counts
            c = (ds.columns["labels"][:8] != -100).sum(-1).reshape(2, 2, 2)
            assert (c[:, 0].sum(-1) != c[:, 1].sum(-1)).any()
        lm = torch_lm.TransformerLM(torch_lm.LMConfig.tiny(
            vocab_size=64, attn_impl="pallas"), device="cpu", seed=0)
        state = port_step.TrainState(lm, build_optimizer(cfg, lm))
        step = port_step.make_train_step(port_train.make_loss_fn(cfg))
        losses = [float(step(state, {k: torch.from_numpy(v) for k, v in
                                     ds[np.arange(4 * i, 4 * i + 4)].items()})
                        ["loss"]) for i in range(2)]
        got = two[case["name"]]
        np.testing.assert_allclose(got["losses"], losses, atol=1e-6, rtol=0)
        for k, w in lm.state_dict().items():
            # f32 summation order only, through Adam's normalised update
            np.testing.assert_allclose(np.array(got["params"][k]), w.numpy(),
                                       atol=1e-5, rtol=0, err_msg=k)


def test_harness_trains_lm_smoke_on_the_cpu(capsys):
    metrics = port_train.main([
        "--config", "lm_smoke", "--device", "cpu",
        "--set", 'mesh={"data": 1, "seq": 1}', "--set", "total_steps=20",
        "--set", "log_every=5"])
    out = capsys.readouterr().out
    assert "[tpuframe] lm_smoke: model=transformer-lm" in out
    assert "[train 20]" in out and "[eval 20]" in out and "done in" in out
    losses = metrics["losses"]
    assert len(losses) == 20 and metrics["step"] == 20
    assert np.mean(losses[-5:]) < 0.7 * np.mean(losses[:5])
    assert np.isfinite(metrics["eval_loss"])


def test_harness_never_falls_back_to_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the default device is usable")
    cfg = port_train.get_config("lm_smoke").with_overrides(
        mesh={"data": 1, "seq": 1})
    with pytest.raises(RuntimeError, match="no GPU is visible"):
        port_train.build_harness(cfg)


@pytest.mark.parametrize("name,kwargs", [
    ("convnet", {}), ("resnet50", {"bn": "folded"}),
    ("resnet50", {"stem": "space_to_depth"}), ("resnet18", {"remat": True})])
def test_new_models_never_fall_back_to_the_cpu(name, kwargs):
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the default device is usable")
    with pytest.raises(RuntimeError, match="no GPU is visible"):
        port_models.get_model(name, **kwargs)


@pytest.mark.parametrize("name", ["mnist_single", "cifar10_resnet18"])
def test_image_workloads_never_fall_back_to_the_cpu(name):
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the default device is usable")
    cfg = port_train.get_config(name).with_overrides(mesh={"data": 1})
    with pytest.raises(RuntimeError, match="no GPU is visible"):
        port_train.build_harness(cfg)


# A rank of a 2-rank gloo world that trains mnist_single (distributed=False)
# with every collective made to raise; each rank writes its losses.
_SOLO_WORKER = r"""
import json, sys
import torch.distributed as dist
from tpuframe_torch import train as port_train

rank, port, out, overrides = (int(sys.argv[1]), sys.argv[2], sys.argv[3],
                              json.loads(sys.argv[4]))
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        world_size=2, rank=rank)


def refuse(*args, **kwargs):
    raise AssertionError("a collective ran in a distributed=False step")


for verb in ("all_reduce", "broadcast", "all_gather", "reduce_scatter"):
    setattr(dist, verb, refuse)
cfg = port_train.get_config("mnist_single").with_overrides(**overrides)
metrics = port_train.train(cfg, device="cpu")
with open(f"{out}.{rank}", "w") as f:
    json.dump(metrics["losses"], f)
"""


def test_distributed_false_trains_with_no_collective(tmp_path):
    """mnist_single is the JAX harness's config-1 path: one device, no
    mesh, no collective.  In a 2-rank process group each rank trains the
    whole batch alone, with collectives patched to raise, and takes the
    steps a process with no group takes."""
    overrides = {"global_batch": 16, "total_steps": 3, "eval_every": 3,
                 "eval_batches": 1, "dataset_kwargs": {"synthetic_size": 64}}
    out = tmp_path / "losses"
    port = str(_free_port())
    env = {**os.environ, "PYTHONPATH": REPO}
    procs = [subprocess.Popen(
        [sys.executable, "-c", _SOLO_WORKER, str(r), port, str(out),
         json.dumps(overrides)], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(2)]
    for p in procs:
        _, err = p.communicate(timeout=240)
        assert p.returncode == 0, err
    cfg = port_train.get_config("mnist_single").with_overrides(**overrides)
    assert not cfg.distributed
    want = port_train.train(cfg, device="cpu")["losses"]
    for r in range(2):
        got = json.loads((tmp_path / f"losses.{r}").read_text())
        assert got == want, r


@pytest.mark.parametrize("overrides,env,world,match", [
    # ZeRO-1 is ported; its int8 DCN leg, like any DCN wire, is not
    pytest.param({}, {"TPUFRAME_WEIGHT_UPDATE": "zero1",
                      "TPUFRAME_WIRE_FORMAT_DCN": "int8-block"}, 1,
                 "DCN leg.*hierarchical", id="overrides0-env0-1-ZeRO-1"),
    pytest.param({}, {"TPUFRAME_WIRE_FORMAT_DCN": "int8-block"}, 1,
                 "DCN leg.*hierarchical", id="dcn-wire-leg"),
    ({}, {"TPUFRAME_HIER": "hier"}, 1, "hierarchical"),
    ({}, {"HOROVOD_FUSION_THRESHOLD": "67108864"}, 1, "bucketed fusion"),
    # fsdp is ported for the LM, BERT and the image models; the
    # layer-stacked LM under it is not (the case keeps its id)
    pytest.param({"mesh": {"data": 1, "fsdp": 2},
                  "model": "transformer-lm-pp"}, {}, 2, "sharded state",
                 id="overrides4-env4-2-sharded state"),
    # sequence parallelism is ported; a seq mesh with sharded state is not
    # (the case keeps its id)
    pytest.param({"mesh": {"data": 1, "seq": 2, "fsdp": 2}}, {}, 4,
                 "sharded state",
                 id="overrides5-env5-4-sequence parallelism"),
    ({}, {"TPUFRAME_REMAT_POLICY": "dots"}, 1, "remat policies.*item 14"),
    ({}, {"TPUFRAME_BENCH_REMAT": "1"}, 1, "remat policies.*item 14"),
    ({}, {"TPUFRAME_PROFILER_PORT": "9012"}, 1, "profiler server.*item 11"),
])
def test_unported_features_refuse_loudly(overrides, env, world, match,
                                         monkeypatch):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    cfg = port_train.get_config("lm_smoke").with_overrides(
        mesh={"data": 1, "seq": 1}).with_overrides(**overrides)
    with pytest.raises(NotImplementedError, match=match):
        port_train._refuse_unported(cfg, world)


@pytest.mark.parametrize("config,world,want", [
    ("lm_smoke", 8, {"data": 2, "seq": 4}),
    ("lm_smoke", 4, {"data": 1, "seq": 4}),
    ("lm_long", 4, {"data": 2, "seq": 2}),
])
def test_sequence_parallel_meshes_are_ported(config, world, want):
    """A seq degree above 1 now passes: the mesh degrees come back."""
    cfg = port_train.get_config(config)
    if config == "lm_smoke" and world == 4:
        cfg = cfg.with_overrides(mesh={"data": 1, "seq": 4})
    sizes = port_train._refuse_unported(cfg, world)
    assert {k: sizes[k] for k in want} == want
    assert all(sizes[k] == 1 for k in sizes if k not in want)


def test_a_seq_mesh_needs_a_sharded_sequence_and_a_seq_model():
    cfg = port_train.get_config("lm_smoke")
    with pytest.raises(ValueError, match="needs shard_seq=True"):
        port_train._refuse_unported(cfg.with_overrides(shard_seq=False), 8)
    with pytest.raises(ValueError, match="seq_mode 'ring' or 'ulysses'"):
        port_train._refuse_unported(
            cfg.with_overrides(model_kwargs={"seq_mode": "none"}), 8)


def test_horovod_fusion_threshold_names_the_port_knob(monkeypatch):
    monkeypatch.setenv("HOROVOD_FUSION_THRESHOLD", "67108864")
    cfg = port_train.get_config("lm_smoke").with_overrides(
        mesh={"data": 1, "seq": 1})
    with pytest.raises(NotImplementedError,
                       match="HOROVOD_FUSION_THRESHOLD.*reads "
                             "TPUFRAME_FUSION_THRESHOLD"):
        port_train._refuse_unported(cfg, 1)


@pytest.mark.parametrize("env", [{"TPUFRAME_CHECK_SPMD": "1"},
                                 {"TPUFRAME_FUSION_THRESHOLD": "4194304"}])
def test_the_program_check_and_the_fusion_knob_are_ported(env, monkeypatch):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    cfg = port_train.get_config("lm_smoke").with_overrides(
        mesh={"data": 2, "seq": 1})
    sizes = port_train._refuse_unported(cfg, 2)
    assert (sizes["data"], sizes["seq"]) == (2, 1)


def test_model_registry_names_are_the_jax_registrys():
    """``transformer-lm`` (and its layer-stacked ``transformer-lm-pp``),
    the ResNets, ``convnet`` and ``bert-base`` build as the JAX harness
    calls them: every name of the JAX registry is built; an unknown name
    refuses."""
    lm = port_models.get_model("transformer-lm", dtype="bfloat16", tiny=True,
                               device="cpu", vocab_size=64)
    assert lm.cfg == torch_lm.LMConfig.tiny(vocab_size=64, dtype="bfloat16")
    pp = port_models.get_model("transformer-lm-pp", dtype="bfloat16",
                               tiny=True, device="cpu", vocab_size=64)
    assert isinstance(pp, torch_lm.ScanBlockLM) and pp.cfg == lm.cfg
    r18 = port_models.get_model("resnet18", dtype="bfloat16", device="cpu")
    assert r18.dtype == torch.bfloat16 and r18.fc.out_features == 10
    assert r18.cifar_stem
    bert = port_models.get_model("bert-base", dtype="bfloat16", device="cpu",
                                 num_classes=3, num_layers=1, dropout=0.0)
    assert bert.cfg == port_models.BertConfig(dtype="bfloat16", num_classes=3,
                                              num_layers=1, dropout=0.0)
    net = port_models.get_model("convnet", dtype="bfloat16", device="cpu",
                                dropout=0.0)
    assert net.dtype == torch.bfloat16 and net.fc2.out_features == 10
    assert net.rates == (0.0, 0.0)
    built = {"transformer-lm", "transformer-lm-pp", "bert-base", "convnet",
             *port_models._RESNETS}
    assert set(jax_models._REGISTRY) - built == set()
    with pytest.raises(ValueError, match="unknown model"):
        port_models.get_model("nope", device="cpu")


def test_mesh_must_match_the_world():
    """lm_smoke's own mesh (data 2 x seq 4) on a world of one rank."""
    cfg = port_train.get_config("lm_smoke")
    with pytest.raises(ValueError, match="needs 8 ranks"):
        port_train.build_harness(cfg, device="cpu")
