"""tpuframe_torch's expert and tensor parallelism against the JAX
package's sharded-state trainer.

One gloo world of four CPU processes trains the tiny MoE LM of
``test_torch_moe_train.py`` (4 experts, top-2, ``moe_capacity_factor=
1.0``, aux weight 0.01, adamw with ``grad_clip_norm``) for three steps
through ``train.build_harness`` on each layout: ``{data 2, expert 2}``,
``{data 2, model 2}`` and ``{expert 2, model 2}``, on the fused and the
dense head, and once more on ``{expert 2, model 2}`` and on ``{data 2,
expert 2}`` with ``accum_steps=2`` (a microbatch is a block of the global
batch's rows, as in the JAX jit step, which spans the data ranks); each
rank takes its data rank's rows of the same global batches.  The JAX harness's sharded-state step (its state placed
by ``tp.rules_for_model`` on a mesh of the conftest's virtual devices;
GSPMD keeps the logical program, so it routes the global batch) runs the
same recipe on each layout.

Held: losses, ``moe_aux`` and gradient norms within 3e-5 (the TP
tolerance of ``tests/test_fsdp.py``); the final parameters, each rank's
blocks put back together, every element within 3e-5, except the few
elements (under 0.1% of a tensor, printed) where two JAX steps of the
same head on different layouts (the unsharded step and the three
sharded-state ones: one logical program, so summation order only) differ
by more than that: three Adam steps amplify the summation order of a
gradient at the scale of Adam's epsilon (~5e-5 in one element of
``moe.up_experts``, ``test_torch_moe_train.py``), and such an element is
held within twice its own spread; every replicated leaf
bit-identical on every rank.  Checkpoints: the ``{expert 2, model 2}``
run's state saved with the JAX shard table, restored bit for bit onto
``{data 2, model 2}`` (in the world) and onto one process, read by
``tpuframe.ckpt.restore``; and the JAX sharded-state step's own save
restored by the port.  The refusals of the sharded-state mode are
checked in this process.
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
from jax.sharding import NamedSharding  # noqa: E402

from tpuframe import ckpt as jax_ckpt  # noqa: E402
from tpuframe import models as jax_models  # noqa: E402
from tpuframe import train as jax_train  # noqa: E402
from tpuframe.parallel import fsdp as jax_fsdp  # noqa: E402
from tpuframe.parallel import mesh as jax_mesh  # noqa: E402
from tpuframe.parallel import step as jax_step  # noqa: E402
from tpuframe.parallel import tp as jax_tp  # noqa: E402
from tpuframe.utils import build_optimizer as jax_build_optimizer  # noqa: E402
from tpuframe.utils.config import TrainConfig as JaxTrainConfig  # noqa: E402
from tpuframe_torch import ckpt  # noqa: E402
from tpuframe_torch import train as port_train  # noqa: E402
from tpuframe_torch.data import datasets  # noqa: E402
from tpuframe_torch.models.convert import (params_from_jax,  # noqa: E402
                                           train_state_from_jax)
from tpuframe_torch.parallel import tp  # noqa: E402
from tpuframe_torch.utils.config import TrainConfig  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 3
TOL = 3e-5
MODEL_KW = {"tiny": True, "vocab_size": 64, "hidden_size": 32,
            "num_heads": 2, "intermediate_size": 64, "max_seq": 64,
            "moe_experts": 4, "moe_k": 2, "moe_capacity_factor": 1.0,
            "attn_impl": "xla", "remat": True}
# (run, mesh, fused head, accum_steps)
RUNS = [("data2-expert2-fused", {"data": 2, "expert": 2}, True, 1),
        ("data2-expert2-dense", {"data": 2, "expert": 2}, False, 1),
        ("data2-model2-fused", {"data": 2, "model": 2}, True, 1),
        ("data2-model2-dense", {"data": 2, "model": 2}, False, 1),
        ("expert2-model2-fused", {"data": 1, "expert": 2, "model": 2},
         True, 1),
        ("expert2-model2-dense", {"data": 1, "expert": 2, "model": 2},
         False, 1),
        ("expert2-model2-accum2", {"data": 1, "expert": 2, "model": 2},
         True, 2),
        ("data2-expert2-accum2", {"data": 2, "expert": 2}, True, 2)]
SAVED = "expert2-model2-fused"
# With residual dropout, which no JAX step can match: the model ranks of
# a data index must draw the same masks (seeded by the data index).
DROPOUT = ("data2-model2-dropout", {"data": 2, "model": 2})


def common(fused: bool, accum: int = 1) -> dict:
    return dict(name="moe", model="transformer-lm", model_kwargs=MODEL_KW,
                dataset="lm_text",
                dataset_kwargs={"seq_len": 32, "vocab_size": 64,
                                "synthetic_size": 64},
                optimizer="adamw", base_lr=3e-3, scale_lr_by_batch=False,
                warmup_steps=0, schedule="cosine", weight_decay=0.1,
                grad_clip_norm=1.0, global_batch=8, total_steps=10,
                compute_dtype="float32", fused_xent=fused,
                accum_steps=accum)


def batches():
    train, _ = datasets.lm_text(None, seq_len=32, vocab_size=64,
                                synthetic_size=64)
    return [train[np.arange(8 * i, 8 * i + 8)] for i in range(STEPS)]


def jax_run(fused: bool, mesh_kw: dict | None = None,
            accum: int = 1) -> dict:
    """The JAX harness's steps: unsharded (``mesh_kw`` None) or the
    sharded-state step on ``mesh_kw``."""
    mesh_kw = mesh_kw or {"data": 1}
    jcfg = JaxTrainConfig(**common(fused, accum)).with_overrides(
        mesh=mesh_kw)
    model = jax_models.get_model("transformer-lm", dtype=jnp.float32,
                                 **MODEL_KW)
    params = jax.tree.map(np.asarray, model.init(
        jax.random.key(0), jnp.zeros((1, 32), jnp.int32))["params"])
    tx = jax_build_optimizer(jcfg, params)
    state = jax_step.TrainState.create(params, tx)
    n = int(np.prod(list(mesh_kw.values())))
    mesh, shardings, place = None, None, jnp.asarray
    if n > 1:
        mesh = jax_mesh.make_mesh(jax_mesh.MeshSpec(**mesh_kw),
                                  devices=jax.devices()[:n])
        shardings = jax_fsdp.state_shardings(
            state, mesh, tp_rules=jax_tp.rules_for_model("transformer-lm"))
        state = jax.tree.map(jax.device_put, state, shardings)
        on = NamedSharding(jax_fsdp.auto_mesh(mesh), jax_mesh.batch_spec())
        place = lambda v: jax.device_put(jnp.asarray(v), on)  # noqa: E731
    step = jax_step.make_train_step(jax_train.make_loss_fn(jcfg, model), tx,
                                    mesh, donate=False,
                                    state_shardings=shardings,
                                    accum_steps=accum)
    out = {"loss": [], "moe_aux": [], "grad_norm": []}
    for b in batches():
        state, m = step(state, {k: place(v) for k, v in b.items()})
        for k in out:
            out[k].append(float(m[k]))
    out["params"] = params_from_jax(jax.tree.map(np.asarray, state.params))
    out["init"] = params_from_jax(params)
    out["state"] = state
    return out


# One rank of the world of four: each run of RUNS through the trainer's
# harness from the JAX init, three steps on this rank's data rows; after
# the saved run, its state checkpointed and restored onto data=2 x
# model=2.  Each rank saves its results; os._exit(0) once they are
# written (a gloo world's interpreter teardown can abort).
_WORKER = r"""
import json, os, sys
import numpy as np
import torch
import torch.distributed as dist
from tpuframe_torch import ckpt
from tpuframe_torch import train as port_train
from tpuframe_torch.parallel import tp
from tpuframe_torch.utils.config import TrainConfig

rank, port, root = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        world_size=4, rank=rank)
spec = json.load(open(f"{root}/runs.json"))
data = np.load(f"{root}/batches.npz")
init = torch.load(f"{root}/init.pt")


def block(h):
    # each tensor with the block it is (None: whole)
    out = {}
    for name, t in h.state.model.state_dict().items():
        s = h.state.model.shard_specs.get(name)
        out[name] = (None if s is None else
                     tp.shard_leaf(t, s, h.layout).index, t.clone())
    return out


def full_cut(h, tensors):
    # the whole tensors cut to this rank's blocks
    lay = h.layout
    return {k: tp.cut(v, h.state.model.shard_specs.get(k), lay.sizes,
                      lay.coords()) for k, v in tensors.items()}


result = {}
for name, mesh, kw in spec["runs"]:
    cfg = TrainConfig(**kw).with_overrides(mesh=mesh)
    h = port_train.build_harness(cfg, device="cpu")
    h.state.model.load_state_dict(full_cut(h, init))
    lay = h.layout
    got = {"loss": [], "moe_aux": [], "grad_norm": []}
    for i in range(len(data.files) // 2):
        b = {k: data[f"{k}{i}"] for k in ("input_ids", "labels")}
        n = b["input_ids"].shape[0] // lay.data_size
        d = lay.data_index
        mine = {k: torch.from_numpy(np.ascontiguousarray(
            v[d * n:(d + 1) * n])) for k, v in b.items()}
        m = h.train_step(h.state, mine)
        for k in got:
            got[k].append(float(m[k]))
    got["coords"] = lay.coords()
    got["params"] = block(h)
    got["opt"] = h.state.opt.state_dict()
    if name == spec["saved"]:
        ckpt.save(f"{root}/ckpt", h.state.step, h.state.to_tree())
        cfg2 = cfg.with_overrides(mesh={"data": 2, "model": 2})
        h2 = port_train.build_harness(cfg2, device="cpu")
        h2.state.load_tree(ckpt.restore(f"{root}/ckpt", h.state.step,
                                        target=h2.state.to_tree()))
        got["restored"] = {"params": block(h2),
                           "opt": h2.state.opt.state_dict(),
                           "step": h2.state.step}
    result[name] = got
torch.save(result, f"{root}/rank{rank}.pt")
os._exit(0)
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The JAX steps (unsharded and each layout's) and the port's world
    of four."""
    want = {"unsharded": {f: jax_run(f) for f in (True, False)}}
    for name, mesh, fused, accum in RUNS:
        want[name] = jax_run(fused, {k: v for k, v in mesh.items()
                                     if v > 1}, accum)
    root = tmp_path_factory.mktemp("expert_tp")
    torch.save(want["unsharded"][True]["init"], root / "init.pt")
    (root / "runs.json").write_text(json.dumps({
        "saved": SAVED,
        "runs": [(name, mesh, common(fused, accum))
                 for name, mesh, fused, accum in RUNS]
        + [(DROPOUT[0], DROPOUT[1], dict(
            common(True), model_kwargs=dict(MODEL_KW, dropout=0.1)))]}))
    np.savez(root / "batches.npz", **{f"{k}{i}": v for i, b in
                                      enumerate(batches())
                                      for k, v in b.items()})
    port = str(_free_port())
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("TPUFRAME_")}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(r), port, str(root)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(4)]
    for p in procs:
        _, err = p.communicate(timeout=400)
        assert p.returncode == 0, err
    ranks = [torch.load(root / f"rank{r}.pt") for r in range(4)]
    return want, ranks, root


def _full_params(ranks: list, run: str) -> dict:
    out = {}
    for name, (idx, t) in ranks[0][run]["params"].items():
        if idx is None:
            out[name] = t
            continue
        parts = {}
        for r in ranks:
            i, b = r[run]["params"][name]
            parts[tuple(map(tuple, i))] = b
        shape = tuple(max(hi for _, hi in dims)
                      for dims in zip(*parts.keys()))
        out[name] = tp.paste(shape, parts.items())
    return out


def _spread(want: dict, fused: bool) -> dict:
    """Per tensor, each element's largest distance between two JAX steps
    of one head on different layouts (accum_steps 1)."""
    steps = [want["unsharded"][fused]["params"]] + [
        want[name]["params"] for name, _, f, accum in RUNS
        if f == fused and accum == 1]
    out = {}
    for k in steps[0]:
        every = torch.stack([s[k] for s in steps])
        out[k] = every.amax(dim=0) - every.amin(dim=0)
    return out


def _assert_params(got: dict, want: dict, spread: dict, what: str) -> None:
    """Every element of ``got`` within TOL of ``want``, except the
    elements where the JAX layouts themselves differ by more than TOL:
    those within twice their own spread, and under 0.1% of the tensor."""
    assert set(got) == set(want)
    for k, w in want.items():
        loose = spread[k] > TOL
        assert int(loose.sum()) * 1000 < w.numel(), (
            f"{what} {k}: {int(loose.sum())} of {w.numel()} elements "
            f"differ by more than {TOL} between JAX layouts")
        if loose.any():
            print(f"{what} {k}: loosened at "
                  f"{loose.nonzero().tolist()} to 2x "
                  f"{spread[k][loose].tolist()}")
        atol = torch.where(loose, 2 * spread[k], torch.full_like(w, TOL))
        err = (got[k] - w).abs()
        bad = err > atol
        assert not bad.any(), (
            f"{what} {k}: {int(bad.sum())} elements off, first at "
            f"{bad.nonzero()[0].tolist()}: |{got[k][bad][0].item()} - "
            f"{w[bad][0].item()}| > {atol[bad][0].item()}")


@pytest.mark.parametrize("run", [r[0] for r in RUNS])
def test_layout_matches_the_jax_sharded_state_step(world, run):
    want, ranks, _ = world
    jx = want[run]
    spread = _spread(want, "dense" not in run)
    for r in ranks:
        for k in ("loss", "moe_aux", "grad_norm"):
            np.testing.assert_allclose(r[run][k], jx[k], atol=TOL, rtol=0,
                                       err_msg=f"{run} {k}")
    _assert_params(_full_params(ranks, run), jx["params"], spread, run)


@pytest.mark.parametrize("run", [r[0] for r in RUNS])
def test_replicated_leaves_are_bit_identical_on_every_rank(world, run):
    _, ranks, _ = world
    split = set()
    for name, (idx, t) in ranks[0][run]["params"].items():
        if idx is not None:
            split.add(name)
            continue
        for r in ranks[1:]:
            assert torch.equal(r[run]["params"][name][1], t), (run, name)
    # the rules split what the layout's axes shard
    mesh = dict(RUNS[[r[0] for r in RUNS].index(run)][1])
    assert ("blocks.1.moe.up_experts" in split) == (
        mesh.get("expert", 1) > 1 or mesh.get("model", 1) > 1)
    assert ("blocks.0.attn.query.weight" in split) == (
        mesh.get("model", 1) > 1)


def test_dropout_masks_are_drawn_by_data_index(world):
    """With dropout 0.1 the model ranks of a data index draw the same
    masks: their replicated leaves stay bit-identical through three steps
    (masks drawn by world rank would part them at the first step), and
    the masks are live (the losses leave the run without dropout's)."""
    _, ranks, _ = world
    run = DROPOUT[0]
    for name, (idx, t) in ranks[0][run]["params"].items():
        if idx is None:
            for r in ranks[1:]:
                assert torch.equal(r[run]["params"][name][1], t), name
    assert ranks[0][run]["loss"][0] != ranks[0]["data2-model2-fused"]["loss"][0]


def test_sharded_checkpoint_restores_onto_other_layouts(world):
    """The ``{expert 2, model 2}`` save: its manifest carries the JAX
    shard table (per-dim index, one file a distinct block); it restores
    bit for bit onto ``{data 2, model 2}`` (the world) and onto one
    process, and ``tpuframe.ckpt.restore`` reads it."""
    _, ranks, root = world
    saved = _full_params(ranks, SAVED)
    manifest = json.loads((root / "ckpt" / "step_00000003"
                           / "manifest.json").read_text())
    entry = manifest["leaves"]["model/blocks.1.moe.up_experts"]
    assert entry["spec"] == [["expert"], None, ["model"]]
    assert [s["index"] for s in entry["shards"]] == [
        [[0, 2], [0, 32], [0, 32]], [[0, 2], [0, 32], [32, 64]],
        [[2, 4], [0, 32], [0, 32]], [[2, 4], [0, 32], [32, 64]]]
    assert len(manifest["leaves"]["model/blocks.0.attn.query.weight"]
               ["shards"]) == 2
    # onto data=2 x model=2, in the world: parameters and moments
    again = _full_params([{SAVED: r[SAVED]["restored"]} for r in ranks],
                         SAVED)
    for k, t in saved.items():
        assert torch.equal(again[k], t), k
    for r in ranks:
        assert r[SAVED]["restored"]["step"] == STEPS
        assert r[SAVED]["restored"]["opt"]["count"] == STEPS
    # onto one process: a whole model and optimizer
    cfg = TrainConfig(**common(True)).with_overrides(mesh={"data": 1})
    h = port_train.build_harness(cfg, device="cpu")
    h.state.load_tree(ckpt.restore(str(root / "ckpt"), STEPS,
                                   target=h.state.to_tree()))
    for k, t in h.state.model.state_dict().items():
        assert torch.equal(t, saved[k]), k
    assert h.state.step == STEPS and h.state.opt.count == STEPS
    # the JAX package reads it
    tree = jax_ckpt.restore(str(root / "ckpt"), STEPS)
    for k, t in saved.items():
        np.testing.assert_array_equal(np.asarray(tree["model"][k]),
                                      t.numpy(), err_msg=k)


def test_port_restores_a_jax_sharded_state_save(world, tmp_path):
    """The JAX sharded-state step's state on ``{expert 2, model 2}``,
    saved with ``tpuframe.ckpt.save`` (its leaves in several shard
    files), read by the port's ``ckpt.restore`` and carried into the
    port's model and optimizer, then cut to a layout's blocks."""
    want, _, _ = world
    state = want[SAVED]["state"]
    jax_ckpt.save(str(tmp_path), STEPS, state)
    manifest = json.loads((tmp_path / f"step_{STEPS:08d}"
                           / "manifest.json").read_text())
    assert len(manifest["leaves"]["params/block_1/moe/up_experts"]
               ["shards"]) == 4
    model, opt, step = train_state_from_jax(
        ckpt.restore(str(tmp_path), STEPS), "transformer-lm")
    assert step == STEPS and opt["count"] == STEPS
    for k, w in want[SAVED]["params"].items():
        assert torch.equal(model[k], w), k
    cfg = TrainConfig(**common(True)).with_overrides(mesh={"data": 1})
    h = port_train.build_harness(cfg, device="cpu")
    h.state.model.load_state_dict(model)
    h.state.opt.load_state_dict(opt)
    lay = {"data": 1, "expert": 2, "model": 2}
    spec = tp.match_spec("blocks.1.moe.up_experts", (4, 32, 64), lay,
                         tp.TRANSFORMER_LM_RULES)
    block = tp.cut(model["blocks.1.moe.up_experts"], spec, lay,
                   {"expert": 1, "model": 0})
    assert torch.equal(block, model["blocks.1.moe.up_experts"][2:, :, :32])


def test_rank_layout_is_the_jax_mesh_order():
    """Rank ``r`` sits where the JAX mesh puts device ``r`` on a data x
    expert x model mesh, and each sub-group holds the ranks that differ
    in its axes only."""
    from tpuframe_torch.parallel import mesh as mesh_lib

    sizes = {"data": 2, "fsdp": 1, "pipe": 1, "seq": 1, "expert": 2,
             "model": 2}
    mesh = jax_mesh.make_mesh(jax_mesh.MeshSpec(data=2, expert=2, model=2),
                              devices=jax.devices()[:8])
    ids = np.vectorize(lambda d: d.id)(mesh.devices)
    for r in range(8):
        c = mesh_lib.Layout(sizes=sizes, rank=r).coords()
        assert ids[c["data"], 0, 0, 0, c["expert"], c["model"]] == r
    assert mesh_lib.axis_groups(sizes, ("model",)) == [
        tuple(ids[d, 0, 0, 0, e, :]) for d in range(2) for e in range(2)]
    assert mesh_lib.axis_groups(sizes, ("data",)) == [
        tuple(ids[:, 0, 0, 0, e, m]) for e in range(2) for m in range(2)]
    assert mesh_lib.axis_groups(sizes, ("expert", "model")) == [
        tuple(ids[d, 0, 0, 0].reshape(-1)) for d in range(2)]


def _cfg(mesh, **kw):
    return TrainConfig(**common(True)).with_overrides(mesh=mesh, **kw)


@pytest.mark.parametrize("mesh,kw,err,match", [
    ({"data": 1, "model": 3}, {}, ValueError, "does not divide"),
    ({"data": 1, "expert": 3}, {}, ValueError, "does not divide"),
    # fsdp is ported for every model; the image models have no
    # tensor-parallel rules (the case keeps its id)
    ({"data": 1, "fsdp": 2, "model": 2}, {"model": "convnet"},
     ValueError, "fsdp.*no tensor-parallel rules"),
    ({"data": 1, "seq": 2, "model": 2}, {"shard_seq": True}, ValueError,
     "sequence parallelism"),
    ({"data": 2, "expert": 2}, {"grad_reduce": "adasum"}, ValueError,
     "shard_map mode"),
    # BERT's tensor parallelism is ported; 12 heads do not split over 5
    ({"data": 1, "model": 5}, {"config": "glue_bert"}, ValueError,
     "does not divide"),
], ids=["model-indivisible", "expert-indivisible", "fsdp", "seq",
        "adasum", "bert"])
def test_sharded_state_mode_refuses(mesh, kw, err, match):
    kw = dict(kw)
    cfg = (port_train.get_config(kw.pop("config")).with_overrides(mesh=mesh)
           if "config" in kw else _cfg(mesh, **kw))
    with pytest.raises(err, match=match):
        port_train._refuse_unported(cfg, int(np.prod(list(mesh.values()))))


def test_expert_axis_needs_an_moe_model():
    cfg = _cfg({"data": 1, "expert": 2}, model_kwargs=dict(
        MODEL_KW, moe_experts=0))
    with pytest.raises(ValueError, match="needs an MoE model"):
        port_train._refuse_unported(cfg, 2)


@pytest.mark.parametrize("env,match", [
    ({"TPUFRAME_WEIGHT_UPDATE": "zero1"}, "zero1"),
    ({"TPUFRAME_WIRE_FORMAT": "int8-block"}, "int8-block")])
@pytest.mark.parametrize("mesh", [{"data": 2, "expert": 2},
                                  {"data": 2, "model": 2}],
                         ids=["expert", "model"])
def test_sharded_state_mode_refuses_zero1_and_int8(env, match, mesh,
                                                   monkeypatch):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    sizes = _cfg(mesh).mesh.sizes(4)
    with pytest.raises(ValueError, match=match):
        port_train._resolved_update(sizes)
