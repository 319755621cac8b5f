"""Checkpoints of fsdp's sharded state in tpuframe_torch, across layouts
and across packages, and the refusals that remain.

The JAX harness's sharded-state step trains the tiny LM of
``test_torch_fsdp.py`` on ``fsdp=2 x model=2`` (the conftest's virtual
devices) and saves its state with ``tpuframe.ckpt.save`` after steps 2
and 3.  One gloo world of four CPU processes then:

  - restores the step-2 save with the port's ``ckpt.restore``, carries it
    through ``convert.train_state_from_jax(..., blocks=...)`` into each
    rank's blocks of a ``fsdp=2 x model=2`` harness and takes step 3
    (``test_torch_ckpt_interop.py``'s check, on sharded state): the loss
    and gradient norm within 3e-5 of the JAX step 3 (absolute and
    relative, the tolerance of ``tests/test_fsdp.py``), the parameters
    within 3e-5;
  - saves that state: each fsdp or fsdp x model block as a
    ``ckpt.Shard`` leaf with a two-axis spec, whose shard table holds the
    blocks of the JAX save's table, mapped onto the port's tensor;
  - restores it onto ``data=2 x fsdp=2``, bit for bit (parameters and
    both Adam moments), and this process restores it onto one process,
    bit for bit.

An fsdp image run resumes bit for bit: a gloo world of two trains the
narrow Bottleneck ResNet of ``test_torch_fsdp_image.py`` (``bn="fused"``)
on ``fsdp=2`` three steps straight, and again two steps, a save (its
split conv, Dense and BatchNorm leaves ``ckpt.Shard`` blocks, the running
statistics whole), a restore into a new harness and one step: the
parameters, the running statistics and the SGD momenta are equal.
"""

import json

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
from tpuframe_torch.models import convert  # noqa: E402
from tpuframe_torch.utils.config import TrainConfig  # noqa: E402
from test_torch_fsdp import (  # noqa: E402
    LM_KW, STEPS, TOL, batches, common, full_params, jax_init, start_world)

MESH = {"data": 1, "fsdp": 2, "model": 2}
AGAIN = {"data": 2, "fsdp": 2}


def index_to_port(view, index) -> tuple:
    """A block of the JAX leaf (the shard table's ``((lo, hi), ...)``) as
    the same block of the port's tensor (``convert.JaxView``); a
    flattened dim's inner factor is whole in every JAX table here."""
    out = [None] * view.port_ndim
    for j, (lo, hi) in enumerate(index):
        d, part = view.dims[j]
        if part == "whole":
            out[d] = (lo, hi)
        elif part == "outer":
            inner = view.shape[j + 1]
            assert tuple(index[j + 1]) == (0, inner), index
            out[d] = (lo * inner, hi * inner)
    return tuple(out)


def jax_saves(root) -> dict:
    """The JAX sharded-state run on MESH, saved after steps 2 and 3 under
    ``root/jax``; step 3's metrics and parameters."""
    jcfg = JaxTrainConfig(**common(LM_KW)).with_overrides(mesh=MESH)
    model = jax_models.get_model("transformer-lm", dtype=jnp.float32,
                                 **LM_KW)
    params = jax_init("transformer-lm", LM_KW, 32)
    tx = jax_build_optimizer(jcfg, params)
    state = jax_step.TrainState.create(params, tx)
    mesh = jax_mesh.make_mesh(jax_mesh.MeshSpec(**MESH),
                              devices=jax.devices()[:4])
    shardings = jax_fsdp.state_shardings(
        state, mesh, tp_rules=jax_tp.rules_for_model("transformer-lm"))
    state = jax.tree.map(jax.device_put, state, shardings)
    on = NamedSharding(jax_fsdp.auto_mesh(mesh), jax_mesh.batch_spec())
    step = jax_step.make_train_step(jax_train.make_loss_fn(jcfg, model), tx,
                                    mesh, donate=False,
                                    state_shardings=shardings)
    for i, b in enumerate(batches()):
        state, m = step(state, {k: jax.device_put(jnp.asarray(v), on)
                                for k, v in b.items()})
        if i + 1 >= STEPS - 1:
            jax_ckpt.save(str(root / "jax"), i + 1, state)
    return {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
            "params": convert.params_from_jax(
                jax.tree.map(np.asarray, state.params))}


# One rank of the world of four (module docstring).
_WORKER = r"""
import json, os, sys
import numpy as np
import torch
import torch.distributed as dist
from tpuframe_torch import ckpt
from tpuframe_torch import train as port_train
from tpuframe_torch.models.convert import train_state_from_jax
from tpuframe_torch.parallel import tp
from tpuframe_torch.utils.config import TrainConfig

rank, port, root = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        world_size=4, rank=rank)
spec = json.load(open(f"{root}/spec.json"))
data = np.load(f"{root}/batch.npz")


def harness(mesh):
    cfg = TrainConfig(**spec["cfg"]).with_overrides(mesh=mesh)
    return port_train.build_harness(cfg, device="cpu")


def blocks(h, tensors):
    specs, lay = h.state.model.shard_specs, h.layout
    return {k: (None if k not in specs else
                tp.shard_leaf(t, specs[k], lay).index, t.detach().clone())
            for k, t in tensors.items()}


h = harness(spec["mesh"])
lay, specs = h.layout, h.state.model.shard_specs
model, opt, step = train_state_from_jax(
    ckpt.restore(f"{root}/jax", spec["step"] - 1), "transformer-lm",
    blocks=(specs, lay.sizes, lay.coords()))
h.state.model.load_state_dict(model)
h.state.opt.load_state_dict(opt)
h.state.step = step
n = data["input_ids"].shape[0] // lay.batch_size
j = lay.batch_index
m = h.train_step(h.state, {k: torch.from_numpy(np.ascontiguousarray(
    data[k][j * n:(j + 1) * n])) for k in ("input_ids", "labels")})
got = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
       "params": blocks(h, h.state.model.state_dict())}
for k in ("mu", "nu"):
    got[k] = blocks(h, h.state.opt.state_dict()[k])
ckpt.save(f"{root}/port", h.state.step, h.state.to_tree())
h2 = harness(spec["again"])
h2.state.load_tree(ckpt.restore(f"{root}/port", h.state.step,
                                target=h2.state.to_tree()))
again = {"params": blocks(h2, h2.state.model.state_dict()),
         "step": h2.state.step, "count": h2.state.opt.count}
for k in ("mu", "nu"):
    again[k] = blocks(h2, h2.state.opt.state_dict()[k])
torch.save({"run": got, "again": again}, f"{root}/rank{rank}.pt")
os._exit(0)
"""


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("fsdp_ckpt")
    want = jax_saves(root)
    (root / "spec.json").write_text(json.dumps(
        {"cfg": common(LM_KW), "mesh": MESH, "again": AGAIN,
         "step": STEPS}))
    np.savez(root / "batch.npz", **batches()[-1])
    return want, start_world(root, _WORKER)(), root


def test_port_continues_a_jax_fsdp_run(world):
    want, ranks, _ = world
    for r in ranks:
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(r["run"][k], want[k], atol=TOL,
                                       rtol=TOL, err_msg=k)
    got = full_params(ranks, "run")
    for k, w in want["params"].items():
        err = float((got[k] - w).abs().max())
        assert err <= TOL, (k, err)


def test_shard_tables_are_the_jax_saves(world):
    """Every leaf the JAX save splits, the port's save splits into the
    same logical blocks (the JAX table's indices mapped onto the port's
    tensor), with a two-axis spec where fsdp and model both split it."""
    _, _, root = world
    mine = json.loads((root / "port" / f"step_{STEPS:08d}"
                       / "manifest.json").read_text())["leaves"]
    theirs = json.loads((root / "jax" / f"step_{STEPS:08d}"
                         / "manifest.json").read_text())["leaves"]
    order = convert.flat_order(jax_init("transformer-lm", LM_KW, 32),
                               "transformer-lm")
    two_axes = 0
    for name, (path, _) in order.items():
        entry = theirs["params/" + "/".join(path)]
        port = mine[f"model/{name}"]
        view = convert.jax_view(name, tuple(port["shape"]), 2)
        jax_blocks = {tuple(map(tuple, s["index"])) for s in entry["shards"]}
        if len(jax_blocks) == 1:
            assert port["shards"][0]["index"] is None, name
            continue
        assert {index_to_port(view, b) for b in jax_blocks} == {
            tuple(map(tuple, s["index"])) for s in port["shards"]}, name
        split = [s[0] for s in port["spec"] if s]
        two_axes += sorted(split) == ["fsdp", "model"]
        assert [s["index"] for s in mine[f"opt/mu/{name}"]["shards"]] == [
            s["index"] for s in port["shards"]], name
    assert two_axes >= 4


def test_save_restores_onto_other_layouts_bit_for_bit(world):
    _, ranks, root = world
    for key in ("params", "mu", "nu"):
        saved = full_params([{"s": r["run"]} for r in ranks], "s", key)
        again = full_params([{"s": r["again"]} for r in ranks], "s", key)
        for k, t in saved.items():
            assert torch.equal(again[k], t), (key, k)
    for r in ranks:
        assert r["again"]["step"] == STEPS and r["again"]["count"] == STEPS
    cfg = TrainConfig(**common(LM_KW)).with_overrides(mesh={"data": 1})
    h = port_train.build_harness(cfg, device="cpu")
    h.state.load_tree(ckpt.restore(str(root / "port"), STEPS,
                                   target=h.state.to_tree()))
    saved = full_params([{"s": r["run"]} for r in ranks], "s")
    for k, t in h.state.model.state_dict().items():
        assert torch.equal(t, saved[k]), k
    mu = full_params([{"s": r["run"]} for r in ranks], "s", "mu")
    for k, t in h.state.opt.state_dict()["mu"].items():
        assert torch.equal(t, mu[k]), k
    assert h.state.step == STEPS and h.state.opt.count == STEPS


@pytest.mark.parametrize("model,mesh,overrides", [
    ("resnet18", {"data": 1, "fsdp": 2, "seq": 2}, {"shard_seq": True}),
    ("transformer-lm-pp", {"data": 1, "fsdp": 2}, {}),
    ("transformer-lm", {"data": 1, "fsdp": 2, "slices": 2}, {}),
], ids=["resnet-fsdp-seq", "pp-lm-fsdp", "slices"])
def test_unported_meshes_refuse_with_their_roadmap_item(model, mesh,
                                                        overrides):
    cfg = TrainConfig(**common(LM_KW)).with_overrides(
        model=model, mesh=mesh, **overrides)
    world = int(np.prod([v for k, v in mesh.items()]))
    with pytest.raises(NotImplementedError, match="ROADMAP.md.*item 12"):
        port_train._refuse_unported(cfg, world)


# One rank of the world of two: the narrow ResNet on fsdp=2, three steps
# straight, then two, a save, a restore into a new harness and one more.
_RESNET_WORKER = r"""
import json, os, sys
import numpy as np
import torch
import torch.distributed as dist
from tpuframe_torch import ckpt
from tpuframe_torch import models as port_models
from tpuframe_torch import train as port_train
from tpuframe_torch.models import resnet
from tpuframe_torch.parallel import tp
from tpuframe_torch.utils.config import TrainConfig

rank, port, root = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        world_size=2, rank=rank)
spec = json.load(open(f"{root}/spec.json"))
stages, block, width = spec["arch"]
port_models._RESNETS["resnet50"] = lambda **kw: resnet.ResNet(
    tuple(stages), getattr(resnet, block), width=width, **kw)
data = np.load(f"{root}/batches.npz")
cfg = TrainConfig(**spec["cfg"]).with_overrides(mesh=spec["mesh"])


def step(h, i):
    lay = h.layout
    n = data[f"label{i}"].shape[0] // lay.batch_size
    j = lay.batch_index
    h.train_step(h.state, {k: torch.from_numpy(np.ascontiguousarray(
        data[f"{k}{i}"][j * n:(j + 1) * n])) for k in ("image", "label")})


def state(h):
    return {"model": {k: v.clone() for k, v in
                      h.state.model.state_dict().items()},
            "trace": {k: v.clone() for k, v in
                      h.state.opt.state_dict()["trace"].items()},
            "step": h.state.step}


h = port_train.build_harness(cfg, device="cpu")
for i in range(3):
    step(h, i)
straight = state(h)
h = port_train.build_harness(cfg, device="cpu")
for i in range(2):
    step(h, i)
ckpt.save(f"{root}/ckpt", 2, h.state.to_tree())
h = port_train.build_harness(cfg, device="cpu")
h.state.load_tree(ckpt.restore(f"{root}/ckpt", 2,
                               target=h.state.to_tree()))
step(h, 2)
torch.save({"straight": straight, "resumed": state(h),
            "specs": {k: list(v) for k, v in
                      h.state.model.shard_specs.items()}},
           f"{root}/rank{rank}.pt")
os._exit(0)
"""


def test_fsdp_resnet_resumes_bit_for_bit(tmp_path):
    import test_torch_fsdp_image as image

    name = "bottleneck-fused"
    (tmp_path / "spec.json").write_text(json.dumps(
        {"cfg": image.common(name), "mesh": {"data": 1, "fsdp": 2},
         "arch": image.ARCH["bottleneck"]}))
    np.savez(tmp_path / "batches.npz",
             **{f"{k}{i}": v for i, b in enumerate(image.batches(name))
                for k, v in b.items()})
    ranks = start_world(tmp_path, _RESNET_WORKER, n=2, timeout=300)()
    for r in ranks:
        want, got = r["straight"], r["resumed"]
        assert got["step"] == want["step"] == 3
        for part in ("model", "trace"):
            assert set(got[part]) == set(want[part])
            for k, t in want[part].items():
                assert torch.equal(got[part][k], t), (part, k)
    leaves = json.loads((tmp_path / "ckpt" / "step_00000002"
                         / "manifest.json").read_text())["leaves"]
    specs = ranks[0]["specs"]
    for name in ("layer4.0.conv2.weight", "fc.weight", "layer4.0.bn3.weight",
                 "layer4.0.bn3.bias"):
        assert "fsdp" in specs[name], name
        assert len(leaves[f"model/{name}"]["shards"]) == 2, name
        assert len(leaves[f"opt/trace/{name}"]["shards"]) == 2, name
    for name in ("layer4.0.bn3.running_mean", "layer4.0.bn3.running_var"):
        assert leaves[f"model/{name}"]["shards"][0]["index"] is None, name
