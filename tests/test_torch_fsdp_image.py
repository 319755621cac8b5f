"""tpuframe_torch's image models under fsdp's sharded state against the
JAX package's sharded-state step.

GSPMD keeps the logical program, so the JAX step's BatchNorm normalises
with the global batch's statistics: every rank of the batch group (data x
fsdp).  The port's BatchNorm (flax, folded, and the fused conv+BN op in
its forward and in its backward's pass 1) sums its statistics over that
group (``collectives.bn_stats_sum``).

Steps: two gloo worlds of CPU processes, two ranks on ``fsdp=2`` and four
on ``data=2 x fsdp=2``, train through ``train.build_harness`` from the
flax init, three nesterov SGD steps with weight decay and label
smoothing, on each rank's batch rows of the same global batches:

  - a Bottleneck ResNet (``stage_sizes=(1, 1, 1, 1)``, width 32, 7x7
    stride-2 stem at 64x64) with ``bn`` flax, fused and folded.  Width 32
    is the narrowest at which a BatchNorm splits over fsdp: layer 4's
    last BatchNorm and its downsample's hold 1024 channels, the JAX
    ``MIN_SHARD_ELEMENTS``, so their scale and bias are fsdp blocks, and
    a gamma or beta gradient counted more than once would move them off.
    At 32x32 layer 4's BatchNorms see 8 values a channel, and two layouts
    of the JAX step itself part by 2.5e-4 in the third step's loss; at
    64x64 (32 values) by under 1e-6;
  - the same with ``bn="fused"``, the space-to-depth stem and ``remat``,
    whose recompute issues its BatchNorms' all-reduces again in the
    backward;
  - a BasicBlock ResNet (width 16, the CIFAR stem);
  - the ConvNet at dropout 0 (the port seeds dropout by batch index, so
    its masks are not the JAX step's).

The JAX harness's sharded-state step (``make_train_step`` with
``state_shardings``, its state placed by ``fsdp.state_shardings`` on a
mesh of the conftest's virtual devices) runs each on the same layout.
Held, in f32: losses and gradient norms within 3e-5, absolute and
relative, the tolerance of ``test_torch_fsdp.py`` (summation order
only); the final parameters (the ranks' blocks put together) and the
BatchNorm running statistics within the same; the running statistics
bit-identical on every rank; each rank's split parameters and momenta of
their block's shape.  One case shows the tolerance tells the two
BatchNorm semantics apart: the JAX plain data-parallel step (each
replica's own statistics) parts from the sharded-state step by more than
it, so a port that kept per-rank statistics would fail.
"""

import json
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import NamedSharding  # noqa: E402

from tpuframe import train as jax_train  # noqa: E402
from tpuframe.models import convnet as jax_convnet  # noqa: E402
from tpuframe.models import resnet as jax_resnet  # noqa: E402
from tpuframe.parallel import fsdp as jax_fsdp  # noqa: E402
from tpuframe.parallel import mesh as jax_mesh  # noqa: E402
from tpuframe.parallel import step as jax_step  # noqa: E402
from tpuframe.utils import build_optimizer as jax_build_optimizer  # noqa: E402
from tpuframe.utils.config import TrainConfig as JaxTrainConfig  # noqa: E402
from tpuframe_torch import train as port_train  # noqa: E402
from tpuframe_torch.data import datasets  # noqa: E402
from tpuframe_torch.models import convert  # noqa: E402
from tpuframe_torch.utils.config import TrainConfig  # noqa: E402
from test_torch_fsdp import full_params, start_world  # noqa: E402

STEPS = 3
BATCH = 8
TOL = 3e-5
IMG = {"image_size": 64, "synthetic_size": 64, "num_classes": 10}
# name -> (registry name, model kwargs, dataset, the narrow architecture)
MODELS = {
    "bottleneck-flax": ("resnet50", {"bn": "flax"}, "imagenet",
                        "bottleneck"),
    "bottleneck-fused": ("resnet50", {"bn": "fused"}, "imagenet",
                         "bottleneck"),
    "bottleneck-folded": ("resnet50", {"bn": "folded"}, "imagenet",
                          "bottleneck"),
    "bottleneck-s2d-remat": ("resnet50", {"bn": "fused",
                                          "stem": "space_to_depth",
                                          "remat": True}, "imagenet",
                             "bottleneck"),
    "basic": ("resnet18", {"cifar_stem": True}, "imagenet", "basic"),
    "convnet": ("convnet", {"dropout": 0.0}, "mnist", None),
}
# the narrow ResNets: (stage sizes, block, width)
ARCH = {"bottleneck": ((1, 1, 1, 1), "Bottleneck", 32),
        "basic": ((1, 1, 1, 1), "BasicBlock", 16)}
MESHES = {"fsdp2": {"data": 1, "fsdp": 2},
          "data2-fsdp2": {"data": 2, "fsdp": 2}}
CASES = [(m, lay) for lay in MESHES for m in MODELS]
# The workloads' own configs at full width, each one step on each mesh
# (8 images of 32x32, 10 classes; mnist_single made distributed: the
# sharded state refuses distributed=False).
_SMALL = {"global_batch": 8, "augment": "none",
          "dataset_kwargs": {"image_size": 32, "synthetic_size": 64,
                             "num_classes": 10}}
CONFIGS = [("imagenet_resnet50", dict(_SMALL, model_kwargs={
                "bn": bn, "num_classes": 10})) for bn in ("flax", "fused",
                                                          "folded")] + [
    ("cifar10_resnet18", {"global_batch": 8,
                          "dataset_kwargs": {"synthetic_size": 64}}),
    ("mnist_single", {"global_batch": 8, "distributed": True,
                      "dataset_kwargs": {"synthetic_size": 64}})]


def common(name: str) -> dict:
    family, kw, dataset, _ = MODELS[name]
    data = IMG if dataset == "imagenet" else {"synthetic_size": 64}
    return dict(name="fsdp_image", model=family,
                model_kwargs=dict(kw, num_classes=10), dataset=dataset,
                dataset_kwargs=data, optimizer="sgd", base_lr=0.4,
                warmup_steps=1, schedule="cosine", weight_decay=1e-4,
                label_smoothing=0.1, global_batch=BATCH, total_steps=10,
                augment="none", compute_dtype="float32")


def batches(name: str) -> list:
    cfg = common(name)
    train, _ = datasets.build(cfg["dataset"], None, **cfg["dataset_kwargs"])
    return [train[np.arange(BATCH * i, BATCH * (i + 1))]
            for i in range(STEPS)]


def jax_model(name: str):
    family, kw, _, arch = MODELS[name]
    if arch is None:
        return jax_convnet.ConvNet(num_classes=10, dropout=kw["dropout"])
    stages, block, width = ARCH[arch]
    return jax_resnet.ResNet(
        stage_sizes=stages, block_cls=getattr(jax_resnet, block),
        num_classes=10, width=width, bn=kw.get("bn", "flax"),
        cifar_stem=kw.get("cifar_stem", False),
        stem=kw.get("stem", "conv"), remat=kw.get("remat", False))


_INITS = {}


def jax_init(name: str) -> dict:
    """The flax init (seed 0) as numpy, made once a model, jitted."""
    if name not in _INITS:
        model = jax_model(name)
        size = IMG["image_size"]
        shape = ((2, 28, 28, 1) if MODELS[name][2] == "mnist"
                 else (2, size, size, 3))
        _INITS[name] = jax.tree.map(np.asarray, jax.jit(
            lambda k: model.init(k, jnp.zeros(shape), train=True))(
                jax.random.key(0)))
    return _INITS[name]


def to_port(name: str, variables) -> dict:
    """A flax state (params, batch statistics) as the port's
    ``state_dict``."""
    v = jax.tree.map(np.asarray, variables)
    if MODELS[name][3] is None:
        return convert.convnet_from_jax(v["params"])
    return convert.resnet_from_jax(v["params"], v["batch_stats"])


def jax_run(name: str, mesh_kw: dict, sharded: bool = True) -> dict:
    """Three steps of the JAX harness's sharded-state step on
    ``mesh_kw`` (with ``sharded=False``: its plain data-parallel step,
    each replica normalising with its own rows)."""
    jcfg = JaxTrainConfig(**common(name)).with_overrides(mesh=mesh_kw)
    model = jax_model(name)
    init = jax_init(name)
    tx = jax_build_optimizer(jcfg, init["params"])
    stats = ({"batch_stats": init["batch_stats"]} if "batch_stats" in init
             else {})
    state = jax_step.TrainState.create(init["params"], tx,
                                       model_state=stats)
    n = int(np.prod(list(mesh_kw.values())))
    mesh = jax_mesh.make_mesh(jax_mesh.MeshSpec(**mesh_kw),
                              devices=jax.devices()[:n])
    loss_fn = jax_train.make_loss_fn(jcfg, model)
    if sharded:
        shardings = jax_fsdp.state_shardings(state, mesh)
        state = jax.tree.map(jax.device_put, state, shardings)
        on = NamedSharding(jax_fsdp.auto_mesh(mesh), jax_mesh.batch_spec())
        step = jax_step.make_train_step(loss_fn, tx, mesh, donate=False,
                                        state_shardings=shardings)
    else:
        on = None
        step = jax_step.make_train_step(loss_fn, tx, mesh, donate=False)
    out = {"loss": [], "grad_norm": []}
    for b in batches(name):
        state, m = step(state, {k: jax.device_put(jnp.asarray(v), on)
                                if on is not None else jnp.asarray(v)
                                for k, v in b.items()})
        for k in out:
            out[k].append(float(m[k]))
    out["state"] = to_port(name, {"params": state.params,
                                  **state.model_state})
    return out


# One rank of a world: each model of MODELS in turn through the trainer's
# harness (the narrow ResNets registered under their family's name), from
# the JAX init, three steps on this rank's batch rows.  Each rank saves
# its results; os._exit(0) once they are written (a gloo world's
# interpreter teardown can abort).
_WORKER = r"""
import json, os, sys
import numpy as np
import torch
import torch.distributed as dist
from tpuframe_torch import models as port_models
from tpuframe_torch import train as port_train
from tpuframe_torch.models import resnet
from tpuframe_torch.parallel import fsdp, tp
from tpuframe_torch.utils.config import TrainConfig

rank, port, root = int(sys.argv[1]), sys.argv[2], sys.argv[3]
spec = json.load(open(f"{root}/runs.json"))
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        world_size=spec["world"], rank=rank)
registry = dict(port_models._RESNETS)
for family, (stages, block, width) in spec["arch"].items():
    port_models._RESNETS[family] = (
        lambda s=stages, b=block, w=width, **kw: resnet.ResNet(
            tuple(s), getattr(resnet, b), width=w, **kw))
result = {}
for name, kw in spec["runs"]:
    init = torch.load(f"{root}/init_{name}.pt")
    data = np.load(f"{root}/batches_{name}.npz")
    h = port_train.build_harness(
        TrainConfig(**kw).with_overrides(mesh=spec["mesh"]), device="cpu")
    model, lay = h.state.model, h.layout
    specs = model.shard_specs
    model.load_state_dict({k: tp.cut(v, specs.get(k), lay.sizes,
                                     lay.coords()) for k, v in init.items()})
    got = {"loss": [], "grad_norm": []}
    for i in range(len(data.files) // 2):
        b = {k: data[f"{k}{i}"] for k in ("image", "label")}
        n = b["label"].shape[0] // lay.batch_size
        j = lay.batch_index
        m = h.train_step(h.state, {k: torch.from_numpy(
            np.ascontiguousarray(v[j * n:(j + 1) * n])) for k, v in b.items()})
        for k in got:
            got[k].append(float(m[k]))
    got["params"] = {
        k: (None if k not in specs else
            tp.shard_leaf(t, specs[k], lay).index, t.detach().clone())
        for k, t in model.state_dict().items()}
    got["trace"] = h.state.opt.state_dict()["trace"]
    got["specs"] = {k: list(v) for k, v in specs.items()}
    result[name] = got
# the workloads' own models at full width, one step each (small images)
port_models._RESNETS.update(registry)
for name, overrides in spec["configs"]:
    h = port_train.build_harness(port_train.get_config(name).with_overrides(
        mesh=spec["mesh"], **overrides), device="cpu")
    m = h.train_step(h.state, next(iter(h.train_loader)))
    result[name + str(overrides.get("model_kwargs", ""))] = {
        "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
        "fraction": fsdp.param_fraction_sharded(h.state.model),
        "stats_group": {type(b).__name__: b.stats_group.size
                        for b in h.state.model.modules()
                        if getattr(b, "stats_group", None) is not None}}
torch.save(result, f"{root}/rank{rank}.pt")
os._exit(0)
"""


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """The port's two worlds, which run while this process runs the JAX
    sharded-state step of each case and the discriminating plain step."""
    roots, waits = {}, {}
    # XLA compiles outside the GIL: the JAX programs build side by side
    pool = ThreadPoolExecutor(6)
    list(pool.map(jax_init, MODELS))
    for lay, mesh in MESHES.items():
        root = tmp_path_factory.mktemp(lay)
        for name in MODELS:
            torch.save(to_port(name, jax_init(name)),
                       root / f"init_{name}.pt")
            np.savez(root / f"batches_{name}.npz",
                     **{f"{k}{i}": v for i, b in enumerate(batches(name))
                        for k, v in b.items()})
        world = int(np.prod(list(mesh.values())))
        (root / "runs.json").write_text(json.dumps({
            "world": world, "mesh": mesh,
            "arch": {"resnet50": ARCH["bottleneck"],
                     "resnet18": ARCH["basic"]},
            "runs": [(name, common(name)) for name in MODELS],
            "configs": CONFIGS}))
        roots[lay] = root
        waits[lay] = start_world(root, _WORKER, n=world, timeout=600)
    try:
        with pool:
            runs = {(name, lay): pool.submit(jax_run, name, MESHES[lay])
                    for name, lay in CASES}
            runs["plain"] = pool.submit(jax_run, "bottleneck-flax",
                                        {"data": 4}, sharded=False)
            want = {k: f.result() for k, f in runs.items()}
    finally:
        ranks = {lay: wait() for lay, wait in waits.items()}
    return want, ranks


def _max_diff(a: dict, b: dict) -> float:
    return max(float((a[k] - b[k]).abs().max()) for k in b)


@pytest.mark.parametrize("name,lay", CASES,
                         ids=[f"{m}-{lay}" for m, lay in CASES])
def test_matches_the_jax_sharded_state_step(worlds, name, lay):
    """Loss and gradient norm of every step, the final parameters and the
    BatchNorm running statistics, against the JAX sharded-state step on
    the same layout."""
    want, ranks = worlds
    jx = want[(name, lay)]
    for r in ranks[lay]:
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(r[name][k], jx[k], atol=TOL,
                                       rtol=TOL, err_msg=f"{name} {k}")
    got = full_params(ranks[lay], name)
    assert set(got) == set(jx["state"])
    for k, w in jx["state"].items():
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), atol=TOL,
                                   rtol=TOL, err_msg=f"{name} {k}")


@pytest.mark.parametrize("name,lay", CASES,
                         ids=[f"{m}-{lay}" for m, lay in CASES])
def test_ranks_hold_their_blocks_and_agree_on_the_rest(worlds, name, lay):
    """Every whole leaf (the BatchNorm running statistics among them)
    bit-identical on every rank; each split parameter's block and its
    momentum of the block's shape; a conv kernel and, in the Bottleneck
    ResNet, a BatchNorm scale and bias split over fsdp."""
    _, ranks = worlds
    r0 = ranks[lay][0][name]
    for k, (idx, t) in r0["params"].items():
        if idx is None:
            for r in ranks[lay][1:]:
                assert torch.equal(r[name]["params"][k][1], t), k
            continue
        assert list(t.shape) == [hi - lo for lo, hi in idx], k
        assert r0["trace"][k].shape == t.shape, k
    split = {k for k, s in r0["specs"].items() if "fsdp" in s}
    assert any(r0["params"][k][1].dim() == 4 for k in split) or (
        name == "convnet")
    if name.startswith("bottleneck"):
        assert {"layer4.0.bn3.weight", "layer4.0.bn3.bias",
                "layer4.0.downsample.1.weight"} <= split
    assert not any(k.endswith(("running_mean", "running_var"))
                   for k in r0["specs"])


def test_the_tolerance_tells_global_from_per_rank_statistics(worlds):
    """The JAX plain data-parallel step on data=4 (each replica's own two
    rows' statistics, the running statistics averaged) parts from the
    sharded-state step on data=2 x fsdp=2 (the eight rows' statistics) by
    far more than TOL, in the loss and in the final state."""
    want, _ = worlds
    plain, glob = want["plain"], want[("bottleneck-flax", "data2-fsdp2")]
    assert max(abs(a - b) for a, b in zip(plain["loss"], glob["loss"])) \
        > 100 * TOL
    assert _max_diff(plain["state"], glob["state"]) > 100 * TOL
    stats = {k: v for k, v in glob["state"].items()
             if k.endswith("running_var")}
    assert _max_diff({k: plain["state"][k] for k in stats}, stats) \
        > 100 * TOL


@pytest.mark.parametrize("name,overrides", CONFIGS,
                         ids=[f"{c}-{o.get('model_kwargs', {}).get('bn', '')}"
                              .rstrip("-") for c, o in CONFIGS])
@pytest.mark.parametrize("lay", list(MESHES))
def test_the_workloads_step_on_fsdp(worlds, name, overrides, lay):
    """imagenet_resnet50 (each ``bn``), cifar10_resnet18 and mnist_single
    at full width build through ``train.build_harness`` on the mesh and
    take a step: finite, the same on every rank, most of the state split
    over fsdp, every BatchNorm's statistics over the batch group."""
    _, ranks = worlds
    key = name + str(overrides.get("model_kwargs", ""))
    r0 = ranks[lay][0][key]
    for r in ranks[lay]:
        assert r[key] == r0
    assert np.isfinite(r0["loss"]) and np.isfinite(r0["grad_norm"])
    assert r0["fraction"] > 0.9
    batch = MESHES[lay]["data"] * MESHES[lay]["fsdp"]
    if name == "mnist_single":
        assert r0["stats_group"] == {}
    else:
        assert set(r0["stats_group"].values()) == {batch}


@pytest.mark.parametrize("model,mesh,exc", [
    ("resnet50", {"data": 1, "fsdp": 2}, None),
    ("resnet18", {"data": 2, "fsdp": 2}, None),
    ("convnet", {"data": 1, "fsdp": 2}, None),
    ("resnet50", {"data": 1, "fsdp": 2, "model": 2}, ValueError),
    ("convnet", {"data": 1, "expert": 2}, ValueError),
], ids=["resnet50-fsdp2", "resnet18-data2-fsdp2", "convnet-fsdp2",
        "resnet50-model-refused", "convnet-expert-refused"])
def test_image_models_take_fsdp_and_refuse_tensor_parallel_axes(model, mesh,
                                                                exc):
    """The trainer's refusals on the image models: fsdp (with a data
    degree) passes; the model and expert axes, for which the JAX package
    has no tensor-parallel rules, raise ValueError; so do Adasum and
    ``distributed=False`` in the sharded-state mode."""
    cfg = TrainConfig(**common("convnet")).with_overrides(model=model,
                                                          mesh=mesh)
    world = int(np.prod(list(mesh.values())))
    if exc is None:
        sizes = port_train._refuse_unported(cfg, world)
        assert sizes["fsdp"] == mesh["fsdp"]
        for bad in ({"grad_reduce": "adasum"}, {"distributed": False}):
            with pytest.raises(ValueError):
                port_train._refuse_unported(cfg.with_overrides(**bad),
                                            world)
    else:
        with pytest.raises(exc, match="no tensor-parallel rules"):
            port_train._refuse_unported(cfg, world)
