"""``tpuframe_torch.parallel.zero1`` (and the zero1 step, the packing
helpers, the trainer's knob) against ``tpuframe.parallel.zero1``.

- Layout: ``padded_len``, ``padded_bytes`` and ``padding_census`` equal
  the JAX functions' on the tiny ResNet's and the tiny LM's parameters
  (the port's tensors and flax's leaves, matched by their sizes); the
  packing helpers equal ``tpuframe.parallel.fusion``'s bit for bit.
- ``sharded_update`` in gloo worlds of 2 and 4 CPU processes (one
  ``LocalCluster`` launch a world size, each rank running ``_WORKER``),
  against the JAX ``sharded_update`` under ``jax.shard_map(...,
  check_vma=False)`` on a data mesh of the first 2 or 4 virtual devices,
  for sgd with momentum (nesterov, masked decay) and adamw, two updates,
  on the fp and the int8-block wire.  The wire is bit-equal at n=2: each
  rank's chunks of the mean gradient out of the reduce-scatter, fp and
  int8 (a sum of two terms has one order); within 1e-6 relative at n=4.
  The update is not: XLA compiles the optax chain with its multiply-adds
  fused (one rounding where PyTorch's foreach ops take two), which moves
  the last bit of about one element in eight, so the new parameters and
  moments are held to 1e-6 relative at both sizes; on the int8 wire the
  parameters take the quantized delta, which a last-bit change can move
  by one quantization step, so they are held to one step of their
  leaf's delta (``max |delta| / 127``, the wire's error law) beside it.
  Without vma types the JAX ``grad_norm`` is a rank's own chunk's norm,
  so the port's is held to ``optax.global_norm`` of the mean gradient
  instead (1e-6 relative).  With ``fusion_threshold`` the port's update
  is bit-equal to its unbucketed one, in fewer calls.
- The zero1 step: the port's 2-rank zero1 step, 5 steps of the tiny
  Bottleneck ResNet with BN (nesterov SGD; the port's ``bn="fused"``
  against the JAX ``bn="flax"``, as ``test_torch_fusion_train.py`` does)
  and of the tiny LM (adamw, no clip), against the JAX REPLICATED step on
  a data=2 mesh (zero1's own contract, ``tests/test_zero1.py``: the JAX
  zero1 step does not trace on this jax): losses within 1e-5, parameters
  and statistics within 1e-5 absolute; at 4 MiB bit-equal to the unset
  zero1 run; the wire's bytes a step the padded bytes each way, no
  gradient all-reduce, a call a leaf (or a bucket).
- The trainer: ``TPUFRAME_WEIGHT_UPDATE=zero1`` and
  ``TPUFRAME_WIRE_FORMAT=int8-block`` through ``train.main`` on two
  processes, with their run events and each rank's moments ``[padded /
  n]``; ``TPUFRAME_CHECK_SPMD=1`` stops ranks that disagree on the weight
  update before step 1.
- Refusals: clipping or LARS with zero1, Adasum, no world, a seq degree
  above 1, a replicated optimizer in the zero1 step, a sharded one in the
  replicated step or under ``hvd.broadcast_optimizer_state``.
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
import optax  # noqa: E402
from jax.sharding import Mesh, PartitionSpec as P  # noqa: E402

from tpuframe import models as jax_models  # noqa: E402
from tpuframe import train as jax_train  # noqa: E402
from tpuframe.models import resnet as jax_resnet  # noqa: E402
from tpuframe.parallel import collectives as jax_collectives  # noqa: E402
from tpuframe.parallel import fusion as jax_fusion  # noqa: E402
from tpuframe.parallel import mesh as jax_mesh  # noqa: E402
from tpuframe.parallel import quantwire as jax_qw  # noqa: E402
from tpuframe.parallel import step as jax_step  # noqa: E402
from tpuframe.parallel import zero1 as jax_zero1  # noqa: E402
from tpuframe.utils import optim as jax_optim  # noqa: E402
from tpuframe.utils.config import TrainConfig as JaxTrainConfig  # noqa: E402
from tpuframe_torch import train as port_train  # noqa: E402
from tpuframe_torch.data import datasets  # noqa: E402
from tpuframe_torch.launch.launcher import LocalCluster  # noqa: E402
from tpuframe_torch.models import resnet as port_resnet  # noqa: E402
from tpuframe_torch.models import transformer_lm as torch_lm  # noqa: E402
from tpuframe_torch.models.convert import (params_from_jax,  # noqa: E402
                                           resnet_from_jax)
from tpuframe_torch.obs import events  # noqa: E402
from tpuframe_torch.parallel import fusion, hvd, zero1  # noqa: E402
from tpuframe_torch.parallel import step as port_step  # noqa: E402
from tpuframe_torch.utils.config import TrainConfig  # noqa: E402
from tpuframe_torch.utils.optim import build_optimizer  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLDS = (2, 4)
RTOL = {2: 0.0, 4: 1e-6}
UPDATE_RTOL = 1e-6
STEP_ATOL = 1e-5
STEPS = 5
UPDATE_THRESHOLD = 8192     # two buckets of SHAPES' four leaves
# the step's buckets: 9 of the tiny ResNet's 29 leaves, 10 of the tiny
# LM's 19
THRESHOLDS = {"image": 4096, "lm": 40000}
# the update's leaves: a length that is no multiple of 4, a bias (not
# decayed), and one under quantwire's size floor at any n
SHAPES = {"weight": (37, 41), "bias": (13,), "w2": (5, 300), "w3": (9, 7)}
IMG = {"image_size": 32, "synthetic_size": 64, "num_classes": 4}
LM_DATA = {"seq_len": 32, "vocab_size": 64, "synthetic_size": 32}
OPTS = ("sgd", "adamw")
WIRES = ("fp", "int8-block")


def _opt_cfg(opt: str) -> dict:
    return dict(name="z1", model="none", optimizer=opt, base_lr=0.1,
                scale_lr_by_batch=False, schedule="constant",
                weight_decay=1e-4 if opt == "sgd" else 0.1)


def _inputs(n: int) -> dict:
    rng = np.random.default_rng(20 + n)
    out = {f"p_{k}": rng.standard_normal(s).astype(np.float32)
           for k, s in SHAPES.items()}
    for k, s in SHAPES.items():
        out[f"g_{k}"] = rng.standard_normal((2, n, *s)).astype(np.float32)
    return out


# One rank of the update world: for each optimizer and wire, two
# sharded_update calls on its row of the gradients (and once more with a
# fusion threshold on the fp wire), the parameters, its moment chunks,
# the norms and the wire's calls.
_WORKER = r"""
import json, os, sys
import numpy as np
import torch
from tpuframe_torch.parallel import bootstrap, collectives, zero1
from tpuframe_torch.utils.config import TrainConfig
from tpuframe_torch.utils.optim import build_optimizer

inp, out, cases = sys.argv[1], sys.argv[2], json.loads(sys.argv[3])
bootstrap.initialize(device="cpu")
grp = collectives.group()
n, r = collectives.world()
data = np.load(inp)
names = [k[2:] for k in data.files if k.startswith("p_")]


class Leaves(torch.nn.Module):
    def __init__(self):
        super().__init__()
        for k in names:
            setattr(self, k, torch.nn.Parameter(
                torch.from_numpy(data[f"p_{k}"].copy())))


arrays, info = {}, {}
# the wire alone: this rank's chunks of the first gradients' mean
flats = [zero1.flat_pad(torch.from_numpy(data[f"g_{k}"][0, r].copy()), n)
         for k in names]
for wire in ("fp", "int8-block"):
    chunks, _ = zero1.scatter_grads(flats, grp, wire_format=wire)
    for k, t in zip(names, chunks):
        arrays[f"scatter-{wire}/{k}"] = t
for case in cases:
    tag, threshold = case["tag"], case["threshold"]
    model = Leaves()
    opt = build_optimizer(TrainConfig(**case["cfg"]), model,
                          shards=(n, r))
    norms, calls = [], []
    for i in range(2):
        for k in names:
            getattr(model, k).grad = torch.from_numpy(
                data[f"g_{k}"][i, r].copy())
        collectives.reset_wire()
        norms.append(float(zero1.sharded_update(
            opt, grp, wire_format=case["wire"],
            fusion_threshold=threshold)))
        calls.append(dict(collectives.WIRE_CALLS))
    for k in names:
        arrays[f"{tag}/p/{k}"] = getattr(model, k).detach()
    for key, ts in opt.moments.items():
        for k, t in zip(opt.names, ts):
            arrays[f"{tag}/{key}/{k}"] = t
    info[tag] = {"norms": norms, "calls": calls, "count": opt.count}
np.savez(f"{out}.{r}.npz", **{k: v.numpy() for k, v in arrays.items()})
with open(f"{out}.{r}.json", "w") as f:
    json.dump(info, f)
bootstrap.shutdown()
# torch 2.13's gloo worlds can abort in the interpreter's teardown (the
# replicated trainer's too): the results are written, so skip it
sys.stdout.flush()
os._exit(0)
"""


def _cases():
    out = []
    for opt in OPTS:
        for wire in WIRES:
            out.append({"tag": f"{opt}-{wire}", "cfg": _opt_cfg(opt),
                        "wire": wire, "threshold": None})
        out.append({"tag": f"{opt}-fused", "cfg": _opt_cfg(opt),
                    "wire": "fp", "threshold": UPDATE_THRESHOLD})
    return out


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """``{n: (inputs, [rank r's arrays], [rank r's json])}``."""
    root = tmp_path_factory.mktemp("zero1")
    out = {}
    for n in WORLDS:
        inputs = _inputs(n)
        path = root / f"in{n}.npz"
        np.savez(path, **inputs)
        stem = root / f"out{n}"
        LocalCluster(n, timeout=300, extra_env={
            "PYTHONPATH": REPO, "TPUFRAME_DIST_BACKEND": "gloo",
            "OMP_NUM_THREADS": "1"}).launch(
            [sys.executable, "-c", _WORKER, str(path), str(stem),
             json.dumps(_cases())])
        out[n] = (inputs, [dict(np.load(f"{stem}.{r}.npz"))
                           for r in range(n)],
                  [json.loads(open(f"{stem}.{r}.json").read())
                   for r in range(n)])
    return out


def _jax_update(n, inputs, opt, wire):
    """Two JAX ``sharded_update`` calls on a data mesh of n devices with
    ``check_vma=False``: (params, global flat moments by name)."""
    params = {k: jnp.asarray(inputs[f"p_{k}"]) for k in SHAPES}
    tx = jax_optim.build_optimizer(JaxTrainConfig(**_opt_cfg(opt)), params)
    state = jax_zero1.init_opt_state(tx, params, n)
    spec = jax.tree.map(lambda l: P("data") if l.ndim >= 1 else P(), state)
    mesh = Mesh(np.asarray(jax.devices()[:n]), ("data",))

    def body(p, o, g):
        new_p, new_o, _ = jax_zero1.sharded_update(
            tx, "data", p, o, jax.tree.map(lambda a: a[0], g),
            wire_format=wire)
        return new_p, new_o

    f = jax.jit(jax.shard_map(body, mesh=mesh,
                              in_specs=(P(), spec, P("data")),
                              out_specs=(P(), spec), check_vma=False))
    for i in range(2):
        grads = {k: jnp.asarray(inputs[f"g_{k}"][i]) for k in SHAPES}
        params, state = f(params, state, grads)
    moments = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(state)[0]:
        keys = [getattr(p, "name", getattr(p, "key", None)) for p in path]
        if leaf.ndim:
            moments[(keys[-2], keys[-1])] = np.asarray(leaf)
    return {k: np.asarray(v) for k, v in params.items()}, moments


def _close(got, want, rtol):
    if rtol == 0.0:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=rtol,
                                   atol=rtol * np.abs(want).max())


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("wire", WIRES)
def test_scatter_chunks_match_jax(worlds, n, wire):
    inputs, arrays, _ = worlds[n]

    def scatter(g):
        flat = g.reshape(-1)
        flat = jnp.pad(flat, (0, zero1.padded_len(flat.size, n) - flat.size))
        if wire == "fp" or flat.size < jax_qw.MIN_QUANT_ELEMS:
            return jax_collectives.reduce_scatter(flat, "data", average=True)
        return jax_qw.reduce_scatter_mean(flat, "data")

    mesh = Mesh(np.asarray(jax.devices()[:n]), ("data",))
    for k in SHAPES:
        f = jax.jit(jax.shard_map(lambda g: scatter(g[0])[None], mesh=mesh,
                                  in_specs=P("data"), out_specs=P("data"),
                                  check_vma=False))
        want = np.asarray(f(inputs[f"g_{k}"][0]))
        got = np.stack([arrays[r][f"scatter-{wire}/{k}"] for r in range(n)])
        _close(got, want, RTOL[n])


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("opt", OPTS)
@pytest.mark.parametrize("wire", WIRES)
def test_sharded_update_matches_jax(worlds, n, opt, wire):
    inputs, arrays, infos = worlds[n]
    want_p, want_m = _jax_update(n, inputs, opt, wire)
    tag = f"{opt}-{wire}"
    for k in SHAPES:
        delta = np.abs(want_p[k] - inputs[f"p_{k}"]).max()
        step = (delta / 127 if wire == "int8-block"
                and zero1.padded_len(want_p[k].size, n)
                >= jax_qw.MIN_QUANT_ELEMS else 0.0)
        for r in range(n):
            np.testing.assert_allclose(
                arrays[r][f"{tag}/p/{k}"], want_p[k], rtol=UPDATE_RTOL,
                atol=UPDATE_RTOL * np.abs(want_p[k]).max() + step,
                err_msg=k)
        assert delta > 1e-3                     # the update moved it
    for (key, k), full in want_m.items():
        # rank r holds chunk r of the global flat vector, and no more
        got = np.concatenate([arrays[r][f"{tag}/{key}/{k}"]
                              for r in range(n)])
        assert arrays[0][f"{tag}/{key}/{k}"].size == full.size // n
        _close(got, full, UPDATE_RTOL)
    assert {info[tag]["count"] for info in infos} == {2}


@pytest.mark.parametrize("n", WORLDS)
def test_grad_norm_is_the_mean_gradients_norm(worlds, n):
    inputs, _, infos = worlds[n]
    for i in range(2):
        mean = {k: jnp.asarray(inputs[f"g_{k}"][i].mean(axis=0))
                for k in SHAPES}
        want = float(optax.global_norm(mean))
        for info in infos:
            for opt in OPTS:
                got = info[f"{opt}-fp"]["norms"][i]
                assert abs(got - want) <= 1e-6 * want


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("opt", OPTS)
def test_buckets_change_the_calls_not_the_values(worlds, n, opt):
    _, arrays, infos = worlds[n]
    for r in range(n):
        for key in arrays[r]:
            if key.startswith(f"{opt}-fp/"):
                np.testing.assert_array_equal(
                    arrays[r][key.replace("-fp/", "-fused/")],
                    arrays[r][key])
    padded = [torch.empty(zero1.padded_len(int(np.prod(s)), n),
                          device="meta") for s in SHAPES.values()]
    buckets = fusion.bucket_census(padded, UPDATE_THRESHOLD)["n_buckets"]
    assert 1 < buckets < len(SHAPES)
    for calls in infos[0][f"{opt}-fused"]["calls"]:
        assert calls == {"reduce_scatter": buckets, "all_gather": buckets,
                         "all_to_all": 0, "all_reduce": 0}
    for calls in infos[0][f"{opt}-fp"]["calls"]:
        assert calls["reduce_scatter"] == calls["all_gather"] == len(SHAPES)


def _tiny_trees():
    """The tiny ResNet's and tiny LM's parameters: (flax tree, port
    module) pairs."""
    jres = jax_resnet.ResNet(stage_sizes=(1, 1),
                             block_cls=jax_resnet.Bottleneck, num_classes=4,
                             width=8, bn="flax")
    v = jres.init(jax.random.key(0), jnp.zeros((2, 32, 32, 3)), train=True)
    pres = port_resnet.ResNet((1, 1), port_resnet.Bottleneck, num_classes=4,
                              width=8, bn="fused", device="cpu")
    jlm = jax_models.get_model("transformer-lm", tiny=True, vocab_size=64,
                               dtype=jnp.float32)
    lv = jlm.init(jax.random.key(0), jnp.zeros((1, 32), jnp.int32))
    plm = torch_lm.TransformerLM(torch_lm.LMConfig.tiny(vocab_size=64),
                                 device="cpu")
    return [(v["params"], pres), (lv["params"], plm)]


@pytest.mark.parametrize("n", (1, 2, 3, 4, 8))
def test_layout_matches_jax(n):
    for jtree, module in _tiny_trees():
        want = jax_zero1.padding_census(jtree, n)
        got = zero1.padding_census(module, n)
        assert zero1.padded_bytes(module, n) == jax_zero1.padded_bytes(
            jtree, n) == want["padded_bytes"] == got["padded_bytes"]
        for key in ("n_shards", "total_elems", "padded_elems",
                    "total_bytes", "waste_frac"):
            assert got[key] == want[key], key
        rows = lambda c: sorted((r["size"], r["padded"], r["pad_waste"],  # noqa: E731
                                 r["padded_bytes"], r["dtype"])
                                for r in c["leaves"])
        assert rows(got) == rows(want)
    for size in (0, 1, 7, 1024, 1237):
        assert zero1.padded_len(size, n) == jax_zero1.padded_len(size, n)


def test_packing_helpers_bit_equal_to_jax():
    rng = np.random.default_rng(5)
    n = 4
    flats = [rng.standard_normal(zero1.padded_len(s, n)).astype(np.float32)
             for s in (10, 37, 4, 1)]
    packed = fusion.pack_for_scatter([torch.from_numpy(f) for f in flats], n)
    want = np.asarray(jax_fusion.pack_for_scatter(
        [jnp.asarray(f) for f in flats], n))
    np.testing.assert_array_equal(packed.numpy(), want)
    chunks = [f.size // n for f in flats]
    shard = packed.view(n, -1)[1]
    got = fusion.split_scattered(shard, chunks)
    for g, w in zip(got, jax_fusion.split_scattered(jnp.asarray(shard.numpy()),
                                                    chunks)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    back = fusion.split_gathered(packed, n, chunks)
    for g, w, f in zip(back, jax_fusion.split_gathered(jnp.asarray(want), n,
                                                       chunks), flats):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        np.testing.assert_array_equal(g.numpy(), f)


def _img_cfg():
    return dict(name="img", model="resnet50", model_kwargs={"bn": "fused"},
                dataset="imagenet", dataset_kwargs=IMG, optimizer="sgd",
                base_lr=0.4, warmup_steps=1, schedule="cosine",
                weight_decay=1e-4, label_smoothing=0.1, global_batch=8,
                total_steps=10, augment="none")


def _lm_cfg():
    return dict(name="lm", model="transformer-lm",
                model_kwargs={"tiny": True, "vocab_size": 64},
                dataset="lm_text", dataset_kwargs=LM_DATA,
                optimizer="adamw", base_lr=3e-3, scale_lr_by_batch=False,
                schedule="constant", global_batch=4, weight_decay=0.1,
                grad_clip_norm=None)


def _jax_steps(kind):
    """STEPS JAX harness steps on a data=2 mesh, replicated: (losses,
    final state_dict, init state_dict) in the port's names."""
    if kind == "image":
        model = jax_resnet.ResNet(stage_sizes=(1, 1),
                                  block_cls=jax_resnet.Bottleneck,
                                  num_classes=4, width=8, bn="flax")
        v = jax.tree.map(np.asarray, model.init(
            jax.random.key(0), jnp.zeros((2, 32, 32, 3)), train=True))
        jcfg = JaxTrainConfig(**{**_img_cfg(),
                                 "model_kwargs": {"bn": "flax"}})
        params, ms = v["params"], {"batch_stats": v["batch_stats"]}
        train, _ = datasets.imagenet(None, **IMG)
        rows, spec = 8, jax_mesh.MeshSpec(data=2)
    else:
        jcfg = JaxTrainConfig(**_lm_cfg())
        model = jax_models.get_model("transformer-lm", dtype=jnp.float32,
                                     **jcfg.model_kwargs)
        params = jax.tree.map(np.asarray, model.init(
            jax.random.key(0), jnp.zeros((1, 32), jnp.int32))["params"])
        ms = None
        train, _ = datasets.lm_text(None, **LM_DATA)
        rows, spec = 4, jax_mesh.MeshSpec(data=2, seq=1)
    tx = jax_optim.build_optimizer(jcfg, params)
    state = jax_step.TrainState.create(params, tx, model_state=ms)
    mesh = jax_mesh.make_mesh(spec, devices=jax.devices()[:2])
    step = jax_step.make_train_step(jax_train.make_loss_fn(jcfg, model), tx,
                                    mesh, donate=False)
    losses = []
    for i in range(STEPS):
        b = train[np.arange(rows * i, rows * i + rows)]
        state, m = step(state, {k: jnp.asarray(x) for k, x in b.items()})
        losses.append(float(m["loss"]))
    if kind == "image":
        final = resnet_from_jax(
            jax.tree.map(np.asarray, state.params),
            jax.tree.map(np.asarray, state.model_state["batch_stats"]))
        init = resnet_from_jax(params, ms["batch_stats"])
    else:
        final = params_from_jax(jax.tree.map(np.asarray, state.params))
        init = params_from_jax(params)
    return losses, final, init


# One rank of the 2-rank step world: each case's STEPS zero1 steps on this
# rank's half of each batch, unset and at its threshold; rank 0 writes
# the losses, the state and each step's wire counts.
_STEP_WORKER = r"""
import json, os, sys
import numpy as np
import torch
import torch.distributed as dist
from tpuframe_torch import train as port_train
from tpuframe_torch.data import datasets
from tpuframe_torch.models import resnet as port_resnet
from tpuframe_torch.models import transformer_lm as torch_lm
from tpuframe_torch.parallel import collectives, zero1
from tpuframe_torch.parallel import step as port_step
from tpuframe_torch.utils.config import TrainConfig

rank, port, out, cases = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
steps = int(sys.argv[5])
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        world_size=2, rank=rank)
grp = collectives.group()
result = {}
for case in json.loads(cases):
    cfg = TrainConfig(**case["cfg"])
    for thr in (None, case["threshold"]):
        if case["kind"] == "image":
            ds, _ = datasets.imagenet(None, **cfg.dataset_kwargs)
            model = port_resnet.ResNet((1, 1), port_resnet.Bottleneck,
                                       num_classes=4, width=8, bn="fused",
                                       device="cpu")
            rows = lambda i: np.arange(8 * i + 4 * rank, 8 * i + 4 * rank + 4)
        else:
            ds, _ = datasets.lm_text(None, **cfg.dataset_kwargs)
            model = torch_lm.TransformerLM(
                torch_lm.LMConfig.tiny(vocab_size=64), device="cpu")
            rows = lambda i: np.arange(4 * i + 2 * rank, 4 * i + 2 * rank + 2)
        model.load_state_dict(torch.load(case["init"]))
        if thr is not None:
            os.environ["TPUFRAME_FUSION_THRESHOLD"] = str(thr)
        state = zero1.make_state(cfg, model, grp)
        step = port_step.make_train_step(port_train.make_loss_fn(cfg),
                                         weight_update="zero1",
                                         fusion_threshold=thr)
        os.environ.pop("TPUFRAME_FUSION_THRESHOLD", None)
        losses, wire = [], []
        for i in range(steps):
            collectives.reset_wire()
            m = step(state, {k: torch.from_numpy(v)
                             for k, v in ds[rows(i)].items()})
            losses.append(float(m["loss"]))
            wire.append({"bytes": dict(collectives.WIRE_BYTES),
                         "calls": dict(collectives.WIRE_CALLS)})
        result[f"{case['name']}-{'fused' if thr else 'unset'}"] = {
            "losses": losses, "wire": wire,
            "moment_elems": [t.numel() for ts in state.opt.moments.values()
                             for t in ts],
            "param_sizes": [p.numel() for p in state.opt.params],
            "state": {k: v.tolist() for k, v in model.state_dict().items()}}
if rank == 0:
    with open(out, "w") as f:
        json.dump(result, f)
dist.destroy_process_group()
# torch 2.13's gloo worlds can abort in the interpreter's teardown (the
# replicated trainer's too): the results are written, so skip it
sys.stdout.flush()
os._exit(0)
"""


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def zero1_steps(tmp_path_factory):
    """The JAX replicated steps and the port's 2-rank zero1 steps of
    both models."""
    img, lm = _jax_steps("image"), _jax_steps("lm")
    root = tmp_path_factory.mktemp("zero1_steps")
    torch.save(img[2], root / "img.pt")
    torch.save(lm[2], root / "lm.pt")
    cases = [{"name": "image", "kind": "image", "cfg": _img_cfg(),
              "init": str(root / "img.pt"), "threshold": THRESHOLDS["image"]},
             {"name": "lm", "kind": "lm", "cfg": _lm_cfg(),
              "init": str(root / "lm.pt"), "threshold": THRESHOLDS["lm"]}]
    out = root / "rank0.json"
    port = str(_free_port())
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    env.pop(fusion.ENV_VAR, None)
    procs = [subprocess.Popen(
        [sys.executable, "-c", _STEP_WORKER, str(r), port, str(out),
         json.dumps(cases), str(STEPS)], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    for p in procs:
        _, err = p.communicate(timeout=300)
        assert p.returncode == 0, err
    return json.loads(out.read_text()), {"image": img, "lm": lm}


@pytest.mark.parametrize("name", ["image", "lm"])
def test_zero1_steps_match_the_jax_replicated_data2_step(zero1_steps, name):
    got, want = zero1_steps
    losses, final, _ = want[name]
    run = got[f"{name}-unset"]
    np.testing.assert_allclose(run["losses"], losses, atol=STEP_ATOL, rtol=0)
    assert set(final) <= set(run["state"])
    for k, w in final.items():
        np.testing.assert_allclose(np.asarray(run["state"][k]), w.numpy(),
                                   atol=STEP_ATOL, rtol=0, err_msg=k)


@pytest.mark.parametrize("name", ["image", "lm"])
def test_zero1_step_wire_follows_the_byte_law(zero1_steps, name):
    got, _ = zero1_steps
    unset, fused = got[f"{name}-unset"], got[f"{name}-fused"]
    sizes = unset["param_sizes"]              # the optimizer's order
    padded = sum(zero1.padded_len(s, 2) * 4 for s in sizes)
    assert fused["state"] == unset["state"]
    assert fused["losses"] == unset["losses"]
    # each rank holds [padded / n] of every moment
    per = [zero1.padded_len(s, 2) // 2 for s in sizes]
    assert unset["moment_elems"] == per * (len(unset["moment_elems"])
                                           // len(per))
    for run in (unset, fused):
        for st in run["wire"]:
            assert st["bytes"] == {"reduce_scatter": padded,
                                   "all_gather": padded, "all_to_all": 0,
                                   "all_reduce": 0}
    meta = [torch.empty(zero1.padded_len(s, 2), device="meta")
            for s in sizes]
    buckets = fusion.bucket_census(meta, THRESHOLDS[name])["n_buckets"]
    assert 1 < buckets < len(sizes)
    for st in unset["wire"]:
        assert st["calls"]["reduce_scatter"] == len(sizes)
    for st in fused["wire"]:
        assert st["calls"]["reduce_scatter"] == buckets


@pytest.fixture
def clean(monkeypatch):
    for var in (events.ENV_DIR, fusion.ENV_VAR, "TPUFRAME_CHECK_SPMD",
                zero1.ENV_VAR, "TPUFRAME_WIRE_FORMAT",
                "TPUFRAME_WIRE_FORMAT_DCN", "TPUFRAME_HIER",
                "TPUFRAME_FAULTS", "TPUFRAME_ATTEMPT"):
        monkeypatch.delenv(var, raising=False)
    yield monkeypatch
    events.close()


# A rank of the trainer runs: the smoke ConvNet on data=2 through
# train.main with this run's environment; writes its moments' sizes.
_TRAIN_WORKER = r"""
import json, os, sys
from tpuframe_torch import train
from tpuframe_torch.parallel import bootstrap, zero1
rank = int(os.environ["TPUFRAME_PROCESS_ID"])
for var, vals in json.loads(sys.argv[2]).items():
    os.environ[var] = vals[rank]
seen = {}
build = train.build_harness


def capturing(cfg, device="cuda"):
    h = build(cfg, device)
    seen["h"] = h
    return h


train.build_harness = capturing
m = train.main(["--config", "smoke", "--device", "cpu", "--set",
                'mesh={"data": 2}', "--set", "total_steps=3", "--set",
                'dataset_kwargs={"synthetic_size": 64}', "--set",
                "global_batch=8", "--set", "eval_every=3", "--set",
                "eval_batches=1", "--events-dir", sys.argv[1]])
h = seen["h"]
opt = h.state.opt
with open(os.path.join(sys.argv[1], f"rank{rank}.json"), "w") as f:
    json.dump({"losses": m["losses"], "shards": opt.shards,
               "update": list(h.weight_update), "wire": list(h.wire_format),
               "moments": [t.numel() for ts in opt.moments.values()
                           for t in ts],
               "params": [p.numel() for p in opt.params]}, f)
bootstrap.shutdown()
# torch 2.13's gloo worlds can abort in the interpreter's teardown (the
# replicated trainer's too): the results are written, so skip it
sys.stdout.flush()
os._exit(0)
"""


def _train_world(tmp_path, env_by_rank: dict):
    LocalCluster(2, timeout=240, extra_env={
        "PYTHONPATH": REPO, "TPUFRAME_DIST_BACKEND": "gloo",
        "OMP_NUM_THREADS": "1"}).launch(
        [sys.executable, "-c", _TRAIN_WORKER, str(tmp_path),
         json.dumps(env_by_rank)])
    return [json.loads((tmp_path / f"rank{r}.json").read_text())
            for r in range(2)]


@pytest.mark.parametrize("update,wire", [("zero1", "fp"),
                                         ("zero1", "int8-block"),
                                         ("replicated", "int8-block")])
def test_the_trainer_runs_zero1_and_the_int8_wire(clean, tmp_path, update,
                                                  wire):
    env = {}
    if update == "zero1":
        env[zero1.ENV_VAR] = [update, update]
    if wire != "fp":
        env["TPUFRAME_WIRE_FORMAT"] = [wire, wire]
    ranks = _train_world(tmp_path, env)
    assert ranks[0]["losses"] == ranks[1]["losses"]
    for r, got in enumerate(ranks):
        assert got["update"] == [update, "env" if update == "zero1"
                                 else "default"]
        assert got["wire"] == [wire, "env" if wire != "fp" else "default"]
        if update == "zero1":
            assert got["shards"] == [2, r]
            per = [zero1.padded_len(s, 2) // 2 for s in got["params"]]
            assert got["moments"] == per * (len(got["moments"])
                                            // len(per))
    recs = events.merge(str(tmp_path))
    wu = [(r["mode"], r["source"], r["n_shards"]) for r in recs
          if r["type"] == "weight_update"]
    wf = [(r["format"], r["source"]) for r in recs
          if r["type"] == "wire_format"]
    assert set(wu) == {(update, "env" if update == "zero1" else "default",
                        2)}
    assert set(wf) == {(wire, "env" if wire != "fp" else "default")}


def test_ranks_that_disagree_on_the_update_stop_before_step_1(clean,
                                                              tmp_path):
    env = {zero1.ENV_VAR: ["zero1", "replicated"],
           "TPUFRAME_CHECK_SPMD": ["1", "1"]}
    with pytest.raises(RuntimeError) as err:
        _train_world(tmp_path, env)
    text = str(err.value)
    assert text.count("SPMD divergence in 'train_step:program'") == 2
    assert not (tmp_path / "rank0.json").exists()


def test_refusals(clean):
    def loss_fn(model, batch, seed):
        return torch.zeros(()), {}

    model = torch.nn.Linear(3, 2)
    clip = TrainConfig(**{**_opt_cfg("adamw"), "grad_clip_norm": 1.0})
    with pytest.raises(ValueError, match="grad_clip_norm.*ZeRO-1"):
        build_optimizer(clip, model, shards=(2, 0))
    lars = TrainConfig(**{**_opt_cfg("sgd"), "optimizer": "lars"})
    with pytest.raises(ValueError, match="lars.*ZeRO-1"):
        build_optimizer(lars, model, shards=(2, 0))
    with pytest.raises(ValueError, match="zero1.*adasum"):
        port_step.make_train_step(loss_fn, weight_update="zero1",
                                  grad_reduce="adasum")
    with pytest.raises(ValueError, match="zero1.*needs a world"):
        port_step.make_train_step(loss_fn, weight_update="zero1",
                                  distributed=False)
    with pytest.raises(ValueError, match="unknown weight-update mode"):
        port_step.make_train_step(loss_fn, weight_update="zero3")
    sharded = build_optimizer(TrainConfig(**_opt_cfg("sgd")), model,
                              shards=(2, 0))
    with pytest.raises(ValueError, match="ZeRO-1 layout"):
        hvd.broadcast_optimizer_state(sharded)
    with pytest.raises(ValueError, match="zero1.sharded_update"):
        sharded.step()
    # a replicated optimizer reaching the zero1 step
    step = port_step.make_train_step(
        lambda m, b, s: (m(b["x"]).sum(), {}), weight_update="zero1")
    state = port_step.TrainState(model, build_optimizer(
        TrainConfig(**_opt_cfg("sgd")), model))
    with pytest.raises(ValueError, match="zero1.make_state"):
        step(state, {"x": torch.ones(2, 3)})
    # the env ask on a config the zero1 step cannot serve
    clean.setenv(zero1.ENV_VAR, "zero1")
    cfg = port_train.get_config("mnist_single").with_overrides(
        total_steps=1, dataset_kwargs={"synthetic_size": 64})
    with pytest.raises(ValueError, match="zero1.*needs a world"):
        port_train.build_harness(cfg, device="cpu")
    with pytest.raises(ValueError, match="zero1 with mesh seq=4"):
        port_train._resolved_update({"data": 2, "seq": 4})
    clean.delenv(zero1.ENV_VAR)
    assert port_train._resolved_update({"data": 2, "seq": 4}) == (
        ("replicated", "default"), ("fp", "default"))


def test_resolution_and_check(clean):
    assert zero1.resolve() == ("replicated", "default")
    clean.setenv(zero1.ENV_VAR, " ZeRO1 ")
    assert zero1.resolve() == ("zero1", "env")
    assert zero1.check() == []
    clean.setenv(zero1.ENV_VAR, "zero3")
    assert any(zero1.ENV_VAR in p for p in zero1.check())
    assert zero1.MODES == jax_zero1.MODES
    # a one-process world is n=1: the replicated update on one chunk
    model = torch.nn.Linear(3, 2)
    cfg = TrainConfig(**_opt_cfg("adamw"))
    ref = torch.nn.Linear(3, 2)
    ref.load_state_dict(model.state_dict())
    state = zero1.make_state(cfg, model, None)
    opt = build_optimizer(cfg, ref)
    for p, q in zip(model.parameters(), ref.parameters()):
        p.grad = torch.ones_like(p)
        q.grad = torch.ones_like(q)
    zero1.sharded_update(state.opt, None)
    opt.step()
    for p, q in zip(model.parameters(), ref.parameters()):
        torch.testing.assert_close(p, q, rtol=0, atol=0)
