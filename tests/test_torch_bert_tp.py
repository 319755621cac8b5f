"""BERT's tensor parallelism and fsdp in tpuframe_torch against the JAX
package's sharded-state trainer.

One gloo world of four CPU processes trains tiny BERT (2 layers, 128
wide, 4 heads) on synthetic SST-2 through ``train.build_harness`` with
``glue_bert``'s recipe (adamw, the decay mask, clip 1.0) in f32 at lr
2e-4 from step 0 (ten times the recipe's peak, so that three steps move
a parameter by up to 6e-4, twenty times the tolerance), from the flax
init, three steps on each rank's batch rows:

  - with dropout 0 on ``data=2 x model=2`` and ``fsdp=2 x model=2``,
    against the JAX harness's sharded-state step with ``BERT_RULES`` on
    the same mesh of the conftest's virtual devices: losses and gradient
    norms within 3e-5, absolute and relative (``tests/test_fsdp.py``'s
    tolerance), and the final parameters within 3e-5 under the
    layout-sensitive rule of ``test_torch_fsdp.py``; then one eval batch,
    each metric the mean over the batch group, against the JAX metric
    function on the JAX step's parameters and the whole batch, within
    3e-5;
  - with dropout 0.1 on ``model=4`` (a head a rank), against the port's
    one-process BERT at the same seed in this process: a rank draws the
    attention-probability masks its heads have in the whole layer, so
    the two train one model, within f32 summation noise (the Megatron
    sums' order being the only difference): losses and gradient norms
    within 3e-5 at every step, and each parameter's step-1 gradient
    within 1e-5 of its norm.  Masks drawn for the rank's own block would
    part the losses at step 1 by ~1e-2.  Final parameters are not held
    here: Adam's first steps turn a gradient element at rounding scale
    into a move of the learning rate, whose sign the summation order
    decides.

The attention's key bias has a zero gradient by symmetry (the bias adds
``q.b`` to every score of a row, which the softmax cancels): its
gradients are rounding noise on every layout, which Adam turns into moves
of up to the learning rate a step.  Its final values are held to that
bound, on both packages, rather than to each other.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import NamedSharding  # noqa: E402

from tpuframe import models as jax_models  # noqa: E402
from tpuframe import train as jax_train  # noqa: E402
from tpuframe.parallel import fsdp as jax_fsdp  # noqa: E402
from tpuframe.parallel import mesh as jax_mesh  # noqa: E402
from tpuframe.parallel import step as jax_step  # noqa: E402
from tpuframe.parallel import tp as jax_tp  # noqa: E402
from tpuframe.utils import build_optimizer as jax_build_optimizer  # noqa: E402
from tpuframe.utils.config import get_config as jax_get_config  # noqa: E402
from tpuframe_torch import train as port_train  # noqa: E402
from tpuframe_torch.data import datasets  # noqa: E402
from tpuframe_torch.models.convert import bert_params_from_jax  # noqa: E402
from tpuframe_torch.utils.config import get_config  # noqa: E402
from test_torch_fsdp import (  # noqa: E402
    assert_params, full_params, jax_init, spread, start_world)

STEPS, BATCH, SEQ = 3, 8, 32
TOL = 3e-5
TINY = {"vocab_size": 1024, "hidden_size": 128, "num_layers": 2,
        "num_heads": 4, "intermediate_size": 256, "max_position": 128,
        "num_classes": 2}
# (run, mesh, dropout)
RUNS = [("data2-model2", {"data": 2, "model": 2}, 0.0),
        ("fsdp2-model2", {"data": 1, "fsdp": 2, "model": 2}, 0.0),
        ("model4-dropout", {"data": 1, "model": 4}, 0.1)]


def overrides(dropout: float) -> dict:
    return dict(model_kwargs=dict(TINY, dropout=dropout),
                dataset_kwargs={"seq_len": SEQ, "vocab_size": 1024,
                                "synthetic_size": 64},
                global_batch=BATCH, total_steps=10, warmup_steps=0,
                base_lr=2e-4, compute_dtype="float32")


def data():
    train, evals = datasets.build("glue_sst2", None,
                                  **overrides(0.0)["dataset_kwargs"])
    return ([train[np.arange(BATCH * i, BATCH * (i + 1))]
             for i in range(STEPS)], evals[np.arange(BATCH)])


def jax_run(mesh_kw: dict) -> dict:
    """The JAX harness's glue_bert sharded-state step (dropout 0) on
    ``mesh_kw`` with ``BERT_RULES``; then its metric function on the
    whole eval batch."""
    jcfg = jax_get_config("glue_bert").with_overrides(
        **overrides(0.0)).with_overrides(mesh=mesh_kw)
    model = jax_models.get_model("bert-base", dtype=jnp.float32,
                                 **jcfg.model_kwargs)
    params = jax_init("bert-base", dict(jcfg.model_kwargs), SEQ)
    tx = jax_build_optimizer(jcfg, params)
    state = jax_step.TrainState.create(params, tx)
    mesh = jax_mesh.make_mesh(
        jax_mesh.MeshSpec(**mesh_kw),
        devices=jax.devices()[:int(np.prod(list(mesh_kw.values())))])
    shardings = jax_fsdp.state_shardings(
        state, mesh, tp_rules=jax_tp.rules_for_model("bert-base"))
    state = jax.tree.map(jax.device_put, state, shardings)
    on = NamedSharding(jax_fsdp.auto_mesh(mesh), jax_mesh.batch_spec())
    step = jax_step.make_train_step(jax_train.make_loss_fn(jcfg, model), tx,
                                    mesh, donate=False,
                                    state_shardings=shardings)
    out = {"loss": [], "grad_norm": []}
    train, evals = data()
    for b in train:
        state, m = step(state, {k: jax.device_put(jnp.asarray(v), on)
                                for k, v in b.items()})
        for k in out:
            out[k].append(float(m[k]))
    trained = jax.tree.map(np.asarray, state.params)
    metric = jax.jit(jax_train.make_metric_fn(jcfg, model))
    out["eval"] = {k: float(v) for k, v in metric(
        trained, {}, {k: jnp.asarray(v) for k, v in evals.items()}).items()}
    out["params"] = bert_params_from_jax(trained)
    return out


# One rank of the world of four: each run of RUNS through the trainer's
# harness from the flax init, three steps and one eval batch on this
# rank's batch rows.
_WORKER = r"""
import json, os, sys
import numpy as np
import torch
import torch.distributed as dist
from tpuframe_torch import train as port_train
from tpuframe_torch.parallel import tp
from tpuframe_torch.utils.config import get_config

rank, port, root = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        world_size=4, rank=rank)
spec = json.load(open(f"{root}/runs.json"))
data = np.load(f"{root}/batches.npz")
init = torch.load(f"{root}/init.pt")
keys = ("input_ids", "attention_mask", "token_type_ids", "label")


def rows(prefix, lay):
    b = {k: data[f"{prefix}{k}"] for k in keys}
    n = b["label"].shape[0] // lay.batch_size
    j = lay.batch_index
    return {k: torch.from_numpy(np.ascontiguousarray(v[j * n:(j + 1) * n]))
            for k, v in b.items()}


result = {}
for name, mesh, over in spec:
    cfg = get_config("glue_bert").with_overrides(**over).with_overrides(
        mesh=mesh)
    h = port_train.build_harness(cfg, device="cpu")
    model, lay = h.state.model, h.layout
    specs = model.shard_specs
    model.load_state_dict({k: tp.cut(v, specs.get(k), lay.sizes,
                                     lay.coords()) for k, v in init.items()})
    got = {"loss": [], "grad_norm": []}
    for i in range(len([f for f in data.files if f.startswith("train")])
                   // len(keys)):
        m = h.train_step(h.state, rows(f"train{i}_", lay))
        for k in ("loss", "grad_norm"):
            got[k].append(float(m[k]))
        if i == 0:
            got["grads"] = {
                k: (None if k not in specs else
                    tp.shard_leaf(p.grad, specs[k], lay).index,
                    p.grad.detach().clone())
                for k, p in model.named_parameters()}
    got["eval"] = {k: float(v) for k, v in
                   h.eval_step(h.state, rows("eval_", lay)).items()}
    got["params"] = {
        k: (None if k not in specs else
            tp.shard_leaf(t, specs[k], lay).index, t.detach().clone())
        for k, t in model.state_dict().items()}
    result[name] = got
torch.save(result, f"{root}/rank{rank}.pt")
os._exit(0)
"""


def one_process(dropout: float, init: dict) -> dict:
    """The port's one-process glue_bert steps from ``init``."""
    cfg = get_config("glue_bert").with_overrides(
        **overrides(dropout)).with_overrides(mesh={"data": 1})
    h = port_train.build_harness(cfg, device="cpu")
    h.state.model.load_state_dict(init)
    train, _ = data()
    out = {"loss": [], "grad_norm": []}
    for b in train:
        m = h.train_step(h.state, {k: torch.from_numpy(v)
                                   for k, v in b.items()})
        for k in ("loss", "grad_norm"):
            out[k].append(float(m[k]))
        out.setdefault("grads", {k: p.grad.detach().clone() for k, p in
                                 h.state.model.named_parameters()})
    return out


def bert_init() -> dict:
    """The flax init of tiny BERT in the port's names."""
    kw = jax_get_config("glue_bert").with_overrides(
        **overrides(0.0)).model_kwargs
    return bert_params_from_jax(jax_init("bert-base", dict(kw), SEQ))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The port's world of four, which runs while this process runs the
    JAX steps and the port's one-process BERT with dropout."""
    init = bert_init()
    root = tmp_path_factory.mktemp("bert_tp")
    torch.save(init, root / "init.pt")
    (root / "runs.json").write_text(json.dumps([
        (name, mesh, overrides(dropout))
        for name, mesh, dropout in RUNS]))
    train, evals = data()
    np.savez(root / "batches.npz",
             **{f"train{i}_{k}": v for i, b in enumerate(train)
                for k, v in b.items()},
             **{f"eval_{k}": v for k, v in evals.items()})
    results = start_world(root, _WORKER)
    try:
        want = {name: jax_run({k: v for k, v in mesh.items() if v > 1})
                for name, mesh, dropout in RUNS if dropout == 0.0}
        want["model4-dropout"] = one_process(0.1, init)
    finally:
        ranks = results()
    return want, ranks


ZERO_GRAD = "attention.key.bias"


@pytest.mark.parametrize("run", [r[0] for r in RUNS])
def test_sharded_bert_trains_the_same_model(world, run):
    """Losses and gradient norms within 3e-5 on every rank; against the
    JAX step the final parameters, the ranks' blocks put together, within
    3e-5 under the layout-sensitive rule (the key biases within Adam's
    bound of their init); against the one-process port with dropout,
    step 1's gradients within 1e-5 of their norms."""
    want, ranks = world
    ref = want[run]
    for r in ranks:
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(r[run][k], ref[k], atol=TOL, rtol=TOL,
                                       err_msg=f"{run} {k}")
    if "dropout" in run:
        got = full_params(ranks, run, "grads")
        assert set(got) == set(ref["grads"])
        total = float(torch.stack([g.norm() for g in ref["grads"].values()])
                      .norm())
        for k, g in ref["grads"].items():
            err = float((got[k] - g).norm())
            if k.endswith(ZERO_GRAD):
                # rounding on both sides (module docstring)
                assert max(err, float(g.norm())) < 1e-6 * total, (k, err)
            else:
                assert err <= 1e-5 * float(g.norm()), (k, err)
        return
    got = full_params(ranks, run)
    layouts = [want[name]["params"] for name, _, d in RUNS if d == 0.0]
    init = bert_init()
    bound = STEPS * overrides(0.0)["base_lr"] * (1 + 1e-3)
    for k in [k for k in got if k.endswith(ZERO_GRAD)]:
        for side in (got[k], ref["params"][k]):
            assert float((side - init[k]).abs().max()) <= bound, k
    keep = [k for k in got if not k.endswith(ZERO_GRAD)]
    assert_params({k: got[k] for k in keep},
                  {k: ref["params"][k] for k in keep},
                  spread([{k: p[k] for k in keep} for p in layouts]), run)


@pytest.mark.parametrize("run", [r[0] for r in RUNS if r[2] == 0.0])
def test_eval_metrics_are_batch_group_means(world, run):
    want, ranks = world
    for r in ranks:
        assert set(r[run]["eval"]) == set(want[run]["eval"])
        for k, v in want[run]["eval"].items():
            assert abs(r[run]["eval"][k] - v) <= TOL, (run, k)


def test_replicated_leaves_are_bit_identical_and_masks_live(world):
    """Every rank holds the same replicated leaves after three steps with
    dropout; the masks are live (the losses leave the dropout-free
    run's)."""
    _, ranks = world
    for run, _, _ in RUNS:
        for name, (idx, t) in ranks[0][run]["params"].items():
            if idx is None:
                for r in ranks[1:]:
                    assert torch.equal(r[run]["params"][name][1], t), (
                        run, name)
    assert ranks[0]["model4-dropout"]["loss"][0] != \
        ranks[0]["data2-model2"]["loss"][0]
