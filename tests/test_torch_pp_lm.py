"""tpuframe_torch's ``ScanBlockLM`` and its pipeline-parallel step
(``models/transformer_lm.py``, ``parallel/pp_lm.py``, the trainer's pipe
branch) against the JAX package's.

Model: the flax ``ScanBlockLM``'s init carried across
(``convert.scan_params_from_jax``) gives the JAX logits; the staged
forward (embed, each stage's slice of the layers, head) is the full one;
a seed draws ``TransformerLM``'s weights, stacked; the converter round
trips; the stacked leaves' views carry ``state_partition``'s spec onto
the JAX one's.

Steps: one gloo world of four CPU processes trains, through
``train.build_harness`` from the flax init, three adamw steps on
data=2 x pipe=2 and on pipe=4, dense and fused, with and without the
cross-stage clip (max norm 0.05, so that it engages), each rank feeding
its data rows of the same global batches, while this process runs the
JAX ``make_pp_lm_step`` on the same meshes of the conftest's virtual
devices (with ``pp_clip_by_global_norm`` chained before the harness's
optimizer, as the JAX trainer builds it).  Held: losses within 2e-5
(the JAX test's tolerance), accuracy within 1e-6; the final parameters,
the stages' blocks put together, within 3e-5 an element; fused against
dense at 2e-5; replicated leaves bit-identical on every rank; each
rank's parameters and moments its stage's layers.

Harness: ``lm_pp_smoke`` through ``train.train`` on its own data=2 x
pipe=4 mesh (eight gloo processes) trains, evaluates and checkpoints,
and a run stopped at step 10 and resumed ends on the straight run's loss
at 1e-4.  The refusals of the JAX harness under pp come with its
reasons.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from tpuframe import models as jax_models  # noqa: E402
from tpuframe.parallel import mesh as jax_mesh  # noqa: E402
from tpuframe.parallel import pp_lm as jax_pp_lm  # noqa: E402
from tpuframe.parallel import step as jax_step  # noqa: E402
from tpuframe.utils import build_optimizer as jax_build_optimizer  # noqa: E402
from tpuframe.utils.config import TrainConfig as JaxTrainConfig  # noqa: E402
from tpuframe_torch import models as port_models  # noqa: E402
from tpuframe_torch import train as port_train  # noqa: E402
from tpuframe_torch.data import datasets  # noqa: E402
from tpuframe_torch.models import convert  # noqa: E402
from tpuframe_torch.models.transformer_lm import (LMConfig,  # noqa: E402
                                                  ScanBlockLM, TransformerLM)
from tpuframe_torch.obs import flops as obs_flops  # noqa: E402
from tpuframe_torch.parallel import pp_lm, tp  # noqa: E402
from tpuframe_torch.utils.config import TrainConfig  # noqa: E402

from test_torch_fsdp import full_params, jax_init, start_world  # noqa: E402

STEPS = 3
LOSS_TOL = 2e-5
PARAM_TOL = 3e-5
CLIP = 0.05
KW = {"tiny": True, "vocab_size": 64, "hidden_size": 32, "num_layers": 4,
      "num_heads": 2, "intermediate_size": 64, "max_seq": 64,
      "attn_impl": "xla", "remat": True}
# (run, mesh, fused_xent, grad_clip_norm)
RUNS = [("data2-pipe2", {"data": 2, "pipe": 2}, False, None),
        ("data2-pipe2-fused", {"data": 2, "pipe": 2}, True, None),
        ("pipe4-clip", {"data": 1, "pipe": 4}, False, CLIP),
        ("pipe4-clip-fused", {"data": 1, "pipe": 4}, True, CLIP)]
RUNS_BY_NAME = {name: mesh for name, mesh, _, _ in RUNS}


def _cfg(**kw) -> LMConfig:
    kw = dict(KW, **kw)
    kw.pop("tiny")
    return LMConfig.tiny(**kw)


def _jax_params():
    return jax_init("transformer-lm-pp", KW, 32)


def common(fused: bool, clip) -> dict:
    return dict(name="pp", model="transformer-lm-pp", model_kwargs=KW,
                dataset="lm_text",
                dataset_kwargs={"seq_len": 32, "vocab_size": 64,
                                "synthetic_size": 64},
                optimizer="adamw", base_lr=3e-3, scale_lr_by_batch=False,
                warmup_steps=0, schedule="cosine", weight_decay=0.1,
                grad_clip_norm=clip, global_batch=8, total_steps=10,
                compute_dtype="float32", fused_xent=fused,
                pp_microbatches=2)


def batches():
    train, _ = datasets.lm_text(None, seq_len=32, vocab_size=64,
                                synthetic_size=64)
    return [train[np.arange(8 * i, 8 * i + 8)] for i in range(STEPS)]


# --- the model ----------------------------------------------------------


def test_forward_is_the_jax_scanblocklm():
    """The flax ScanBlockLM's init carried across: the same logits."""
    params = _jax_params()
    model = jax_models.get_model("transformer-lm-pp", dtype=jnp.float32,
                                 **KW)
    ids = np.random.default_rng(0).integers(0, 64, (2, 32)).astype(np.int32)
    want = np.asarray(model.apply({"params": params}, jnp.asarray(ids)))
    port = ScanBlockLM(_cfg(), device="cpu")
    port.load_state_dict(convert.scan_params_from_jax(params))
    got = port(torch.from_numpy(ids).long())
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-4,
                               rtol=0)


class _Stage:
    """The layout fields ``tp.cut_`` reads, of stage ``s`` of ``n``."""

    def __init__(self, n: int, s: int):
        self.sizes, self.s = {"pipe": n}, s

    def coords(self) -> dict:
        return {"pipe": self.s}


def test_staged_forward_is_the_full_one():
    """Embed, each stage's two layers, the head: the full forward's
    logits and normed states, bit for bit."""
    model = ScanBlockLM(_cfg(), device="cpu", seed=1)
    ids = torch.randint(0, 64, (2, 32))
    x = model(ids, embed_only=True)
    for s in range(2):
        stage = ScanBlockLM(_cfg(), device="cpu", seed=1)
        tp.cut_(stage, pp_lm.state_partition(stage), _Stage(2, s))
        assert stage.num_stacked == 2
        x = stage(x, stage=True)
    assert torch.equal(model(x, head_only=True), model(ids))
    assert torch.equal(model(x, head_only=True, hidden_only=True),
                       model(ids, hidden_only=True))


def test_a_seed_draws_the_transformer_lms_weights():
    """The same seed: TransformerLM's weights, each layer's stacked, and
    the same logits."""
    a = TransformerLM(_cfg(), device="cpu", seed=3)
    b = ScanBlockLM(_cfg(), device="cpu", seed=3)
    sa = a.state_dict()
    for k, v in b.state_dict().items():
        if k.startswith("blocks."):
            rest = k[len("blocks."):]
            v0 = torch.stack([sa[f"blocks.{i}.{rest}"] for i in range(4)])
            assert torch.equal(v, v0), k
        else:
            assert torch.equal(v, sa[k]), k
    ids = torch.randint(0, 64, (2, 32))
    assert torch.equal(a(ids), b(ids))


def test_converter_round_trips_stacked_leaves():
    params = _jax_params()
    sd = convert.scan_params_from_jax(params)
    assert sd["blocks.attn.query.weight"].shape == (4, 32, 32)
    assert sd["blocks.up.weight"].shape == (4, 64, 32)
    back = convert.scan_params_to_jax(sd, 2)
    flat_a = jax.tree_util.tree_leaves_with_path(params)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        assert np.array_equal(np.asarray(leaf), flat_b[path]), path


def test_stacked_views_carry_the_pipe_spec_onto_the_jax_leaves():
    """Leaf for leaf, ``state_partition``'s spec, mapped through the
    stacked ``jax_view``, is the JAX ``state_partition`` spec of the leaf
    it maps (every block leaf ``P('pipe')`` on the layer dim)."""
    params = _jax_params()
    order = convert.flat_order(params, "transformer-lm-pp")
    model = ScanBlockLM(_cfg(), device="cpu")
    specs = pp_lm.state_partition(model)
    want = jax_pp_lm.state_partition(params)
    for name, p in model.named_parameters():
        path = order[name][0]
        leaf, jspec = params, want
        for k in path:
            leaf, jspec = leaf[k], jspec[k]
        view = convert.jax_view(name, tuple(p.shape), 2)
        assert view.shape == np.asarray(leaf).shape, name
        got = convert.spec_to_jax(view, specs.get(name))
        assert tuple(got) + (None,) * (len(view.shape) - len(got)) == \
            tuple(jspec) + (None,) * (len(view.shape) - len(tuple(jspec))), \
            name


def test_model_flops_and_parameters_are_the_transformer_lms():
    cfg = TrainConfig(**common(False, None))
    a = TransformerLM(_cfg(), device="cpu")
    b = ScanBlockLM(_cfg(), device="cpu")
    batch = {"input_ids": torch.zeros((4, 32), dtype=torch.long)}
    assert obs_flops.step_flops(cfg, b, batch) == obs_flops.step_flops(
        cfg, a, batch)
    assert obs_flops.param_count(b) == obs_flops.param_count(a)
    layout = _Stage(4, 1)
    tp.cut_(b, pp_lm.state_partition(b), layout)
    b.shard_specs, b.layout = pp_lm.state_partition(b), layout
    assert obs_flops.param_count(b) == obs_flops.param_count(a)


def test_transformer_lm_pp_trains_without_pipe_as_the_transformer_lm():
    """On a mesh without pipe the full forward trains: the losses of
    ``transformer-lm`` at the same seed, step for step."""
    losses = {}
    for model in ("transformer-lm", "transformer-lm-pp"):
        cfg = TrainConfig(**common(True, 1.0)).with_overrides(
            model=model, mesh={"data": 1}, total_steps=3, eval_every=3,
            eval_batches=1)
        out = port_train.train(cfg, device="cpu")
        losses[model] = out["losses"] + [out["eval_loss"]]
    np.testing.assert_allclose(losses["transformer-lm-pp"],
                               losses["transformer-lm"], rtol=1e-6)


# --- refusals -----------------------------------------------------------


@pytest.mark.parametrize("overrides,env,world,match", [
    ({"model": "transformer-lm"}, {}, 8, "needs model='transformer-lm-pp'"),
    ({"mesh": {"data": 1, "pipe": 2, "fsdp": 2}}, {}, 4,
     "sharded-state axes"),
    ({"accum_steps": 2}, {}, 8, "accum_steps must be 1"),
    ({"grad_reduce": "adasum"}, {}, 8, "grad_reduce='mean'"),
    ({"shard_seq": True}, {}, 8, "shard_seq"),
    ({"distributed": False}, {}, 8, "stages are ranks"),
    ({}, {"TPUFRAME_WEIGHT_UPDATE": "zero1"}, 8, "stage-sharded update"),
    ({}, {"TPUFRAME_WIRE_FORMAT": "int8-block"}, 8, "cross-stage"),
    ({}, {"TPUFRAME_HIER": "hier"}, 8, "cross-stage"),
], ids=["model", "sharded", "accum", "adasum", "shard-seq", "undistributed",
        "zero1", "int8-wire", "hier"])
def test_the_jax_harness_refusals_under_pp(overrides, env, world, match,
                                           monkeypatch):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    cfg = port_train.get_config("lm_pp_smoke").with_overrides(**overrides)
    with pytest.raises(ValueError, match=match):
        port_train._refuse_unported(cfg, world)


def test_pipe_meshes_and_the_pp_model_are_not_refused(monkeypatch):
    monkeypatch.setenv("TPUFRAME_FUSION_THRESHOLD", "4194304")
    cfg = port_train.get_config("lm_pp_smoke")
    sizes = port_train._refuse_unported(cfg, 8)
    assert (sizes["data"], sizes["pipe"]) == (2, 4)
    port_train._refuse_unported(cfg.with_overrides(mesh={"data": 2}), 2)


@pytest.mark.parametrize("kw,match", [
    ({"num_layers": 5}, "num_layers=5 not divisible by pipe=4"),
    ({"dropout": 0.1}, "does not support dropout>0"),
], ids=["indivisible-layers", "dropout"])
def test_the_step_refuses_what_the_jax_step_refuses(kw, match):
    layout = type("L", (), {"pipe_size": 4})()
    with pytest.raises(ValueError, match=match):
        pp_lm.make_pp_lm_step(_cfg(**kw), layout, n_micro=2)


# --- steps against the JAX make_pp_lm_step ------------------------------


def jax_run(mesh_kw: dict, fused: bool, clip) -> dict:
    """The JAX pipeline step on ``mesh_kw``, the JAX trainer's chain."""
    jcfg = JaxTrainConfig(**common(fused, clip)).with_overrides(mesh=mesh_kw)
    model = jax_models.get_model("transformer-lm-pp", dtype=jnp.float32,
                                 **KW)
    params = _jax_params()
    tx = jax_build_optimizer(jcfg.with_overrides(grad_clip_norm=None),
                             params)
    if clip is not None:
        tx = optax.chain(jax_pp_lm.pp_clip_by_global_norm(clip), tx)
    n = int(np.prod(list(mesh_kw.values())))
    mesh = jax_mesh.make_mesh(jax_mesh.MeshSpec(**mesh_kw),
                              devices=jax.devices()[:n])
    factory, place_state, place_batch = jax_pp_lm.make_pp_lm_step(
        model, tx, mesh, n_micro=2, fused_xent=fused)
    state = place_state(jax_step.TrainState.create(params, tx))
    step = factory(state)
    out = {"loss": [], "accuracy": []}
    for b in batches():
        state, m = step(state, place_batch(
            {k: jnp.asarray(v) for k, v in b.items()}))
        for k in out:
            out[k].append(float(m[k]))
    out["params"] = convert.scan_params_from_jax(
        jax.tree.map(np.asarray, state.params))
    return out


# One rank of the world of four: each run of RUNS through the trainer's
# harness from the JAX init (cut to the rank's stage), three steps on its
# data rows.  os._exit(0) once the results are written.
_WORKER = r"""
import json, os, sys
import numpy as np
import torch
import torch.distributed as dist
from tpuframe_torch import train as port_train
from tpuframe_torch.parallel import tp
from tpuframe_torch.utils.config import TrainConfig

rank, port, root = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        world_size=4, rank=rank)
init = torch.load(f"{root}/init.pt")
data = np.load(f"{root}/batches.npz")
result = {}
for name, mesh, kw in json.load(open(f"{root}/runs.json")):
    h = port_train.build_harness(
        TrainConfig(**kw).with_overrides(mesh=mesh), device="cpu")
    model, lay = h.state.model, h.layout
    specs = model.shard_specs
    model.load_state_dict({k: tp.cut(v, specs.get(k), lay.sizes,
                                     lay.coords()) for k, v in init.items()})
    got = {"loss": [], "accuracy": [], "grad_norm": []}
    for i in range(len(data.files) // 2):
        b = {k: data[f"{k}{i}"] for k in ("input_ids", "labels")}
        n = b["input_ids"].shape[0] // lay.batch_size
        j = lay.batch_index
        m = h.train_step(h.state, {k: torch.from_numpy(
            np.ascontiguousarray(v[j * n:(j + 1) * n])) for k, v in b.items()})
        for k in got:
            got[k].append(float(m[k]))
    got["params"] = {
        k: (None if k not in specs else
            tp.shard_leaf(t, specs[k], lay).index, t.detach().clone())
        for k, t in model.state_dict().items()}
    got["opt"] = h.state.opt.state_dict()
    got["coords"] = lay.coords()
    result[name] = got
torch.save(result, f"{root}/rank{rank}.pt")
os._exit(0)
"""

# The harness on lm_pp_smoke's own mesh (eight ranks): a straight run of
# 20 steps checkpointing every 10 with the cross-stage clip, a run stopped
# at step 10, and its resumption to 20.
_HARNESS = r"""
import os, sys
import torch
import torch.distributed as dist
from tpuframe_torch import train as port_train

rank, port, root = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        world_size=8, rank=rank)
base = port_train.get_config("lm_pp_smoke").with_overrides(
    total_steps=20, ckpt_every=10, log_every=10, eval_every=10,
    eval_batches=1, ckpt_dir=f"{root}/ck", grad_clip_norm=1.0)
straight = port_train.train(base, device="cpu")
part1 = port_train.train(base.with_overrides(
    total_steps=10, ckpt_dir=f"{root}/ck2"), device="cpu")
part2 = port_train.train(base.with_overrides(ckpt_dir=f"{root}/ck2"),
                         device="cpu")
torch.save({"straight": straight, "part1": part1, "part2": part2,
            "ckpts": sorted(os.listdir(f"{root}/ck"))},
           f"{root}/rank{rank}.pt")
os._exit(0)
"""


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """The port's worlds of four (the steps) and eight (the harness),
    which run while this process runs the JAX steps."""
    root = tmp_path_factory.mktemp("pp_lm")
    torch.save(convert.scan_params_from_jax(_jax_params()), root / "init.pt")
    (root / "runs.json").write_text(json.dumps([
        (name, mesh, common(fused, clip))
        for name, mesh, fused, clip in RUNS]))
    np.savez(root / "batches.npz", **{f"{k}{i}": v for i, b in
                                      enumerate(batches())
                                      for k, v in b.items()})
    harness_root = tmp_path_factory.mktemp("pp_harness")
    steps = start_world(root, _WORKER, n=4, timeout=400)
    harness = start_world(harness_root, _HARNESS, n=8, timeout=400)
    try:
        want = {name: jax_run(mesh, fused, clip)
                for name, mesh, fused, clip in RUNS}
    finally:
        ranks = steps()
        runs = harness()
    return want, ranks, runs


@pytest.mark.parametrize("run", [r[0] for r in RUNS])
def test_step_matches_the_jax_pp_step(worlds, run):
    want, ranks, _ = worlds
    jx = want[run]
    for r in ranks:
        np.testing.assert_allclose(r[run]["loss"], jx["loss"],
                                   atol=LOSS_TOL, rtol=LOSS_TOL,
                                   err_msg=f"{run} loss")
        np.testing.assert_allclose(r[run]["accuracy"], jx["accuracy"],
                                   atol=1e-6, err_msg=f"{run} accuracy")
    got = full_params(ranks, run)
    assert set(got) == set(jx["params"])
    for k, w in jx["params"].items():
        np.testing.assert_allclose(got[k].numpy(), w.numpy(),
                                   atol=PARAM_TOL, rtol=0,
                                   err_msg=f"{run} {k}")


@pytest.mark.parametrize("mesh", ["data2-pipe2", "pipe4-clip"])
def test_fused_matches_dense(worlds, mesh):
    _, ranks, _ = worlds
    dense, fused = ranks[0][mesh], ranks[0][mesh + "-fused"]
    np.testing.assert_allclose(fused["loss"], dense["loss"], atol=LOSS_TOL,
                               rtol=LOSS_TOL)
    np.testing.assert_allclose(fused["accuracy"], dense["accuracy"],
                               atol=1e-6)


@pytest.mark.parametrize("run", [r[0] for r in RUNS])
def test_ranks_hold_their_stage_and_agree_on_the_rest(worlds, run):
    """Each rank's block parameters and Adam moments are its stage's
    layers; the replicated leaves and the metrics are bit-identical on
    every rank."""
    _, ranks, _ = worlds
    stages = RUNS_BY_NAME[run]["pipe"]
    r0 = ranks[0][run]
    for r in ranks:
        for name, (idx, t) in r[run]["params"].items():
            if idx is None:
                assert torch.equal(t, r0["params"][name][1]), name
                continue
            s = r[run]["coords"]["pipe"]
            assert idx[0] == (s * 4 // stages, (s + 1) * 4 // stages), name
            assert t.shape[0] == 4 // stages
            for moment in ("mu", "nu"):
                assert r[run]["opt"][moment][name].shape == t.shape
        for k in ("loss", "accuracy", "grad_norm"):
            assert r[run][k] == r0[k], k


def test_clip_engages_and_matches_across_layouts(worlds):
    """The clipped runs' gradient norms exceed the clip, so the cross-stage
    clip scaled every update; the unclipped layout's norms are the
    same global norm (a per-stage norm would differ by stage)."""
    _, ranks, _ = worlds
    norms = ranks[0]["pipe4-clip"]["grad_norm"]
    assert min(norms) > CLIP
    np.testing.assert_allclose(ranks[0]["data2-pipe2"]["grad_norm"][0],
                               norms[0], rtol=1e-5)


def test_lm_pp_smoke_trains_checkpoints_and_resumes(worlds):
    _, _, runs = worlds
    r0 = runs[0]
    straight, part2 = r0["straight"], r0["part2"]
    assert straight["step"] == 20 and part2["step"] == 20
    assert r0["part1"]["step"] == 10
    assert straight["loss"] < straight["losses"][0]
    assert straight["loss"] < 3.0
    assert np.isfinite(straight["eval_loss"])
    assert r0["ckpts"][:2] == ["step_00000010", "step_00000020"]
    np.testing.assert_allclose(part2["loss"], straight["loss"], rtol=1e-4)
    for r in runs[1:]:
        assert r["straight"]["loss"] == straight["loss"]


def test_a_jax_train_state_carries_over_to_a_stage():
    """A JAX ScanBlockLM TrainState (parameters and Adam moments, stacked)
    → a stage's layers of the port's parameters and moments, the rest
    whole (``train_state_from_jax(..., blocks=...)`` with
    ``state_partition``'s specs)."""
    params = _jax_params()
    tx = optax.adamw(1e-3)
    adam = tx.init(params)[0]
    bump = lambda t: jax.tree.map(lambda a: np.asarray(a) + 1.5, t)  # noqa: E731
    tree = {"step": np.int32(7), "params": params,
            "opt_state": {"0": {"count": np.int32(7), "mu": bump(adam.mu),
                                "nu": bump(bump(adam.nu))}}}
    model = ScanBlockLM(_cfg(), device="cpu")
    specs = pp_lm.state_partition(model)
    whole = convert.scan_params_from_jax(params)
    sd, opt, step = convert.train_state_from_jax(
        tree, "transformer-lm-pp", blocks=(specs, {"pipe": 2}, {"pipe": 1}))
    assert step == 7 and opt["count"] == 7
    mu = convert.scan_params_from_jax(bump(adam.mu))
    nu = convert.scan_params_from_jax(bump(bump(adam.nu)))
    for k, v in whole.items():
        def stage(t, k=k):
            return t[2:4] if k in specs else t

        assert torch.equal(sd[k], stage(v)), k
        assert torch.equal(opt["mu"][k], stage(mu[k])), k
        assert torch.equal(opt["nu"][k], stage(nu[k])), k
    tp.cut_(model, specs, _Stage(2, 1))
    model.load_state_dict(sd)
    assert model.num_stacked == 2
