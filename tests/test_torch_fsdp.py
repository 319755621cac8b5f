"""tpuframe_torch's fsdp (``parallel/fsdp.py``) against the JAX package's.

Placement: for every leaf of the tiny LM, the tiny MoE LM and tiny BERT
(vocab 1022, which fsdp=4 does not divide) at fsdp 2 and 4, alone and
with model=2, the port's spec, mapped onto the JAX leaf, is exactly the
spec ``tpuframe.parallel.fsdp.state_shardings`` gives it (with the
tensor-parallel rules where the JAX trainer passes them).  The traps
are named at full width: square kernels whose tie the JAX shape breaks
(the LM's ``query``, BERT's ``pooler``), a bias under model with no free
dim, one under 1024 elements, an indivisible vocab, and a head dim split
inside the port's flattened heads, which the port refuses.

Steps: one gloo world of four CPU processes trains, through
``train.build_harness`` from the flax init, three adamw steps with
``grad_clip_norm`` of the tiny LM on ``data=2 x fsdp=2`` (and with
``accum_steps=2``) and on ``fsdp=2 x model=2``, and of the tiny MoE LM
on ``fsdp=2 x expert=2``; each rank takes its batch rank's rows of the
same global batches.  The JAX harness's sharded-state step (its state
placed by ``fsdp.state_shardings`` on a mesh of the conftest's virtual
devices) runs the same recipe on each layout.  Held: losses (and
``moe_aux``) within 3e-5, absolute and relative, the tolerance of
``tests/test_fsdp.py``'s TP and fsdp golden losses; the gradient norm,
which is ``optax.global_norm`` of the mean gradient in the JAX step,
within the same; the final parameters, the ranks' blocks put
back together, within 3e-5 except where two JAX steps of one model on
different layouts differ by more (the layout-sensitive rule of
``test_torch_expert_tp.py``: such elements under 0.1% of their tensor,
printed, held within twice their spread); replicated leaves
bit-identical on every rank; each rank's parameters and Adam moments of
the shape of its block.
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
from jax.sharding import PartitionSpec as P  # noqa: E402

from tpuframe import models as jax_models  # noqa: E402
from tpuframe import train as jax_train  # noqa: E402
from tpuframe.parallel import fsdp as jax_fsdp  # noqa: E402
from tpuframe.parallel import mesh as jax_mesh  # noqa: E402
from tpuframe.parallel import step as jax_step  # noqa: E402
from tpuframe.parallel import tp as jax_tp  # noqa: E402
from tpuframe.utils import build_optimizer as jax_build_optimizer  # noqa: E402
from tpuframe.utils.config import TrainConfig as JaxTrainConfig  # noqa: E402
from tpuframe_torch import models as port_models  # noqa: E402
from tpuframe_torch.data import datasets  # noqa: E402
from tpuframe_torch.models import convert  # noqa: E402
from tpuframe_torch.parallel import fsdp, tp  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 3
TOL = 3e-5
LM_KW = {"tiny": True, "vocab_size": 64, "hidden_size": 32, "num_heads": 2,
         "intermediate_size": 64, "max_seq": 64, "attn_impl": "xla",
         "remat": True}
MOE_KW = dict(LM_KW, moe_experts=4, moe_k=2, moe_capacity_factor=1.0)
BERT_KW = {"vocab_size": 1022, "hidden_size": 128, "num_layers": 2,
           "num_heads": 4, "intermediate_size": 256, "max_position": 128,
           "dropout": 0.0}
# (run, model kwargs, mesh, accum_steps)
RUNS = [("data2-fsdp2", LM_KW, {"data": 2, "fsdp": 2}, 1),
        ("data2-fsdp2-accum2", LM_KW, {"data": 2, "fsdp": 2}, 2),
        ("fsdp2-model2", LM_KW, {"data": 1, "fsdp": 2, "model": 2}, 1),
        ("fsdp2-expert2", MOE_KW, {"data": 1, "fsdp": 2, "expert": 2}, 1)]
# JAX layouts of the MoE model run for the spread alone: three Adam steps
# amplify the summation order of an expert's gradient at the scale of
# Adam's epsilon (~6e-5 in one element of ``moe.up_experts`` between these
# layouts, ``test_torch_expert_tp.py``)
MOE_SPREAD = ({"expert": 2, "model": 2},)


def _norm(spec, ndim: int) -> tuple:
    """A spec as a tuple of one axis name or None a dim."""
    out = []
    for a in tuple(spec or ()) + (None,) * (ndim - len(tuple(spec or ()))):
        if isinstance(a, tuple):
            assert len(a) == 1, a
            a = a[0]
        out.append(a)
    return tuple(out)


def _jax_shapes(family: str, kw: dict):
    """The flax parameter tree of ``family`` as zeros: placement reads
    shapes alone, so the init is traced (``jax.eval_shape``), not run."""
    model = jax_models.get_model(family, dtype=jnp.float32, **kw)
    ids = jnp.zeros((1, 16 if family == "bert-base" else 32), jnp.int32)
    shapes = jax.eval_shape(model.init, jax.random.key(0), ids)["params"]
    return jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)


PLACEMENT = [(family, kw, mesh)
             for family, kw in (("transformer-lm", LM_KW),
                                ("transformer-lm", MOE_KW),
                                ("bert-base", BERT_KW))
             for mesh in ({"fsdp": 2}, {"fsdp": 4},
                          {"fsdp": 2, "model": 2}, {"fsdp": 4, "model": 2})]


@pytest.mark.parametrize(
    "family,kw,mesh", PLACEMENT,
    ids=[f"{'moe' if 'moe_experts' in kw else f.split('-')[0]}-"
         + "x".join(f"{a}{n}" for a, n in m.items())
         for f, kw, m in PLACEMENT])
def test_placement_is_the_jax_state_shardings(family, kw, mesh):
    """Leaf for leaf, the port's spec of each parameter (and so of its
    moments) is the JAX ``state_shardings`` spec of the leaf it maps."""
    params = _jax_shapes(family, kw)
    n = int(np.prod(list(mesh.values())))
    jmesh = jax_mesh.make_mesh(jax_mesh.MeshSpec(data=1, **mesh),
                               devices=jax.devices()[:n])
    rules = (jax_tp.rules_for_model(family) if mesh.get("model", 1) > 1
             else None)
    want = jax_fsdp.state_shardings(params, jmesh, tp_rules=rules)
    port = port_models.get_model(family, device="cpu", **kw)
    sizes = {a: 1 for a in jax_mesh.AXES} | mesh
    got = fsdp.state_shardings(
        port, sizes, tp.rules_for_model(family) if rules else None)
    order = convert.flat_order(params, family)
    assert set(got) == set(order)
    split = 0
    for name, spec in got.items():
        path = order[name][0]
        leaf = want
        for k in path:
            leaf = leaf[k]
        shape = _at(params, path).shape
        view = convert.jax_view(name, tuple(port.get_parameter(name).shape),
                                port.cfg.num_heads)
        assert view.shape == shape, name
        jspec = _norm(leaf.spec, len(shape))
        assert _norm(convert.spec_to_jax(view, spec), len(shape)) == jspec, (
            name, spec, jspec)
        assert _norm(spec, view.port_ndim) == _norm(
            convert.spec_to_port(view, jspec, name), view.port_ndim)
        split += "fsdp" in jspec
    assert split > 0


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@pytest.mark.parametrize("name,port_shape,heads,base,size,want", [
    # the LM's query [768, 768] is the JAX [768, 12, 64]: H, port dim 1
    ("blocks.0.attn.query.weight", (768, 768), 12, None, 2, (None, "fsdp")),
    # with model on the heads, fsdp still takes H
    ("blocks.0.attn.query.weight", (768, 768), 12, ("model", None), 2,
     ("model", "fsdp")),
    # BERT's pooler [768, 768] is the JAX [in, out]: the in dim, port dim 1
    ("pooler.weight", (768, 768), 12, None, 2, (None, "fsdp")),
    # intermediate.bias [3072] under model has no free dim
    ("encoder.layers.0.intermediate.bias", (3072,), 12, ("model",), 2,
     ("model",)),
    # query.bias [768] is the JAX [12, 64]: under 1024 elements
    ("encoder.layers.0.attention.query.bias", (768,), 12, ("model",), 2,
     ("model",)),
    ("encoder.layers.0.attention.query.bias", (768,), 12, None, 2, ()),
    # embeddings.word [30522, 768]: dim 0 at fsdp=2; at fsdp=4 the vocab
    # is indivisible and model holds hidden, so it stays whole over fsdp
    ("embeddings.word.weight", (30522, 768), 12, (None, "model"), 2,
     ("fsdp", "model")),
    ("embeddings.word.weight", (30522, 768), 12, (None, "model"), 4,
     (None, "model")),
], ids=["lm-query", "lm-query-model", "bert-pooler",
        "intermediate-bias-model", "query-bias-model", "query-bias",
        "word-fsdp2", "word-fsdp4-indivisible"])
def test_ties_and_transposes_at_full_width(name, port_shape, heads, base,
                                           size, want):
    """The fsdp dim is chosen on the JAX shape, as the JAX ``_add_fsdp``
    chooses it, then mapped: read naively on the port's own square
    tensor, "the largest dim, first on a tie" would take dim 0."""
    view = convert.jax_view(name, port_shape, heads)
    jbase = None if base is None else convert.spec_to_jax(view, base)
    jspec = jax_fsdp._add_fsdp(view.shape, None if jbase is None
                               else P(*jbase), size, "fsdp")
    ours = fsdp._add_fsdp(view.shape, jbase, size, "fsdp")
    assert _norm(ours, len(view.shape)) == _norm(jspec, len(view.shape))
    got = convert.spec_to_port(view, ours, name) if ours else ()
    assert got == want


@pytest.mark.parametrize("shape,n", [((4096, 512), 4), ((512, 4096), 4),
                                     ((3, 5), 4), ((4098, 2), 4),
                                     ((4096,), 1), ((64, 64), 2)])
def test_choose_spec_is_the_jax_rule(shape, n):
    """``tests/test_fsdp.py``'s cases of the JAX ``choose_spec`` (and a
    tie, which goes to dim 0)."""
    want = jax_fsdp.choose_spec(shape, n)
    assert fsdp.choose_spec(shape, n) == (_norm(want, len(shape)) if want
                                          else ())


def test_a_head_dim_split_inside_flattened_heads_is_refused():
    """BERT-large's query bias [1024] is the JAX [16, 64], over 1024
    elements: under model=2 fsdp lands on the head dim, a strided block
    of the port's flattened tensor, which the port refuses."""
    name = "encoder.layers.0.attention.query.bias"
    view = convert.jax_view(name, (1024,), 16)
    jspec = jax_fsdp._add_fsdp(view.shape, P("model", None), 2, "fsdp")
    assert jspec == P("model", "fsdp")
    with pytest.raises(ValueError, match="strided block"):
        convert.spec_to_port(view, tuple(jspec), name)
    assert convert.spec_to_port(view, ("fsdp", None), name) == ("fsdp",)


_INITS = {}


def jax_init(family: str, kw: dict, seq: int) -> dict:
    """The flax init of ``family`` (seed 0) as numpy, made once a model:
    jitted, one program rather than a compile an operation."""
    key = (family, json.dumps(kw, sort_keys=True), seq)
    if key not in _INITS:
        model = jax_models.get_model(family, dtype=jnp.float32, **kw)
        _INITS[key] = jax.tree.map(np.asarray, jax.jit(model.init)(
            jax.random.key(0), jnp.zeros((1, seq), jnp.int32))["params"])
    return _INITS[key]


def common(kw: dict, accum: int = 1) -> dict:
    return dict(name="fsdp", model="transformer-lm", model_kwargs=kw,
                dataset="lm_text",
                dataset_kwargs={"seq_len": 32, "vocab_size": 64,
                                "synthetic_size": 64},
                optimizer="adamw", base_lr=3e-3, scale_lr_by_batch=False,
                warmup_steps=0, schedule="cosine", weight_decay=0.1,
                grad_clip_norm=1.0, global_batch=8, total_steps=10,
                compute_dtype="float32", fused_xent=True,
                accum_steps=accum)


def batches():
    train, _ = datasets.lm_text(None, seq_len=32, vocab_size=64,
                                synthetic_size=64)
    return [train[np.arange(8 * i, 8 * i + 8)] for i in range(STEPS)]


def jax_run(kw: dict, mesh_kw: dict, accum: int = 1) -> dict:
    """The JAX harness's sharded-state step on ``mesh_kw``."""
    jcfg = JaxTrainConfig(**common(kw, accum)).with_overrides(mesh=mesh_kw)
    model = jax_models.get_model("transformer-lm", dtype=jnp.float32, **kw)
    params = jax_init("transformer-lm", kw, 32)
    tx = jax_build_optimizer(jcfg, params)
    state = jax_step.TrainState.create(params, tx)
    n = int(np.prod(list(mesh_kw.values())))
    mesh = jax_mesh.make_mesh(jax_mesh.MeshSpec(**mesh_kw),
                              devices=jax.devices()[:n])
    rules = (jax_tp.rules_for_model("transformer-lm")
             if mesh_kw.get("model", 1) > 1
             or mesh_kw.get("expert", 1) > 1 else None)
    shardings = jax_fsdp.state_shardings(state, mesh, tp_rules=rules)
    state = jax.tree.map(jax.device_put, state, shardings)
    on = NamedSharding(jax_fsdp.auto_mesh(mesh), jax_mesh.batch_spec())
    step = jax_step.make_train_step(jax_train.make_loss_fn(jcfg, model), tx,
                                    mesh, donate=False,
                                    state_shardings=shardings,
                                    accum_steps=accum)
    out = {"loss": [], "grad_norm": [], "moe_aux": []}
    for b in batches():
        state, m = step(state, {k: jax.device_put(jnp.asarray(v), on)
                                for k, v in b.items()})
        for k in out:
            if k in m:
                out[k].append(float(m[k]))
    out["params"] = convert.params_from_jax(
        jax.tree.map(np.asarray, state.params))
    return out


# One rank of the world of four: each run of RUNS through the trainer's
# harness from the JAX init, three steps on this rank's batch rows.  Each
# rank saves its results; os._exit(0) once they are written (a gloo
# world's interpreter teardown can abort).
_WORKER = r"""
import json, os, sys
import numpy as np
import torch
import torch.distributed as dist
from tpuframe_torch import train as port_train
from tpuframe_torch.parallel import fsdp, tp
from tpuframe_torch.utils.config import TrainConfig

rank, port, root = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        world_size=4, rank=rank)
spec = json.load(open(f"{root}/runs.json"))
data = np.load(f"{root}/batches.npz")
result = {}
for name, family, mesh, kw in spec:
    init = torch.load(f"{root}/init_{family}.pt")
    h = port_train.build_harness(
        TrainConfig(**kw).with_overrides(mesh=mesh), device="cpu")
    model, lay = h.state.model, h.layout
    specs = model.shard_specs
    model.load_state_dict({k: tp.cut(v, specs.get(k), lay.sizes,
                                     lay.coords()) for k, v in init.items()})
    got = {"loss": [], "grad_norm": [], "moe_aux": []}
    for i in range(len(data.files) // 2):
        b = {k: data[f"{k}{i}"] for k in ("input_ids", "labels")}
        n = b["input_ids"].shape[0] // lay.batch_size
        j = lay.batch_index
        m = h.train_step(h.state, {k: torch.from_numpy(
            np.ascontiguousarray(v[j * n:(j + 1) * n])) for k, v in b.items()})
        for k in got:
            if k in m:
                got[k].append(float(m[k]))
    got["params"] = {
        k: (None if k not in specs else
            tp.shard_leaf(t, specs[k], lay).index, t.detach().clone())
        for k, t in model.state_dict().items()}
    got["opt"] = h.state.opt.state_dict()
    got["specs"] = {k: list(v) for k, v in specs.items()}
    got["fsdp_dims"] = {k: p.fsdp[1] for k, p in model.named_parameters()
                        if hasattr(p, "fsdp")}
    got["fraction"] = fsdp.param_fraction_sharded(model)
    result[name] = got
torch.save(result, f"{root}/rank{rank}.pt")
os._exit(0)
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start_world(root, worker: str, n: int = 4, timeout: int = 400):
    """Start ``worker`` as ``n`` gloo ranks; a function that waits for
    them and returns their saved results."""
    port = str(_free_port())
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("TPUFRAME_")}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", worker, str(r), port, str(root)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(n)]

    def results() -> list:
        for p in procs:
            _, err = p.communicate(timeout=timeout)
            assert p.returncode == 0, err
        return [torch.load(root / f"rank{r}.pt") for r in range(n)]
    return results


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The port's world of four, which runs while this process runs the
    JAX sharded-state step of each layout."""
    root = tmp_path_factory.mktemp("fsdp")
    for name, kw in (("lm", LM_KW), ("moe", MOE_KW)):
        torch.save(convert.params_from_jax(jax_init("transformer-lm", kw, 32)),
                   root / f"init_{name}.pt")
    (root / "runs.json").write_text(json.dumps([
        (name, "moe" if kw is MOE_KW else "lm", mesh, common(kw, accum))
        for name, kw, mesh, accum in RUNS]))
    np.savez(root / "batches.npz", **{f"{k}{i}": v for i, b in
                                      enumerate(batches())
                                      for k, v in b.items()})
    results = start_world(root, _WORKER)
    try:
        want = {"moe_spread": [jax_run(MOE_KW, m)["params"]
                               for m in MOE_SPREAD]}
        for name, kw, mesh, accum in RUNS:
            want[name] = jax_run(kw, {k: v for k, v in mesh.items() if v > 1},
                                 accum)
    finally:
        ranks = results()
    return want, ranks


def full_params(ranks: list, run: str, key: str = "params") -> dict:
    """The ranks' blocks of each parameter (or of what ``key`` names)
    put back together."""
    out = {}
    for name, (idx, t) in ranks[0][run][key].items():
        if idx is None:
            out[name] = t
            continue
        parts = {}
        for r in ranks:
            i, b = r[run][key][name]
            parts[tuple(map(tuple, i))] = b
        shape = tuple(max(hi for _, hi in dims)
                      for dims in zip(*parts.keys()))
        out[name] = tp.paste(shape, parts.items())
    return out


def assert_params(got: dict, want: dict, spread: dict, what: str) -> None:
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
            print(f"{what} {k}: loosened at {loose.nonzero().tolist()} to "
                  f"2x {spread[k][loose].tolist()}")
        atol = torch.where(loose, 2 * spread[k], torch.full_like(w, TOL))
        bad = (got[k] - w).abs() > atol
        assert not bad.any(), (
            f"{what} {k}: {int(bad.sum())} elements off, first at "
            f"{bad.nonzero()[0].tolist()}: |{got[k][bad][0].item()} - "
            f"{w[bad][0].item()}| > {atol[bad][0].item()}")


def spread(steps: list) -> dict:
    """Per tensor, each element's largest distance between JAX steps of
    one model on different layouts."""
    return {k: (torch.stack([s[k] for s in steps]).amax(dim=0)
                - torch.stack([s[k] for s in steps]).amin(dim=0))
            for k in steps[0]}


@pytest.mark.parametrize("run", [r[0] for r in RUNS])
def test_layout_matches_the_jax_sharded_state_step(world, run):
    want, ranks = world
    jx = want[run]
    base = "moe" if "expert" in run else "lm"
    others = [
        want[name]["params"] for name, kw, _, accum in RUNS
        if (kw is MOE_KW) == (base == "moe") and accum == 1]
    if base == "moe":
        others += want["moe_spread"]
    for r in ranks:
        for k in ("loss", "grad_norm", "moe_aux"):
            np.testing.assert_allclose(r[run][k], jx[k], atol=TOL, rtol=TOL,
                                       err_msg=f"{run} {k}")
    assert_params(full_params(ranks, run), jx["params"], spread(others), run)


@pytest.mark.parametrize("run", [r[0] for r in RUNS])
def test_ranks_hold_their_blocks_and_agree_on_the_rest(world, run):
    """Replicated leaves bit-identical on every rank; each split leaf's
    block, and its two Adam moments, of the block's shape; most of the
    state split over fsdp; the fsdp-marked dim is the spec's."""
    _, ranks = world
    r0 = ranks[0][run]
    sizes = dict(dict(RUNS[[r[0] for r in RUNS].index(run)][2]))
    for name, (idx, t) in r0["params"].items():
        if idx is None:
            for r in ranks[1:]:
                assert torch.equal(r[run]["params"][name][1], t), name
            continue
        spec = r0["specs"][name]
        assert list(t.shape) == [hi - lo for lo, hi in idx]
        whole = [d * sizes.get(a, 1) if a else d
                 for d, a in zip(t.shape, spec)]
        assert t.numel() < int(np.prod(whole)), name
        for moment in ("mu", "nu"):
            assert r0["opt"][moment][name].shape == t.shape, (moment, name)
        if "fsdp" in spec:
            assert r0["fsdp_dims"][name] == spec.index("fsdp")
    assert r0["fraction"] > 0.9
