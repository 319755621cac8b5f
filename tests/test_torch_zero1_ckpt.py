"""ZeRO-1 checkpoints of the port (``tpuframe_torch.ckpt`` with
``FlatShard`` leaves) and a JAX ZeRO-1 state carried into the port
(``models.convert.train_state_from_jax(..., zero1=(n, i))``).

The runs are the tiny LM (adamw, no clip, f32) of ``lm_smoke``'s data,
global batch 4 a step, through the port's zero1 step in gloo worlds of
CPU processes (``LocalCluster``; rank r takes its rows of each batch):

- straight: 4 steps at n=2, saving at step 2 (``ckpt.save`` of
  ``TrainState.to_tree()``: every rank writes its chunk of each moment);
- resumed at n=2 from that save, steps 3-4: bit-equal to the straight
  run (losses, parameters, moments, count);
- resumed at n=4: the restored moments are the saved ones truncated or
  zero-padded to the new layout, bit for bit (the reshard is exact: the
  pad is zero); steps 3-4 then within 1e-5 of the straight run (losses,
  parameters and moments absolute: four ranks sum the gradient's f32
  terms in another order);
- on disk each moment is its global ``[padded]`` vector (``[padded]``
  shape, one shard file a rank with its ``[[lo, hi]]`` index), equal to
  the straight run's moments at step 2, and ``tpuframe.ckpt.restore``
  reads it too;
- a JAX checkpoint of a ZeRO-1-layout state (the JAX package's
  ``zero1.make_state`` with no mesh: flat ``[size]`` moments, written by
  ``tpuframe.ckpt.save`` after two JAX steps) restored and sharded by the
  port at n=2; the port's step 3 then against the JAX step 3 (losses,
  parameters and moments within 1e-5, ``test_torch_ckpt_interop.py``'s
  tolerance), and the port's moments mapped back to the JAX layout
  (``zero1_moments_to_jax``) bit-equal to the checkpoint's before it.
"""

import json
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tpuframe import ckpt as jax_ckpt  # noqa: E402
from tpuframe import models as jax_models  # noqa: E402
from tpuframe import train as jax_train  # noqa: E402
from tpuframe.models import resnet as jax_resnet  # noqa: E402
from tpuframe.parallel import step as jax_step  # noqa: E402
from tpuframe.parallel import zero1 as jax_zero1  # noqa: E402
from tpuframe.utils import optim as jax_optim  # noqa: E402
from tpuframe.utils.config import TrainConfig as JaxTrainConfig  # noqa: E402
from tpuframe_torch import ckpt  # noqa: E402
from tpuframe_torch.data import datasets  # noqa: E402
from tpuframe_torch.launch.launcher import LocalCluster  # noqa: E402
from tpuframe_torch.models import convert  # noqa: E402
from tpuframe_torch.parallel import zero1  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-5
LM_DATA = {"seq_len": 32, "vocab_size": 64, "synthetic_size": 32}
CFG = dict(name="lm", model="transformer-lm",
           model_kwargs={"tiny": True, "vocab_size": 64, "attn_impl": "xla"},
           dataset="lm_text", dataset_kwargs=LM_DATA, optimizer="adamw",
           base_lr=3e-3, scale_lr_by_batch=False, warmup_steps=1,
           schedule="cosine", weight_decay=0.1, grad_clip_norm=None,
           global_batch=4, total_steps=10)

# One rank: ``mode`` straight (4 steps from the init, saving at step 2),
# resume (restore step 2 at this world, steps 3-4) or interop (a JAX
# zero1 checkpoint, step 3).  Rank 0 writes the losses, the model, the
# moments gathered whole (after the restore too) and the count.
_WORKER = r"""
import json, os, sys
import numpy as np
import torch
from tpuframe_torch import ckpt
from tpuframe_torch import train as port_train
from tpuframe_torch.data import datasets
from tpuframe_torch.models import convert
from tpuframe_torch.models import transformer_lm as torch_lm
from tpuframe_torch.parallel import bootstrap, collectives, zero1
from tpuframe_torch.parallel import step as port_step
from tpuframe_torch.utils.config import TrainConfig

mode, root, out, cfg = sys.argv[1], sys.argv[2], sys.argv[3], sys.argv[4]
bootstrap.initialize(device="cpu")
grp = collectives.group()
n, r = collectives.world()
cfg = TrainConfig(**json.loads(cfg))
ds, _ = datasets.lm_text(None, **cfg.dataset_kwargs)
model = torch_lm.TransformerLM(torch_lm.LMConfig.tiny(
    vocab_size=64, attn_impl="xla"), device="cpu")
state = zero1.make_state(cfg, model, grp, seed=1)
step = port_step.make_train_step(port_train.make_loss_fn(cfg),
                                 weight_update="zero1")
per = 4 // n


def whole():
    out = {}
    for key, ts in state.opt.moments.items():
        for name, t in zip(state.opt.names, ts):
            full, work = collectives.all_gather_start(t, grp)
            work.wait()
            out[f"{key}/{name}"] = full.numpy().copy()
    return out


def run(first, last):
    losses = []
    for i in range(first, last):
        rows = np.arange(4 * i + per * r, 4 * i + per * (r + 1))
        losses.append(float(step(state, {
            k: torch.from_numpy(v) for k, v in ds[rows].items()})["loss"]))
    return losses


res = {}
if mode == "straight":
    model.load_state_dict(torch.load(f"{root}/init.pt"))
    losses = run(0, 2)
    ckpt.save(f"{root}/ck", 2, state.to_tree())
    res["at2"] = whole()
    losses += run(2, 4)
elif mode == "resume":
    tree = ckpt.restore(f"{root}/ck", 2, target=state.to_tree())
    state.load_tree(tree)
    res["restored"] = whole()
    losses = run(2, 4)
else:
    msd, osd, stp = convert.train_state_from_jax(
        ckpt.restore(f"{root}/jax", 2), "transformer-lm", zero1=(n, r))
    model.load_state_dict(msd)
    state.opt.load_state_dict(osd)
    state.step = stp
    res["restored"] = whole()
    losses = run(2, 3)
res["final"] = whole()
if r == 0:
    res["model"] = {k: v.numpy() for k, v in model.state_dict().items()}
    with open(f"{out}.json", "w") as f:
        json.dump({"losses": losses, "count": state.opt.count,
                   "step": state.step}, f)
    np.savez(f"{out}.npz", **{f"{part}/{k}": v for part, d in res.items()
                              for k, v in d.items()})
bootstrap.shutdown()
# torch 2.13's gloo worlds can abort in the interpreter's teardown (the
# replicated trainer's too): the results are written, so skip it
sys.stdout.flush()
os._exit(0)
"""


def _launch(n, mode, root, out):
    LocalCluster(n, timeout=300, extra_env={
        "PYTHONPATH": REPO, "TPUFRAME_DIST_BACKEND": "gloo",
        "OMP_NUM_THREADS": "1"}).launch(
        [sys.executable, "-c", _WORKER, mode, str(root), str(out),
         json.dumps(CFG)])
    return (json.loads(open(f"{out}.json").read()),
            dict(np.load(f"{out}.npz")))


def _jax_lm():
    jcfg = JaxTrainConfig(**CFG)
    model = jax_models.get_model("transformer-lm", dtype=jnp.float32,
                                 **jcfg.model_kwargs)
    params = jax.tree.map(np.asarray, model.init(
        jax.random.key(0), jnp.zeros((1, 32), jnp.int32))["params"])
    return jcfg, model, params


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The straight n=2 run with its save, the resumes at n=2 and n=4,
    and the JAX checkpoint's restore at n=2 with the JAX steps."""
    root = tmp_path_factory.mktemp("zero1_ckpt")
    jcfg, model, params = _jax_lm()
    torch.save(convert.params_from_jax(params), root / "init.pt")
    out = {"straight": _launch(2, "straight", root, root / "straight"),
           "resume2": _launch(2, "resume", root, root / "resume2"),
           "resume4": _launch(4, "resume", root, root / "resume4")}
    # two JAX steps with no mesh, the state in the ZeRO-1 layout saved by
    # the JAX writer, then the JAX step 3
    tx = jax_optim.build_optimizer(jcfg, params)
    state = jax_step.TrainState.create(params, tx)
    step = jax_step.make_train_step(jax_train.make_loss_fn(jcfg, model), tx,
                                    None, donate=False)
    train, _ = datasets.lm_text(None, **LM_DATA)
    batch = lambda i: {k: jnp.asarray(v)  # noqa: E731
                       for k, v in train[np.arange(4 * i, 4 * i + 4)].items()}
    for i in range(2):
        state, _ = step(state, batch(i))
    layout = jax_zero1.make_state(state.params, tx)
    flat = jax.tree.map(lambda a: a.reshape(-1) if a.ndim else a,
                        state.opt_state)
    assert (jax.tree.map(lambda a: a.shape, flat)
            == jax.tree.map(lambda a: a.shape, layout.opt_state))
    saved = jax_step.TrainState(step=state.step, params=state.params,
                                opt_state=flat, model_state={},
                                rng=state.rng)
    jax_ckpt.save(str(root / "jax"), 2, saved)
    state3, m3 = step(state, batch(2))
    out["interop"] = _launch(2, "interop", root, root / "interop")
    out["jax"] = {"params": params, "saved": jax.tree.map(np.asarray, flat),
                  "loss3": float(m3["loss"]), "state3": state3}
    out["root"] = root
    return out


def _part(arrays, part):
    return {k[len(part) + 1:]: v for k, v in arrays.items()
            if k.startswith(part + "/")}


def test_resume_at_the_same_world_is_bit_equal(runs):
    s_info, s = runs["straight"]
    r_info, r = runs["resume2"]
    assert r_info["losses"] == s_info["losses"][2:]
    assert (r_info["count"], r_info["step"]) == (4, 4)
    for part in ("final", "model"):
        want, got = _part(s, part), _part(r, part)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_resume_at_another_world_reshards_exactly(runs):
    s_info, s = runs["straight"]
    r_info, r = runs["resume4"]
    at2, restored = _part(s, "at2"), _part(r, "restored")
    for k, v in at2.items():
        name = k.split("/", 1)[1]
        size = int(np.prod(_part(s, "model")[name].shape))
        assert restored[k].size == zero1.padded_len(size, 4)
        np.testing.assert_array_equal(restored[k][:size], v[:size])
        assert not restored[k][size:].any() and not v[size:].any()
    np.testing.assert_allclose(r_info["losses"], s_info["losses"][2:],
                               atol=ATOL, rtol=0)
    assert r_info["count"] == 4
    for k, v in _part(s, "model").items():
        np.testing.assert_allclose(_part(r, "model")[k], v, atol=ATOL,
                                   rtol=0, err_msg=k)
    for k, v in _part(s, "final").items():
        size = min(v.size, _part(r, "final")[k].size)
        np.testing.assert_allclose(_part(r, "final")[k][:size], v[:size],
                                   atol=ATOL, rtol=0, err_msg=k)


def test_the_moments_on_disk_are_the_global_padded_vectors(runs):
    root = runs["root"]
    at2 = _part(runs["straight"][1], "at2")
    manifest = json.loads((root / "ck" / "step_00000002" /
                           "manifest.json").read_text())
    tree = ckpt.restore(str(root / "ck"), 2)
    jtree = jax_ckpt.restore(str(root / "ck"), 2)
    for k, v in at2.items():
        entry = manifest["leaves"][f"opt/{k}"]
        assert entry["shape"] == [v.size]
        half = v.size // 2
        assert [sh["index"] for sh in entry["shards"]] == [
            [[0, half]], [[half, v.size]]]
        key, name = k.split("/", 1)
        np.testing.assert_array_equal(tree["opt"][key][name].numpy(), v)
        np.testing.assert_array_equal(np.asarray(jtree["opt"][key][name]), v)
    # a replicated target does not take a flat moment of a 2-d leaf
    name = "blocks.0.up.weight"
    with pytest.raises(ValueError, match="not a flat ZeRO-1"):
        ckpt.restore(str(root / "ck"), 2, target={
            **tree, "opt": {**tree["opt"], "mu": {
                **tree["opt"]["mu"],
                name: torch.zeros(*tree["model"][name].shape)}}})
    # nor a model leaf of another shape
    with pytest.raises(ValueError, match="does not match target shape"):
        ckpt.restore(str(root / "ck"), 2, target={
            **tree, "model": {**tree["model"], name: torch.zeros(3)}})


def test_a_jax_zero1_checkpoint_restores_into_the_port(runs):
    info, got = runs["interop"]
    jax_side = runs["jax"]
    family = "transformer-lm"
    order = convert.flat_order(jax_side["params"], family)
    restored = _part(got, "restored")
    for key in ("mu", "nu"):
        mine = {k.split("/", 1)[1]: v for k, v in restored.items()
                if k.startswith(key + "/")}
        back = convert.zero1_moments_to_jax(mine, order, 1)
        want = jax_side["saved"][0][0]._asdict()[key]
        for path, w in convert._paths(want):
            np.testing.assert_array_equal(convert._at(back, path), w)
    assert info["count"] == 3 and info["step"] == 3
    np.testing.assert_allclose(info["losses"], [jax_side["loss3"]],
                               atol=ATOL, rtol=0)
    state3 = jax_side["state3"]
    want_model = convert.params_from_jax(jax.tree.map(np.asarray,
                                                      state3.params))
    for k, w in want_model.items():
        np.testing.assert_allclose(_part(got, "model")[k], w.numpy(),
                                   atol=ATOL, rtol=0, err_msg=k)
    final = _part(got, "final")
    adam = state3.opt_state[0][0]
    for key in ("mu", "nu"):
        mine = {k.split("/", 1)[1]: v for k, v in final.items()
                if k.startswith(key + "/")}
        back = convert.zero1_moments_to_jax(mine, order, 1)
        for path, w in convert._paths(
                jax.tree.map(np.asarray, adam._asdict()[key])):
            np.testing.assert_allclose(convert._at(back, path),
                                       w.reshape(-1), atol=ATOL, rtol=0)


@pytest.mark.parametrize("family", ["resnet50", "transformer-lm"])
@pytest.mark.parametrize("n", [1, 2, 3])
def test_the_flat_maps_round_trip(family, n):
    """A JAX ZeRO-1 moment (random values) → each rank's chunks → the
    JAX layout again, bit for bit; the chunks are the replicated map's
    moments flattened and padded."""
    if family == "resnet50":
        m = jax_resnet.ResNet(stage_sizes=(1, 1),
                              block_cls=jax_resnet.Bottleneck,
                              num_classes=4, width=8, bn="fused")
        v = m.init(jax.random.key(0), jnp.zeros((2, 32, 32, 3)), train=True)
        params, stats = (jax.tree.map(np.asarray, v["params"]),
                         jax.tree.map(np.asarray, v["batch_stats"]))
    else:
        params, stats = _jax_lm()[2], None
    rng = np.random.default_rng(n)
    shaped = jax.tree.map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32), params)
    flat = jax.tree.map(
        lambda a: np.pad(a.reshape(-1),
                         (0, zero1.padded_len(a.size, n) - a.size)), shaped)
    order = convert.flat_order(params, family, stats)
    to_port = convert._param_map(family, stats)
    whole = {}
    for r in range(n):
        chunks = convert.zero1_moments_from_jax(flat, order, n, r)
        for name, t in chunks.items():
            whole.setdefault(name, []).append(t)
    replicated = to_port(shaped)
    for name, parts in whole.items():
        full = torch.cat(parts)
        np.testing.assert_array_equal(
            full.numpy(), zero1.flat_pad(replicated[name], n).numpy())
    back = convert.zero1_moments_to_jax(
        {k: torch.cat(v) for k, v in whole.items()}, order, n)
    for path, w in convert._paths(flat):
        np.testing.assert_array_equal(convert._at(back, path), w)


def test_only_a_zero1_moment_is_resharded(tmp_path):
    """``restore`` reshards a flat ``opt`` leaf saved as a ``FlatShard``
    (or restored into one); a replicated 1-d moment of another length is
    no ZeRO-1 vector and raises."""
    d = str(tmp_path)
    ckpt.save(d, 1, {"opt": {"trace": {"b": torch.ones(5)}}, "step": 1})
    target = {"opt": {"trace": {"b": torch.zeros(6)}}, "step": 0}
    with pytest.raises(ValueError, match="not a flat ZeRO-1 optimizer"):
        ckpt.restore(d, 1, target=target)
    ckpt.save(d, 2, {"opt": {"trace": {"b": ckpt.FlatShard(
        torch.ones(5), 0, 1)}}, "step": 1})
    got = ckpt.restore(d, 2, target=target)
    assert got["opt"]["trace"]["b"].tolist() == [1.0] * 5 + [0.0]
    got = ckpt.restore(d, 1, target={"opt": {"trace": {"b": ckpt.FlatShard(
        torch.zeros(3), 1, 2)}}, "step": 0})
    assert got["opt"]["trace"]["b"].tolist() == [1.0, 1.0, 0.0]
