"""tpuframe_torch's MoE LM trainer against the JAX harness's.

A tiny MoE ``TransformerLM`` (4 experts, top-2 on every second block,
``moe_capacity_factor=1.0``, so the busiest experts drop tokens) trains
three adamw steps with ``grad_clip_norm`` and the harness's aux weight
0.01, on the fused and on the dense head, from the flax init converted
with ``params_from_jax``:

  - one process against the JAX harness's unsharded step
    (``make_train_step(mesh=None)``);
  - ``data=2`` as two gloo processes (the replicated, plain data-parallel
    mode: each rank routes its own rows with its own capacity, the JAX
    shard_map step's semantics) against the JAX ``data=2`` shard_map step
    on the conftest's virtual devices.  The two JAX steps differ, which
    the test shows too: the mesh selects the routing.

Losses, ``moe_aux``, gradient norms within 1e-5 and final parameters
within 1e-5 absolute (``test_torch_train.py``'s f32 tolerances: summation
order only), except where the JAX step itself moves further when only
its layout changes: in the one-process run, an element where the JAX
unsharded step and the JAX sharded-state step on ``data=1 x model=2``
(the same logical program) differ by more than 1e-5 is held within twice
that distance, measured in the run; such elements must be under 0.1% of
their tensor, and the test prints them.  Three Adam steps amplify the
summation order of a gradient at the scale of Adam's epsilon: in
``moe.up_experts`` an element whose step-1 gradient is ~1e-9 moves by
~4e-5 between the JAX layouts alone.
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

from tpuframe import models as jax_models  # noqa: E402
from tpuframe import train as jax_train  # noqa: E402
from tpuframe.parallel import fsdp as jax_fsdp  # noqa: E402
from tpuframe.parallel import mesh as jax_mesh  # noqa: E402
from tpuframe.parallel import step as jax_step  # noqa: E402
from tpuframe.parallel import tp as jax_tp  # noqa: E402
from tpuframe.utils import build_optimizer as jax_build_optimizer  # noqa: E402
from tpuframe.utils.config import TrainConfig as JaxTrainConfig  # noqa: E402
from tpuframe_torch import train as port_train  # noqa: E402
from tpuframe_torch.data import datasets  # noqa: E402
from tpuframe_torch.models.convert import params_from_jax  # noqa: E402
from tpuframe_torch.utils.config import TrainConfig  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 3
MODEL_KW = {"tiny": True, "vocab_size": 64, "hidden_size": 32,
            "num_heads": 2, "intermediate_size": 64, "max_seq": 64,
            "moe_experts": 4, "moe_k": 2, "moe_capacity_factor": 1.0,
            "attn_impl": "xla", "remat": True}
TOL = 1e-5


def common(fused: bool) -> dict:
    return dict(name="moe", model="transformer-lm", model_kwargs=MODEL_KW,
               dataset="lm_text",
               dataset_kwargs={"seq_len": 32, "vocab_size": 64,
                               "synthetic_size": 64},
               optimizer="adamw", base_lr=3e-3, scale_lr_by_batch=False,
               warmup_steps=0, schedule="cosine", weight_decay=0.1,
               grad_clip_norm=1.0, global_batch=8, total_steps=10,
               compute_dtype="float32", fused_xent=fused)


def batches():
    train, _ = datasets.lm_text(None, seq_len=32, vocab_size=64,
                                synthetic_size=64)
    return [train[np.arange(8 * i, 8 * i + 8)] for i in range(STEPS)]


def jax_run(fused: bool, mesh_kw: dict | None = None) -> dict:
    """The JAX harness's steps on a mesh of ``mesh_kw``: none (the
    unsharded step), data only (the shard_map step) or with an expert or
    model axis (the sharded-state step, its state placed by the
    trainer's rules), on the conftest's virtual devices."""
    mesh_kw = mesh_kw or {"data": 1}
    jcfg = JaxTrainConfig(**common(fused)).with_overrides(mesh=mesh_kw)
    model = jax_models.get_model("transformer-lm", dtype=jnp.float32,
                                 **MODEL_KW)
    params = jax.tree.map(np.asarray, model.init(
        jax.random.key(0), jnp.zeros((1, 32), jnp.int32))["params"])
    tx = jax_build_optimizer(jcfg, params)
    state = jax_step.TrainState.create(params, tx)
    n = int(np.prod(list(mesh_kw.values())))
    mesh = (None if n == 1 else jax_mesh.make_mesh(
        jax_mesh.MeshSpec(**mesh_kw), devices=jax.devices()[:n]))
    shardings, place = None, jnp.asarray
    if mesh_kw.get("expert", 1) > 1 or mesh_kw.get("model", 1) > 1:
        shardings = jax_fsdp.state_shardings(
            state, mesh, tp_rules=jax_tp.rules_for_model("transformer-lm"))
        state = jax.tree.map(jax.device_put, state, shardings)
        on = NamedSharding(jax_fsdp.auto_mesh(mesh), jax_mesh.batch_spec())
        place = lambda v: jax.device_put(jnp.asarray(v), on)  # noqa: E731
    step = jax_step.make_train_step(jax_train.make_loss_fn(jcfg, model), tx,
                                    mesh, donate=False,
                                    state_shardings=shardings)
    out = {"loss": [], "moe_aux": [], "grad_norm": []}
    for b in batches():
        state, m = step(state, {k: place(v) for k, v in b.items()})
        for k in out:
            out[k].append(float(m[k]))
    out["params"] = params_from_jax(jax.tree.map(np.asarray, state.params))
    out["init"] = params_from_jax(params)
    return out


def port_one_process(fused: bool, init: dict) -> dict:
    cfg = TrainConfig(**common(fused)).with_overrides(mesh={"data": 1})
    h = port_train.build_harness(cfg, device="cpu")
    h.state.model.load_state_dict(init)
    out = {"loss": [], "moe_aux": [], "grad_norm": []}
    for b in batches():
        m = h.train_step(h.state, {k: torch.from_numpy(v)
                                   for k, v in b.items()})
        for k in out:
            out[k].append(float(m[k]))
    out["params"] = h.state.model.state_dict()
    return out


# One rank of the data=2 world: the trainer's harness for each head, the
# JAX init loaded, three steps on this rank's rows; each rank writes its
# metrics and state.  The process ends with os._exit(0) once its file is
# written (a gloo world's interpreter teardown can abort).
_WORKER = r"""
import json, os, sys
import numpy as np
import torch
import torch.distributed as dist
from tpuframe_torch import train as port_train
from tpuframe_torch.utils.config import TrainConfig

rank, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        world_size=2, rank=rank)
runs = json.load(open(f"{out}.cfg.json"))
data = np.load(f"{out}.batches.npz")
result = {}
for head, kw in runs.items():
    cfg = TrainConfig(**kw).with_overrides(mesh={"data": 2})
    h = port_train.build_harness(cfg, device="cpu")
    h.state.model.load_state_dict(torch.load(f"{out}.init.pt"))
    got = {"loss": [], "moe_aux": [], "grad_norm": []}
    for i in range(len(data.files) // 2):
        b = {k: data[f"{k}{i}"] for k in ("input_ids", "labels")}
        n = b["input_ids"].shape[0] // 2
        mine = {k: torch.from_numpy(np.ascontiguousarray(
            v[rank * n:(rank + 1) * n])) for k, v in b.items()}
        m = h.train_step(h.state, mine)
        for k in got:
            got[k].append(float(m[k]))
    got["params"] = {k: v.tolist()
                     for k, v in h.state.model.state_dict().items()}
    result[head] = got
with open(f"{out}.{rank}", "w") as f:
    json.dump(result, f)
os._exit(0)
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def data2_world(tmp_path_factory):
    """The JAX data=2 step of both heads, and the port's two-rank run."""
    want = {"fused": jax_run(True, {"data": 2}),
            "dense": jax_run(False, {"data": 2})}
    root = tmp_path_factory.mktemp("moe_train")
    out = root / "rank"
    torch.save(want["fused"]["init"], f"{out}.init.pt")
    (root / "rank.cfg.json").write_text(json.dumps(
        {"fused": common(True), "dense": common(False)}))
    np.savez(f"{out}.batches.npz", **{f"{k}{i}": v for i, b in
                                      enumerate(batches())
                                      for k, v in b.items()})
    port = str(_free_port())
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("TPUFRAME_")}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(r), port, str(out)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(2)]
    for p in procs:
        _, err = p.communicate(timeout=300)
        assert p.returncode == 0, err
    got = [json.loads((root / f"rank.{r}").read_text()) for r in range(2)]
    return want, got


def _close(got: dict, want: dict, other: dict | None = None) -> None:
    """``got`` against ``want`` within TOL; with ``other`` (another JAX
    layout's step) an element where ``want`` and ``other`` differ by more
    than TOL is held within twice that distance instead, and such
    elements are under 0.1% of the tensor."""
    for k in ("loss", "moe_aux", "grad_norm"):
        np.testing.assert_allclose(got[k], want[k], atol=TOL, rtol=0,
                                   err_msg=k)
    for k, w in want["params"].items():
        w = w.numpy()
        atol = np.full_like(w, TOL)
        if other is not None:
            spread = np.abs(w - other["params"][k].numpy())
            loose = spread > TOL
            assert int(loose.sum()) * 1000 < w.size, (
                f"{k}: {int(loose.sum())} of {w.size} elements differ by "
                f"more than {TOL} between JAX layouts")
            if loose.any():
                print(f"{k}: loosened at {np.argwhere(loose).tolist()} to "
                      f"2x {spread[loose].tolist()}")
            atol = np.where(loose, 2 * spread, atol)
        err = np.abs(np.asarray(got["params"][k]) - w)
        bad = err > atol
        assert not bad.any(), (
            f"{k}: {int(bad.sum())} elements off, first at "
            f"{np.argwhere(bad)[0].tolist()}: {err[bad][0]} > "
            f"{atol[bad][0]}")


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "dense"])
def test_one_process_matches_the_jax_unsharded_step(fused):
    want = jax_run(fused)
    got = port_one_process(fused, want["init"])
    _close(got, want, jax_run(fused, {"data": 1, "model": 2}))
    assert all(a > 0 for a in got["moe_aux"])
    # clipping was live: the norm stayed above grad_clip_norm
    assert max(want["grad_norm"]) > 1.0


@pytest.mark.parametrize("head", ["fused", "dense"])
def test_data2_matches_the_jax_shard_map_step(data2_world, head):
    want, got = data2_world
    for rank in got:
        _close(rank[head], want[head])


def test_data2_routing_is_per_rank_unlike_the_unsharded_step(data2_world):
    """The data=2 shard_map step routes each rank's rows alone (fact 2 of
    the slice): its aux values differ from the unsharded step's on the
    same global batches, and the port's follow the shard_map step."""
    want, got = data2_world
    whole = jax_run(True)
    assert max(abs(a - b) for a, b in zip(whole["moe_aux"],
                                          want["fused"]["moe_aux"])) > 1e-4
    np.testing.assert_allclose(got[0]["fused"]["moe_aux"],
                               want["fused"]["moe_aux"], atol=TOL, rtol=0)
