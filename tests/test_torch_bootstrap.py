"""The port's process bootstrap, its local launcher, and the trainer as a
2-rank world started from the launcher's environment.

``parallel.bootstrap`` reads the JAX package's environment contract
(``TPUFRAME_COORDINATOR``, ``TPUFRAME_NUM_PROCESSES``,
``TPUFRAME_PROCESS_ID``) plus ``TPUFRAME_DIST_BACKEND``; without a
coordinator it makes no group.  ``launch.launcher.LocalCluster`` starts N
ranks of a command with that environment and fails loudly when one rank
fails.

The trainer: ``python -m tpuframe_torch.train --device cpu --config
smoke`` (the MNIST ConvNet with dropout 0, batch 32, nesterov SGD) in a
2-rank gloo world, with ``grad_reduce`` "mean" and "adasum", no
``init_process_group`` of the caller's.  Both ranks start from a flax init
(mapped through ``models.convert`` and written as the port's step-0
checkpoint, which the trainer resumes from) and save every step.  Two
references train the same init on the same data: the JAX harness's own
pieces (``make_loss_fn``, ``build_optimizer``, ``make_train_step`` with the
same ``grad_reduce``) on a data=2 mesh of virtual CPU devices, each
replica fed the batch that the port's rank of the same index loads; and
the plain version of the data-parallel step in one process (each rank's
half-batch in turn, the gradients reduced in float64).  f32, summation
order only: every step's parameters within 1e-5 absolute (the tolerance
of the port's other 2-rank tests), the printed losses to their 5
significant digits.
"""

import os
import re
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tpuframe import models as jax_models  # noqa: E402
from tpuframe import train as jax_train  # noqa: E402
from tpuframe.parallel import mesh as jax_mesh  # noqa: E402
from tpuframe.parallel import step as jax_step  # noqa: E402
from tpuframe.utils import optim as jax_optim  # noqa: E402
from tpuframe.utils.config import get_config as jax_get_config  # noqa: E402
from tpuframe_torch import ckpt  # noqa: E402
from tpuframe_torch import models as port_models  # noqa: E402
from tpuframe_torch import train as port_train  # noqa: E402
from tpuframe_torch.data import datasets  # noqa: E402
from tpuframe_torch.data.pipeline import ShardedLoader  # noqa: E402
from tpuframe_torch.launch import launcher  # noqa: E402
from tpuframe_torch.models.convert import convnet_from_jax  # noqa: E402
from tpuframe_torch.parallel import bootstrap, collectives, fusion  # noqa: E402
from tpuframe_torch.parallel import step as port_step  # noqa: E402
from tpuframe_torch.utils.config import get_config  # noqa: E402
from tpuframe_torch.utils.optim import build_optimizer  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 3
ATOL = 1e-5
CUTS = {"model_kwargs": {"dropout": 0.0}, "total_steps": STEPS,
        "log_every": 1, "ckpt_every": 1, "ckpt_keep": STEPS,
        "eval_every": STEPS, "eval_batches": 1}
ENV = ("TPUFRAME_COORDINATOR", "TPUFRAME_NUM_PROCESSES",
       "TPUFRAME_PROCESS_ID", "TPUFRAME_DIST_BACKEND")


@pytest.fixture
def clean_env(monkeypatch):
    for var in ENV + bootstrap.FUSION_ENV:
        monkeypatch.delenv(var, raising=False)
    bootstrap.shutdown()
    yield monkeypatch
    bootstrap.shutdown()


def test_from_env_reads_the_launcher_contract(clean_env):
    clean_env.setenv("TPUFRAME_COORDINATOR", "10.0.0.1:1234")
    clean_env.setenv("TPUFRAME_NUM_PROCESSES", "4")
    clean_env.setenv("TPUFRAME_PROCESS_ID", "3")
    cfg = bootstrap.DistConfig.from_env(device="cpu")
    assert cfg == bootstrap.DistConfig("10.0.0.1:1234", 4, 3, "gloo")
    assert bootstrap.DistConfig.from_env(device="cuda").backend == "nccl"
    assert bootstrap.DistConfig.from_env().backend == "nccl"
    clean_env.setenv("TPUFRAME_DIST_BACKEND", "gloo")
    assert bootstrap.DistConfig.from_env(device="cuda").backend == "gloo"
    clean_env.delenv("TPUFRAME_COORDINATOR")
    assert bootstrap.DistConfig.from_env().coordinator_address is None


def test_no_coordinator_is_a_no_op_and_idempotent(clean_env):
    bootstrap.initialize(device="cpu")
    bootstrap.initialize(device="cpu")
    assert bootstrap.is_initialized()
    assert collectives.process_group() is None
    assert (bootstrap.process_count(), bootstrap.process_index()) == (1, 0)
    assert (bootstrap.local_rank(), bootstrap.local_size()) == (0, 1)
    assert bootstrap.is_primary()
    assert bootstrap.allgather_object({"a": 1}) == [{"a": 1}]
    bootstrap.host_barrier("solo")
    with pytest.raises(ValueError, match="out of range"):
        bootstrap.broadcast_object(1, root=1)


@pytest.mark.parametrize("var", ["HOROVOD_FUSION_THRESHOLD",
                                 "TPUFRAME_FUSION_THRESHOLD"])
def test_fusion_threshold_is_refused_naming_item_12(clean_env, var):
    """Horovod's knob, which the JAX package never reads, is refused and
    the message names the port's; the port's (the JAX package's) is
    accepted and resolved, and a value that does not parse raises."""
    clean_env.setenv(var, "67108864")
    if var == "HOROVOD_FUSION_THRESHOLD":
        with pytest.raises(NotImplementedError,
                           match=f"{var}.*TPUFRAME_FUSION_THRESHOLD"):
            bootstrap.initialize(device="cpu")
        assert not bootstrap.is_initialized()
        return
    bootstrap.initialize(device="cpu")
    assert bootstrap.is_initialized()
    assert fusion.resolve() == (67108864, "env")
    bootstrap.shutdown()
    clean_env.setenv(var, "64MiB")
    with pytest.raises(ValueError, match=var):
        bootstrap.initialize(device="cpu")
    assert not bootstrap.is_initialized()


def test_a_coordinator_needs_the_world_size_and_rank(clean_env):
    clean_env.setenv("TPUFRAME_COORDINATOR", "127.0.0.1:1")
    with pytest.raises(ValueError, match="TPUFRAME_NUM_PROCESSES"):
        bootstrap.initialize(device="cpu")


def test_a_coordinator_on_cuda_without_a_gpu_raises(clean_env):
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the default device is usable")
    config = bootstrap.DistConfig("127.0.0.1:1", 2, 0)
    with pytest.raises(RuntimeError, match="no GPU is visible"):
        bootstrap.initialize(config)


_LOCAL = ("import json; from tpuframe_torch.parallel import bootstrap; "
          "bootstrap.initialize(device='cpu'); bootstrap.host_barrier('t'); "
          "print(json.dumps([bootstrap.process_count(), "
          "bootstrap.process_index(), bootstrap.local_rank(), "
          "bootstrap.local_size(), bootstrap.is_primary()]))")


def test_local_rank_and_size_in_a_two_rank_world():
    procs = launcher.LocalCluster(2, timeout=120, extra_env={
        "PYTHONPATH": REPO}).launch([sys.executable, "-c", _LOCAL])
    got = [p.stdout.strip().splitlines()[-1] for p in procs]
    assert got == ["[2, 0, 0, 2, true]", "[2, 1, 1, 2, false]"]


def test_local_cluster_raises_with_every_ranks_tail():
    code = ("import os, sys; r = os.environ['TPUFRAME_PROCESS_ID']; "
            "print('rank', r, 'of', os.environ['TPUFRAME_NUM_PROCESSES']); "
            "sys.exit(3 if r == '1' else 0)")
    with pytest.raises(RuntimeError) as err:
        launcher.LocalCluster(2, timeout=60).launch(
            [sys.executable, "-c", code])
    msg = str(err.value)
    assert "rank 1 (exit 3)" in msg and "rank 1 of 2" in msg
    assert "rank 0 (exit 0)" in msg


def test_local_cluster_kills_ranks_past_the_timeout():
    with pytest.raises(RuntimeError, match="timed out after 1 s"):
        launcher.LocalCluster(1, timeout=1).launch(
            [sys.executable, "-c", "import time; time.sleep(60)"])


def _port_batches(cfg):
    """The global batch of each step, rank 0's rows then rank 1's, as the
    port's 2-rank loaders feed them."""
    train_ds, _ = datasets.build(cfg.dataset, None, **cfg.dataset_kwargs)
    loaders = [ShardedLoader(train_ds, cfg.global_batch, seed=cfg.seed,
                             world=2, rank=r).from_step(0) for r in range(2)]
    out = []
    for _ in range(STEPS):
        halves = [next(it) for it in loaders]
        out.append({k: np.concatenate([h[k].numpy() for h in halves])
                    for k in halves[0]})
    return out


@pytest.fixture(scope="module")
def flax_init():
    jcfg = jax_get_config("smoke").with_overrides(**CUTS)
    model = jax_models.get_model(jcfg.model, dtype=jnp.float32,
                                 **jcfg.model_kwargs)
    cfg = get_config("smoke").with_overrides(**CUTS)
    batches = _port_batches(cfg)
    v = jax.tree.map(np.asarray, model.init(
        jax.random.key(0), jnp.asarray(batches[0]["image"][:2])))
    return jcfg, model, v["params"], batches


def _jax_run(flax_init, grad_reduce):
    jcfg, model, params, batches = flax_init
    tx = jax_optim.build_optimizer(jcfg, params)
    state = jax_step.TrainState.create(params, tx)
    mesh = jax_mesh.make_mesh(jax_mesh.MeshSpec(data=2),
                              devices=jax.devices()[:2])
    step = jax_step.make_train_step(jax_train.make_loss_fn(jcfg, model), tx,
                                    mesh, donate=False,
                                    grad_reduce=grad_reduce)
    losses, states = [], []
    for b in batches:
        state, m = step(state, {k: jnp.asarray(x) for k, x in b.items()})
        losses.append(float(m["loss"]))
        states.append(convnet_from_jax(jax.tree.map(np.asarray,
                                                    state.params)))
    return losses, states


def _f64_combine(grad_reduce, a, b):
    """The two ranks' gradients reduced in float64."""
    if grad_reduce == "mean":
        return (a + b) / 2
    dot, na, nb = (a * b).sum(), (a * a).sum(), (b * b).sum()
    ca = dot / (2 * na) if na > 0 else 0.0
    cb = dot / (2 * nb) if nb > 0 else 0.0
    return (1 - ca) * a + (1 - cb) * b


def _plain_run(cfg, init, batches, grad_reduce):
    """The plain version of the 2-rank data-parallel step in one process:
    the port's loss on each rank's half-batch in turn (with that rank's
    dropout seed), the gradients reduced in float64, the port's
    optimizer."""
    model = port_models.get_model(cfg.model, dtype=cfg.compute_dtype,
                                  device="cpu", **cfg.model_kwargs)
    model.load_state_dict(init)
    opt = build_optimizer(cfg, model)
    loss_fn = port_train.make_loss_fn(cfg)
    half = cfg.global_batch // 2
    losses, states = [], []
    for i, b in enumerate(batches):
        grads, step_loss = [], 0.0
        for r in range(2):
            rows = {k: torch.from_numpy(x[half * r:half * (r + 1)])
                    for k, x in b.items()}
            model.zero_grad(set_to_none=True)
            loss, _ = loss_fn(model, rows, port_step.dropout_seed(
                cfg.seed + 1, i, r))
            loss.backward()
            step_loss += float(loss.detach()) / 2
            grads.append([p.grad.double() for p in model.parameters()])
        for p, a, g in zip(model.parameters(), *grads):
            p.grad = _f64_combine(grad_reduce, a, g).float()
        opt.step()
        losses.append(step_loss)
        states.append({k: v.clone() for k, v in model.state_dict().items()})
    return losses, states


def _assert_states(got_at, want, steps, what):
    for i in steps:
        got = got_at(i + 1)
        assert set(got) == set(want[i])
        for k, w in want[i].items():
            np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=0,
                                       atol=ATOL,
                                       err_msg=f"{what}, step {i + 1} {k}")


@pytest.mark.parametrize("grad_reduce", ["mean", "adasum"])
def test_two_rank_trainer_matches_the_jax_harness(flax_init, grad_reduce,
                                                  tmp_path):
    """The JAX harness and the plain version hold every step, except that
    under Adasum only step 1 is held to the JAX harness: the JAX
    package's Adasum takes its f32 dots with ``jnp.vdot``, which sums the
    1.6 M products of the ConvNet's fc1 kernel in another order than
    PyTorch's reduction, each coefficient carries that rounding along
    the whole gradient, and at smoke's learning rate the two packages'
    parameters part after step 1; the float64 plain version holds the
    port at every step."""
    want_losses, want_states = _jax_run(flax_init, grad_reduce)
    cfg = get_config("smoke").with_overrides(**CUTS)
    init = convnet_from_jax(flax_init[2])
    plain_losses, plain_states = _plain_run(cfg, init, flax_init[3],
                                            grad_reduce)
    model = port_models.get_model(cfg.model, dtype=cfg.compute_dtype,
                                  device="cpu", **cfg.model_kwargs)
    model.load_state_dict(init)
    state = port_step.TrainState(model, build_optimizer(cfg, model),
                                 seed=cfg.seed + 1)
    ckpt.save(str(tmp_path), 0, state.to_tree())

    args = ["--config", "smoke", "--device", "cpu",
            "--ckpt-dir", str(tmp_path),
            "--set", f"grad_reduce={grad_reduce!r}"] + [
        a for k, v in CUTS.items() for a in ("--set", f"{k}={v!r}")]
    procs = launcher.LocalCluster(2, timeout=240, extra_env={
        "PYTHONPATH": REPO, "TPUFRAME_DIST_BACKEND": "gloo"}).launch(
        [sys.executable, "-m", "tpuframe_torch.train", *args])
    out = procs[0].stdout
    assert "[tpuframe] resumed from step 0" in out
    assert "devices=2 global_batch=32" in out
    assert f"[eval {STEPS}]" in out
    assert procs[1].stdout == ""     # rank 1 prints nothing
    printed = [float(x) for x in re.findall(r"\[train \d+\] .*?loss=(\S+)",
                                            out)]
    np.testing.assert_allclose(printed, plain_losses, rtol=5e-5, atol=0)
    jax_steps = range(STEPS) if grad_reduce == "mean" else range(1)
    np.testing.assert_allclose([plain_losses[i] for i in jax_steps],
                               [want_losses[i] for i in jax_steps],
                               rtol=0, atol=ATOL)

    def saved(step):
        return ckpt.restore(str(tmp_path), step)["model"]

    _assert_states(saved, plain_states, range(STEPS), "plain version")
    _assert_states(saved, want_states, jax_steps, "JAX harness")
    # the steps moved every weight
    for k, w in model.state_dict().items():
        assert not torch.equal(saved(STEPS)[k], w), k
