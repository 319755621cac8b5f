"""``tpuframe_torch.parallel.quantwire`` against
``tpuframe.parallel.quantwire``.

- ``quantize_blocks``/``dequantize_blocks`` on the CPU against the JAX
  functions as they run in the JAX step, compiled (``jax.jit``: XLA takes
  ``max / 127`` as a multiply by the reciprocal, whose rounding differs
  from a division's in about one block in ten), bit for bit: random
  blocks, an all-zero block (scale 0, exact zeros back) and exact .5 ties
  (``torch.round`` and ``jnp.round`` both round half to even).
- The collectives in gloo worlds of 2 and 4 CPU processes (one
  ``LocalCluster`` launch a world size, each rank running ``_WORKER``),
  against the JAX functions under ``jax.shard_map(..., check_vma=False)``
  on a data mesh of the first 2 or 4 of the conftest's virtual devices:
  ``reduce_scatter_mean`` and ``all_gather``; ``all_reduce_mean`` against
  the JAX pair ``reduce_scatter_mean`` then ``all_gather`` after the pad
  to a multiple of n (the JAX ``all_reduce_mean`` sees every leaf as
  already summed without vma types, so it cannot serve), and its
  full-precision leaves against ``lax.pmean``.  Bit-equal at n=2 (a sum
  of two terms has one order); within 1e-6 relative at n=4, where the f32
  sum of four dequantized sources may take another order.
- The byte counters (``collectives.WIRE_BYTES``/``WIRE_CALLS``) against
  the int8 wire's formula: ``n * ceil(padded / n / 256) * (256 + 4)`` a
  leg, operand bytes for the all-to-all, result bytes for the gather.
- The int8 steps, replicated and ZeRO-1, on ``tests/test_quantwire.py``'s
  own recipe (``_run``: the sine regression, a tanh MLP, SGD at 0.05 with
  momentum 0.9, 25 steps of 64 rows) at 2 and 4 ranks, against the JAX
  replicated fp step on a data mesh of the same size: every step's loss
  within that test's 2e-3, and the int8 run trains.  The recipe's SGD is
  taken nesterov on both sides: the port's one SGD is optax's
  ``sgd(nesterov=True)`` (neither package's config has a switch for it).
  The data and the initial weights come from numpy seeds.
- Refusals: Adasum or a fusion threshold with the int8 wire, an unknown
  format, a DCN leg other than fp, ``TPUFRAME_HIER``.
"""

import json
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
from jax import lax  # noqa: E402
from jax.sharding import Mesh, PartitionSpec as P  # noqa: E402

from tpuframe.parallel import mesh as jax_mesh  # noqa: E402
from tpuframe.parallel import quantwire as jax_qw  # noqa: E402
from tpuframe.parallel import step as jax_step  # noqa: E402
from tpuframe_torch import train as port_train  # noqa: E402
from tpuframe_torch.launch.launcher import LocalCluster  # noqa: E402
from tpuframe_torch.parallel import quantwire  # noqa: E402
from tpuframe_torch.parallel import step as port_step  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLDS = (2, 4)
RTOL = {2: 0.0, 4: 1e-6}
LOSS_GAP = 2e-3
STEPS = 25
# leaves of the all-reduce: under MIN_QUANT_ELEMS, a length that is no
# multiple of n, several blocks a rank, and an all-zero one
LEAVES = {"small": (7, 3), "odd": (1237,), "big": (40, 130),
          "zero": (2048,)}


def _inputs(n: int) -> dict:
    rng = np.random.default_rng(10 + n)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    out = {"rs": f(n, n * 700), "ag": f(n, 613)}
    for name, shape in LEAVES.items():
        out[f"ar_{name}"] = (np.zeros((n, *shape), np.float32)
                             if name == "zero" else f(n, *shape))
    # the sine regression of tests/test_quantwire.py
    out["x"] = f(STEPS, 64, 32)
    out["y"] = np.sin(out["x"] @ f(32, 8))
    out["w1"], out["b1"] = f(32, 64) * 0.1, np.zeros(64, np.float32)
    out["w2"], out["b2"] = f(64, 8) * 0.1, np.zeros(8, np.float32)
    return out


# One rank: the collectives on its row of each input, with the wire's
# counts of each; then the int8 steps.  Arrays to <out>.<rank>.npz,
# counts and losses to <out>.<rank>.json.
_WORKER = r"""
import json, os, sys
import numpy as np
import torch
from tpuframe_torch.parallel import bootstrap, collectives, quantwire, zero1
from tpuframe_torch.parallel import step as port_step
from tpuframe_torch.utils.config import TrainConfig
from tpuframe_torch.utils.optim import build_optimizer

inp, out, leaves = sys.argv[1], sys.argv[2], json.loads(sys.argv[3])
bootstrap.initialize(device="cpu")
grp = collectives.group()
n, r = collectives.world()
data = np.load(inp)
x = lambda k: torch.from_numpy(data[k][r].copy())
arrays, info = {}, {}


def counted(name, fn):
    collectives.reset_wire()
    res = fn()
    info[name] = {"bytes": dict(collectives.WIRE_BYTES),
                  "calls": dict(collectives.WIRE_CALLS)}
    return res


arrays["rs"] = counted("rs", lambda: quantwire.reduce_scatter_mean(
    x("rs"), grp))
arrays["ag"] = counted("ag", lambda: quantwire.all_gather(x("ag"), grp))
names = list(leaves)
got = counted("ar", lambda: quantwire.all_reduce_mean(
    [x(f"ar_{k}") for k in names], grp))
for k, t in zip(names, got):
    arrays[f"ar_{k}"] = t
got = counted("ar0", lambda: quantwire.all_reduce_mean(
    [x("ar_small")], grp, min_elems=0))
arrays["ar0_small"] = got[0]


class Sine(torch.nn.Module):
    def __init__(self):
        super().__init__()
        for k in ("w1", "b1", "w2", "b2"):
            setattr(self, k, torch.nn.Parameter(
                torch.from_numpy(data[k].copy())))

    def forward(self, x):
        return torch.tanh(x @ self.w1 + self.b1) @ self.w2 + self.b2


def loss_fn(model, batch, seed):
    return ((model(batch["x"]) - batch["y"]) ** 2).mean(), {}


cfg = TrainConfig(name="sine", model="none", optimizer="sgd", base_lr=0.05,
                  scale_lr_by_batch=False, schedule="constant",
                  warmup_steps=0, weight_decay=0.0, momentum=0.9)
rows = data["x"].shape[1] // n
for update in ("replicated", "zero1"):
    model = Sine()
    state = (zero1.make_state(cfg, model, grp) if update == "zero1"
             else port_step.TrainState(model, build_optimizer(cfg, model)))
    step = port_step.make_train_step(loss_fn, weight_update=update,
                                     wire_format="int8-block")
    losses = []
    for i in range(data["x"].shape[0]):
        batch = {k: torch.from_numpy(data[k][i, r * rows:(r + 1) * rows]
                                     .copy()) for k in ("x", "y")}
        losses.append(float(step(state, batch)["loss"]))
    info[f"losses_{update}"] = losses
np.savez(f"{out}.{r}.npz", **{k: v.numpy() for k, v in arrays.items()})
with open(f"{out}.{r}.json", "w") as f:
    json.dump(info, f)
bootstrap.shutdown()
# torch 2.13's gloo worlds can abort in the interpreter's teardown (the
# replicated trainer's too): the results are written, so skip it
sys.stdout.flush()
os._exit(0)
"""


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """``{n: (inputs, [rank r's arrays], [rank r's json])}``."""
    root = tmp_path_factory.mktemp("quantwire")
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
             json.dumps(LEAVES)])
        out[n] = (inputs, [dict(np.load(f"{stem}.{r}.npz"))
                           for r in range(n)],
                  [json.loads(open(f"{stem}.{r}.json").read())
                   for r in range(n)])
    return out


def _jax(n, fn, *xs):
    """``fn`` on each replica's row of ``xs`` under ``shard_map`` with
    ``check_vma=False`` on a data mesh of ``n`` devices; the outputs
    stacked by replica."""
    mesh = Mesh(np.asarray(jax.devices()[:n]), ("data",))

    def body(*blocks):
        outs = fn(*(b[0] for b in blocks))
        return tuple(o[None] for o in outs)

    f = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=P("data"),
                              out_specs=P("data"), check_vma=False))
    return [np.asarray(o) for o in f(*xs)]


def _close(got, want, n):
    if RTOL[n] == 0.0:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL[n],
                                   atol=RTOL[n] * np.abs(want).max())


def _stack(worlds, n, key):
    return np.stack([a[key] for a in worlds[n][1]])


def _legs(padded: int, n: int) -> int:
    return n * -(-(padded // n) // 256) * (256 + 4)


@pytest.mark.parametrize("case", ["random", "zero_block", "ties"])
def test_quantize_blocks_bit_equal_to_jax(case):
    rng = np.random.default_rng(3)
    x = rng.standard_normal(4 * 256).astype(np.float32) * 3
    if case == "zero_block":
        x[256:512] = 0.0
    elif case == "ties":
        # scale 1 (127 is the block's max): every value below is an exact
        # tie of x / scale
        x[:256] = np.resize(np.array(
            [2.5, -3.5, 0.5, -0.5, 1.5, 126.5, -126.5], np.float32), 256)
        x[0] = 127.0
    q, s = quantwire.quantize_blocks(torch.from_numpy(x))
    jq, js = jax.jit(jax_qw.quantize_blocks)(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy().view(np.int32),
                                  np.asarray(js).view(np.int32))
    back = quantwire.dequantize_blocks(q, s).numpy()
    np.testing.assert_array_equal(
        back.view(np.int32),
        np.asarray(jax.jit(jax_qw.dequantize_blocks)(jq, js))
        .view(np.int32))
    if case == "zero_block":
        assert s[1] == 0.0 and not back[1].any()
    if case == "ties":
        assert q[0, :7].tolist() == [127, -4, 0, 0, 2, 126, -126]


@pytest.mark.parametrize("n", WORLDS)
def test_reduce_scatter_mean_and_all_gather_match_jax(worlds, n):
    inputs = worlds[n][0]
    want_rs, = _jax(n, lambda t: (jax_qw.reduce_scatter_mean(t, "data"),),
                    inputs["rs"])
    _close(_stack(worlds, n, "rs"), want_rs, n)
    want_ag, = _jax(n, lambda t: (jax_qw.all_gather(t, "data"),),
                    inputs["ag"])
    _close(_stack(worlds, n, "ag"), want_ag, n)
    # the error law of one phase: blockmax / 254 of the fp mean
    fp = inputs["rs"].mean(axis=0).reshape(n, -1)
    got = _stack(worlds, n, "rs")
    assert np.abs(got - fp).max() <= np.abs(inputs["rs"]).max() / 254


def _pair(n):
    """The JAX pair on one replica's leaf: pad to a multiple of n,
    reduce_scatter_mean, all_gather, unpad."""
    def f(g):
        flat = g.reshape(-1)
        flat = jnp.pad(flat, (0, (-flat.size) % n))
        full = jax_qw.all_gather(jax_qw.reduce_scatter_mean(flat, "data"),
                                 "data")
        return (full[:g.size].reshape(g.shape),)
    return f


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("leaf", sorted(LEAVES))
def test_all_reduce_mean_matches_the_jax_pair(worlds, n, leaf):
    inputs = worlds[n][0]
    key = f"ar_{leaf}"
    if int(np.prod(LEAVES[leaf])) < quantwire.MIN_QUANT_ELEMS:
        want, = _jax(n, lambda g: (lax.pmean(g, "data"),), inputs[key])
    else:
        want, = _jax(n, _pair(n), inputs[key])
    _close(_stack(worlds, n, key), want, n)
    if leaf == "zero":
        assert not _stack(worlds, n, key).any()
    else:
        err = np.abs(_stack(worlds, n, key) - inputs[key].mean(axis=0))
        assert err.max() <= 2 * np.abs(inputs[key]).max() / 254


@pytest.mark.parametrize("n", WORLDS)
def test_min_elems_zero_quantizes_a_small_leaf(worlds, n):
    inputs = worlds[n][0]
    want, = _jax(n, _pair(n), inputs["ar_small"])
    _close(_stack(worlds, n, "ar0_small"), want, n)
    info = worlds[n][2][0]["ar0"]
    assert info["calls"] == {"reduce_scatter": 0, "all_gather": 2,
                             "all_to_all": 2, "all_reduce": 0}


@pytest.mark.parametrize("n", WORLDS)
def test_wire_bytes_follow_the_block_formula(worlds, n):
    info = worlds[n][2][0]
    rs = n * 700
    assert info["rs"]["bytes"] == {"reduce_scatter": 0, "all_gather": 0,
                                   "all_to_all": _legs(rs, n),
                                   "all_reduce": 0}
    assert info["rs"]["calls"]["all_to_all"] == 2   # payload and scales
    assert info["ag"]["bytes"]["all_gather"] == _legs(n * 613, n)
    want = {"reduce_scatter": 0, "all_gather": 0, "all_to_all": 0,
            "all_reduce": 0}
    for shape in LEAVES.values():
        size = int(np.prod(shape))
        if size < quantwire.MIN_QUANT_ELEMS:
            want["all_reduce"] += 4 * size
        else:
            padded = -(-size // n) * n
            want["all_to_all"] += _legs(padded, n)
            want["all_gather"] += _legs(padded, n)
    assert info["ar"]["bytes"] == want
    for r in worlds[n][2]:
        assert r["ar"] == info["ar"]


def _sine_loss(params, model_state, batch, rng):
    x, y = batch
    h = jnp.tanh(x @ params["w1"] + params["b1"])
    pred = h @ params["w2"] + params["b2"]
    return jnp.mean((pred - y) ** 2), (model_state, {})


_FP_LOSSES: dict = {}


def _jax_sine_fp(inputs, n):
    """The JAX replicated fp step of the recipe on a data=n mesh (once a
    world size)."""
    if n in _FP_LOSSES:
        return _FP_LOSSES[n]
    tx = optax.sgd(0.05, momentum=0.9, nesterov=True)
    params = {k: jnp.asarray(inputs[k]) for k in ("w1", "b1", "w2", "b2")}
    mesh = jax_mesh.make_mesh(jax_mesh.MeshSpec(data=n),
                              devices=jax.devices()[:n])
    state = jax_step.replicate_state(
        jax_step.TrainState.create(params, tx), mesh)
    step = jax_step.make_train_step(_sine_loss, tx, mesh, donate=False)
    losses = []
    for i in range(STEPS):
        state, m = step(state, (jnp.asarray(inputs["x"][i]),
                                jnp.asarray(inputs["y"][i])))
        losses.append(float(m["loss"]))
    _FP_LOSSES[n] = np.array(losses)
    return _FP_LOSSES[n]


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("update", ["replicated", "zero1"])
def test_int8_steps_track_the_jax_fp_step(worlds, n, update):
    inputs = worlds[n][0]
    l_fp = _jax_sine_fp(inputs, n)
    got = [np.array(r[f"losses_{update}"]) for r in worlds[n][2]]
    for other in got[1:]:
        np.testing.assert_array_equal(other, got[0])
    assert got[0][-1] < l_fp[0], "the int8 run did not train"
    assert np.abs(got[0] - l_fp).max() <= LOSS_GAP


def test_refusals(monkeypatch):
    def loss_fn(model, batch, seed):
        return torch.zeros(()), {}

    with pytest.raises(ValueError, match="int8-block.*adasum"):
        port_step.make_train_step(loss_fn, grad_reduce="adasum",
                                  wire_format="int8-block")
    with pytest.raises(ValueError, match="int8-block.*fusion_threshold"):
        port_step.make_train_step(loss_fn, fusion_threshold=4096,
                                  wire_format="int8-block")
    with pytest.raises(ValueError, match="unknown wire format"):
        port_step.make_train_step(loss_fn, wire_format="int5-wild")
    monkeypatch.setenv(quantwire.ENV_VAR, "int4")
    with pytest.raises(ValueError, match="unknown wire format"):
        quantwire.format_from_env()
    monkeypatch.delenv(quantwire.ENV_VAR)
    monkeypatch.setenv(quantwire.ENV_VAR_DCN, "int8-block")
    with pytest.raises(NotImplementedError, match="DCN.*item 12"):
        quantwire.resolve_legs()
    cfg = port_train.get_config("smoke").with_overrides(
        mesh={"data": 1}, dataset_kwargs={"synthetic_size": 64})
    with pytest.raises(NotImplementedError,
                       match="TPUFRAME_WIRE_FORMAT_DCN.*item 12"):
        port_train.build_harness(cfg, device="cpu")
    monkeypatch.delenv(quantwire.ENV_VAR_DCN)
    monkeypatch.setenv("TPUFRAME_HIER", "hier")
    with pytest.raises(NotImplementedError, match="TPUFRAME_HIER.*item 12"):
        port_train.build_harness(cfg, device="cpu")


def test_resolve_legs_env_over_default(monkeypatch):
    monkeypatch.delenv(quantwire.ENV_VAR, raising=False)
    monkeypatch.delenv(quantwire.ENV_VAR_DCN, raising=False)
    assert quantwire.resolve_legs() == (("fp", "default"), ("fp", "default"))
    monkeypatch.setenv(quantwire.ENV_VAR, " INT8-Block ")
    assert quantwire.resolve_legs()[0] == ("int8-block", "env")
    assert quantwire.FORMATS == jax_qw.FORMATS
    assert (quantwire.DEFAULT_BLOCK, quantwire.MIN_QUANT_ELEMS) == (
        jax_qw.DEFAULT_BLOCK, jax_qw.MIN_QUANT_ELEMS)
