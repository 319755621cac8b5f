"""Adasum in tpuframe_torch against the JAX package's butterfly.

``collectives.adasum_`` runs in gloo worlds of 2 and 4 CPU processes (and
of 3, which must refuse it), launched once each and in parallel; the JAX
package's ``collectives.adasum`` runs under ``shard_map`` on a data mesh
of the first 2 or 4 virtual CPU devices, on the same per-replica leaves.
Then ``make_train_step(..., grad_reduce="adasum")`` against the JAX
``make_train_step(..., grad_reduce="adasum")`` on data=2 and data=4
meshes (``tests/test_hvd_ops.py``'s ``TestAdasumStep`` model: a linear
map, mean squared error, plain SGD at 0.1), two steps, with and without
``accum_steps=2``.

Tolerances:
  - The butterfly and the steps in f32: 1e-5 relative (each stage's dots
    are f32 sums over the leaf, added in another order by XLA), 1e-6
    absolute for entries near zero.  A bf16 leaf is rounded to bf16 at
    the end: one bf16 step (2^-8 relative).
  - Exact, by construction of the combine: identical vectors give the
    vector (each coefficient is exactly 1/2), vectors with disjoint
    supports give their sum, a zero vector contributes nothing, every
    rank ends with the same bits (both ranks of a pair multiply the same
    pairs and add in the same order), and identical shards reproduce the
    single-process step.
"""

import json
import os
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
from jax.sharding import Mesh, PartitionSpec as P  # noqa: E402

from tpuframe.parallel import collectives as jax_collectives  # noqa: E402
from tpuframe.parallel import mesh as jax_mesh  # noqa: E402
from tpuframe.parallel import step as jax_step  # noqa: E402
from tpuframe_torch.launch.launcher import LocalCluster  # noqa: E402
from tpuframe_torch.parallel import collectives  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLDS = (2, 4)
RTOL, ATOL = 1e-5, 1e-6
BF16_RTOL = 2.0 ** -8
LEAF_SHAPES = [(4, 3), (7,), (2, 2, 5)]
CASES = ("random", "identical", "orthogonal", "zero", "bf16")
BATCH, STEPS = 16, 2


def _leaves(n: int) -> dict:
    """``{case_i: [n, *shape]}``: leaf ``i`` of each replica."""
    rng = np.random.default_rng(10 + n)
    out = {}
    for i, shape in enumerate(LEAF_SHAPES):
        def f():
            return rng.standard_normal((n, *shape)).astype(np.float32)

        out[f"random_{i}"] = f()
        out[f"identical_{i}"] = np.repeat(f()[:1], n, axis=0)
        # replica r nonzero only where the flat index is r mod n: disjoint
        ortho = f()
        flat = ortho.reshape(n, -1)
        for r in range(n):
            flat[r, np.arange(flat.shape[1]) % n != r] = 0.0
        out[f"orthogonal_{i}"] = ortho
        zero = f()
        zero[1] = 0.0
        out[f"zero_{i}"] = zero
        out[f"bf16_{i}"] = f()
    rng = np.random.default_rng(99)
    out["w0"] = rng.standard_normal((6, 2)).astype(np.float32)
    out["x"] = rng.standard_normal((STEPS, BATCH, 6)).astype(np.float32)
    out["y"] = rng.standard_normal((STEPS, BATCH, 2)).astype(np.float32)
    return out


# One rank: the butterfly on every case's leaves, then the train steps.
_WORKER = r"""
import json, sys
import numpy as np
import torch
from tpuframe_torch.parallel import collectives, hvd
from tpuframe_torch.parallel import step as step_lib
from tpuframe_torch.utils.config import TrainConfig
from tpuframe_torch.utils.optim import build_optimizer

inp, out, cases, n_leaves = (sys.argv[1], sys.argv[2], json.loads(sys.argv[3]),
                             int(sys.argv[4]))
hvd.init(device="cpu")
n, r = hvd.size(), hvd.rank()
grp = collectives.process_group()
if n & (n - 1):
    try:
        collectives.adasum_([torch.ones(3)], grp)
        msg = None
    except ValueError as e:
        msg = str(e)
    with open(f"{out}.{r}.json", "w") as f:
        json.dump(msg, f)
    sys.exit(0)
data = np.load(inp)
arrays = {}
for case in cases:
    dtype = torch.bfloat16 if case == "bf16" else torch.float32
    ts = [torch.from_numpy(data[f"{case}_{i}"][r].copy()).to(dtype)
          for i in range(n_leaves)]
    collectives.adasum_(ts, grp)
    for i, t in enumerate(ts):
        assert t.dtype == dtype
        arrays[f"{case}_{i}"] = t.float()


class Lin(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.from_numpy(data["w0"].copy()))


def loss_fn(model, batch, seed):
    return ((batch["x"] @ model.w - batch["y"]) ** 2).mean(), {}


cfg = TrainConfig(name="adasum", model="none", optimizer="sgd", momentum=0.0,
                  base_lr=0.1, scale_lr_by_batch=False, schedule="constant")


def steps(accum, distributed=True, rows=None):
    model = Lin()
    state = step_lib.TrainState(model, build_optimizer(cfg, model))
    step = step_lib.make_train_step(loss_fn, accum_steps=accum,
                                    grad_reduce="adasum",
                                    distributed=distributed)
    m = data["x"].shape[1] // n
    rows = rows if rows is not None else slice(r * m, (r + 1) * m)
    losses, ws = [], []
    for i in range(data["x"].shape[0]):
        batch = {"x": torch.from_numpy(data["x"][i][rows].copy()),
                 "y": torch.from_numpy(data["y"][i][rows].copy())}
        losses.append(float(step(state, batch)["loss"]))
        ws.append(model.w.detach().clone())
    return np.array(losses), torch.stack(ws)


for accum in (1, 2):
    arrays[f"losses_{accum}"], arrays[f"w_{accum}"] = steps(accum)
# every rank trains on rows 0..3: Adasum of identical gradients is the
# identity, so this is the single-process step
same = slice(0, 4)
arrays["same_losses"], arrays["same_w"] = steps(1, rows=same)
arrays["solo_losses"], arrays["solo_w"] = steps(1, False, rows=same)
np.savez(f"{out}.{r}.npz", **{k: np.asarray(v) for k, v in arrays.items()})
hvd.shutdown()
"""


def _launch(root, n):
    inputs = _leaves(n)
    path = root / f"in{n}.npz"
    np.savez(path, **inputs)
    stem = root / f"out{n}"
    LocalCluster(n, timeout=300, extra_env={"PYTHONPATH": REPO}).launch(
        [sys.executable, "-c", _WORKER, str(path), str(stem),
         json.dumps(CASES), str(len(LEAF_SHAPES))])
    if n & (n - 1):
        return [json.loads(open(f"{stem}.{r}.json").read())
                for r in range(n)]
    return inputs, [dict(np.load(f"{stem}.{r}.npz")) for r in range(n)]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    root = tmp_path_factory.mktemp("adasum")
    with ThreadPoolExecutor(3) as pool:
        futures = {n: pool.submit(_launch, root, n) for n in (*WORLDS, 3)}
        return {n: f.result() for n, f in futures.items()}


def _mesh(n):
    return Mesh(np.asarray(jax.devices()[:n]), ("data",))


def _jax_adasum(n, leaves, dtype=jnp.float32):
    """``collectives.adasum`` of each replica's leaves, by replica."""
    def body(*blocks):
        outs = jax_collectives.adasum([b[0].astype(dtype) for b in blocks],
                                      "data")
        return tuple(o.astype(jnp.float32)[None] for o in outs)

    f = jax.jit(jax.shard_map(body, mesh=_mesh(n), in_specs=P("data"),
                              out_specs=P("data")))
    return [np.asarray(o) for o in f(*leaves)]


def _got(worlds, n, key):
    return np.stack([a[key] for a in worlds[n][1]])


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("case", CASES)
def test_butterfly_matches_the_jax_butterfly(worlds, n, case):
    inputs = worlds[n][0]
    leaves = [inputs[f"{case}_{i}"] for i in range(len(LEAF_SHAPES))]
    dtype = jnp.bfloat16 if case == "bf16" else jnp.float32
    want = _jax_adasum(n, leaves, dtype)
    for i, w in enumerate(want):
        got = _got(worlds, n, f"{case}_{i}")
        if case == "bf16":
            np.testing.assert_allclose(got, w, rtol=BF16_RTOL, atol=ATOL)
        else:
            np.testing.assert_allclose(got, w, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("n", WORLDS)
def test_identical_vectors_are_the_identity(worlds, n):
    for i in range(len(LEAF_SHAPES)):
        row = worlds[n][0][f"identical_{i}"][0]
        for got in _got(worlds, n, f"identical_{i}"):
            np.testing.assert_array_equal(got, row)


@pytest.mark.parametrize("n", WORLDS)
def test_orthogonal_vectors_sum(worlds, n):
    for i in range(len(LEAF_SHAPES)):
        want = worlds[n][0][f"orthogonal_{i}"].sum(axis=0)
        for got in _got(worlds, n, f"orthogonal_{i}"):
            np.testing.assert_array_equal(got, want)


def _pair(a, b):
    dot, na, nb = float(np.vdot(a, b)), float(np.vdot(a, a)), \
        float(np.vdot(b, b))
    ca = dot / (2 * na) if na > 0 else 0.0
    cb = dot / (2 * nb) if nb > 0 else 0.0
    return (1 - ca) * a + (1 - cb) * b


@pytest.mark.parametrize("n", WORLDS)
def test_zero_contribution_is_handled(worlds, n):
    """A replica's zero leaf: no NaN, and adasum(0, b) == b at its pair,
    so the result is the float64 butterfly's."""
    for i in range(len(LEAF_SHAPES)):
        rows = [r.astype(np.float64) for r in worlds[n][0][f"zero_{i}"]]
        k = 1
        while k < n:
            rows = [_pair(rows[j], rows[j ^ k]) for j in range(n)]
            k *= 2
        got = _got(worlds, n, f"zero_{i}")
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got[0], rows[0], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("n", WORLDS)
def test_every_rank_ends_with_the_same_bits(worlds, n):
    for key in worlds[n][1][0]:
        got = _got(worlds, n, key)
        for r in range(1, n):
            np.testing.assert_array_equal(got[r], got[0], err_msg=key)


def test_a_world_of_three_raises(worlds):
    for msg in worlds[3]:
        assert msg == ("adasum butterfly needs a power-of-two replica "
                       "count, got 3")


def _jax_steps(n, inputs, accum):
    def loss_fn(params, model_state, batch, rng):
        pred = batch["x"] @ params["w"]
        return jnp.mean((pred - batch["y"]) ** 2), (model_state, {})

    tx = optax.sgd(0.1)
    state = jax_step.TrainState.create({"w": jnp.asarray(inputs["w0"])}, tx)
    mesh = jax_mesh.make_mesh(jax_mesh.MeshSpec(data=n),
                              devices=jax.devices()[:n])
    step = jax_step.make_train_step(loss_fn, tx, mesh, donate=False,
                                    grad_reduce="adasum", accum_steps=accum)
    losses, ws = [], []
    for i in range(STEPS):
        state, m = step(state, {"x": jnp.asarray(inputs["x"][i]),
                                "y": jnp.asarray(inputs["y"][i])})
        losses.append(float(m["loss"]))
        ws.append(np.asarray(state.params["w"]))
    return np.array(losses), np.stack(ws)


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("accum", [1, 2])
def test_adasum_steps_match_the_jax_step(worlds, n, accum):
    inputs, ranks = worlds[n]
    want_losses, want_w = _jax_steps(n, inputs, accum)
    for arrays in ranks:
        np.testing.assert_allclose(arrays[f"losses_{accum}"], want_losses,
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(arrays[f"w_{accum}"], want_w, rtol=RTOL,
                                   atol=ATOL)
    # the steps moved the weights
    assert np.abs(want_w[-1] - inputs["w0"]).max() > 1e-2


@pytest.mark.parametrize("n", WORLDS)
def test_identical_shards_equal_the_single_process_step(worlds, n):
    for arrays in worlds[n][1]:
        np.testing.assert_array_equal(arrays["same_w"], arrays["solo_w"])
        np.testing.assert_array_equal(arrays["same_losses"],
                                      arrays["solo_losses"])


def test_world_of_one_is_the_identity():
    ts = [torch.randn(3, 4), torch.randn(5).to(torch.bfloat16)]
    want = [t.clone() for t in ts]
    collectives.adasum_(ts, None)
    for t, w in zip(ts, want):
        assert torch.equal(t, w)


def test_combine_defining_properties():
    """``adasum_combine`` alone: identity on equal inputs, the sum on
    orthogonal ones, the other input against a zero vector, the same bits
    with the operands swapped, the f64 formula otherwise, and the dtype
    of its first operand."""
    rng = np.random.default_rng(5)
    a = torch.from_numpy(rng.standard_normal(257).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(257).astype(np.float32))
    assert torch.equal(collectives.adasum_combine(a, a), a)
    ea, eb = a.clone(), b.clone()
    ea[1::2], eb[::2] = 0.0, 0.0
    assert torch.equal(collectives.adasum_combine(ea, eb), ea + eb)
    assert torch.equal(collectives.adasum_combine(torch.zeros(257), b), b)
    assert torch.equal(collectives.adasum_combine(a, b),
                       collectives.adasum_combine(b, a))
    np.testing.assert_allclose(collectives.adasum_combine(a, b).numpy(),
                               _pair(a.double().numpy(), b.double().numpy()),
                               rtol=RTOL, atol=ATOL)
    assert collectives.adasum_combine(a.bfloat16(), b).dtype == torch.bfloat16


def test_the_trainer_takes_adasum_with_a_local_loss():
    """``grad_reduce="adasum"`` passes the trainer's refusals; its LM loss
    is local (no group), and ``padded_docs`` is refused with it, as in the
    JAX harness; any other reduction raises the JAX step's ValueError."""
    from tpuframe_torch import train as port_train
    from tpuframe_torch.parallel import step as port_step

    cfg = port_train.get_config("lm_smoke").with_overrides(
        mesh={"data": 1, "seq": 1}, grad_reduce="adasum")
    port_train._refuse_unported(cfg, 1)
    assert port_train._lm_reduce(cfg) is None
    padded = cfg.with_overrides(dataset_kwargs={"padded_docs": True})
    with pytest.raises(ValueError, match="padded_docs.*adasum"):
        port_train._lm_reduce(padded)
    with pytest.raises(ValueError, match="grad_reduce must be"):
        port_step.make_train_step(lambda *a: None, grad_reduce="nope")
