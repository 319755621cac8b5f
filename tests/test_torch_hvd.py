"""``tpuframe_torch.parallel.hvd`` against ``tpuframe.parallel.hvd``.

Every verb runs in a gloo world of 2 and of 4 CPU processes (one
``LocalCluster`` launch a world size, each rank running every case of
``_WORKER``); the JAX package's verbs run under ``shard_map`` on a data
mesh of the first 2 or 4 of the conftest's virtual CPU devices, on the
same per-replica inputs (numpy, from a seed).  Rank ``r``'s result is held
to replica ``r``'s.  The cases are ``tests/test_hvd_ops.py``'s: Min/Max,
Product with zeros and negative values, op routing, ProcessSet members
reduced and others untouched, broadcast to a subset, rank validation,
alltoall with uniform splits, grouped_allreduce, the async round trip,
the object verbs with ragged payloads, and ``DistributedOptimizer`` with
Average, Sum, Adasum and fp16 compression after one optimizer step.

Tolerances:
  - Min, Max and broadcasts move values without arithmetic: bit-equal.
  - Sums, means and products in f32: 1e-6 relative and absolute (inputs
    are O(1)); XLA's and gloo's reductions may add in other orders, a
    few ulps apart.
  - Adasum: 1e-5 relative (the issue's bound for the butterfly against
    ``collectives.adasum``: its dots are f32 sums over the tensor).
  - ``DistributedOptimizer``: 1e-6 absolute on the parameters after one
    step, except with fp16 compression: gradients cross the wire in bf16
    (2^-8 relative steps) and the two packages round their bf16 sums in
    other places, so sgd's parameters (lr 0.1 x gradients up to ~4) may
    differ by lr x 4 x 2^-7 = 3.2e-3; adamw's first update is
    ``g / |g|`` elementwise and does not see the rounding.
  - ``DistributedOptimizer(compression="int8")`` on two ranks against the
    JAX scatter-then-gather pair (``quantwire.reduce_scatter_mean`` then
    ``all_gather`` under ``shard_map`` with ``check_vma=False``, with no
    size floor, then the optax update): 1e-6 absolute, as above.  (The
    JAX wrapper's own ``all_reduce_mean`` sees every leaf as already
    summed without vma types.)
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
from jax.sharding import Mesh, PartitionSpec as P  # noqa: E402

from tpuframe.parallel import hvd as jax_hvd  # noqa: E402
from tpuframe.parallel import quantwire as jax_qw  # noqa: E402
from tpuframe.utils import optim as jax_optim  # noqa: E402
from tpuframe.utils.config import TrainConfig as JaxTrainConfig  # noqa: E402
from tpuframe_torch.launch.launcher import LocalCluster  # noqa: E402
from tpuframe_torch.parallel import hvd  # noqa: E402
from tpuframe_torch.utils.config import TrainConfig  # noqa: E402
from tpuframe_torch.utils.optim import build_optimizer  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLDS = (2, 4)
RTOL = 1e-6
ADASUM_RTOL = 1e-5
OPT_ATOL = 1e-6
BF16_SGD_ATOL = 3.2e-3
OPT_CASES = [("sgd", "average"), ("sgd", "sum"), ("sgd", "adasum"),
             ("sgd", "fp16"), ("adamw", "average"), ("adamw", "adasum"),
             ("adamw", "fp16"), ("sgd", "int8")]


def _opt_cfg(opt: str) -> dict:
    return dict(name="hvd", model="none", optimizer=opt, base_lr=0.1,
                scale_lr_by_batch=False, schedule="constant",
                weight_decay=0.1 if opt == "adamw" else 0.0)


def _inputs(n: int) -> dict:
    rng = np.random.default_rng(n)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    prod = f(n, 3, 4)
    prod[0, 0, 1] = 0.0             # a log/exp product would break here
    prod[n - 1] *= -1.0
    return {"v": f(n, 3, 4), "prod": prod, "a": f(n, 5), "b": f(n, 2, 3),
            "gather": f(n, 2, 3), "a2a": f(n, 2 * n, 3),
            "w0": f(4, 3), "b0": f(3), "gw": f(n, 4, 3), "gb": f(n, 3)}


# One rank of the world: every case on its row of each input; arrays to
# <out>.<rank>.npz, messages and objects to <out>.<rank>.json.
_WORKER = r"""
import json, sys
import numpy as np
import torch
from tpuframe_torch.parallel import collectives, hvd
from tpuframe_torch.utils.config import TrainConfig
from tpuframe_torch.utils.optim import build_optimizer

inp, out, opt_cases = sys.argv[1], sys.argv[2], json.loads(sys.argv[3])
hvd.init(device="cpu")
n, r = hvd.size(), hvd.rank()
data = np.load(inp)
x = lambda k: torch.from_numpy(data[k][r].copy())
arrays, info = {}, {}


def refused(name, fn):
    try:
        fn()
        info[name] = None
    except (ValueError, NotImplementedError) as e:
        info[name] = f"{type(e).__name__}: {e}"


arrays["avg"] = hvd.allreduce(x("v"))
arrays["avg_flag"] = hvd.allreduce(x("v"), average=True)
arrays["sum"] = hvd.allreduce(x("v"), op=hvd.Sum)
arrays["sum_flag"] = hvd.allreduce(x("v"), average=False)
arrays["min"] = hvd.allreduce(x("v"), op=hvd.Min)
arrays["max"] = hvd.allreduce(x("v"), op=hvd.Max)
arrays["prod"] = hvd.allreduce(x("prod"), op=hvd.Product)
arrays["adasum"] = hvd.allreduce(x("v"), op=hvd.Adasum)
arrays["ps_avg"] = hvd.allreduce(x("v"),
                                 process_set=hvd.ProcessSet([1, n - 1]))
arrays["ps_sum"] = hvd.allreduce(x("v"), op=hvd.Sum,
                                 process_set=hvd.ProcessSet([0, n - 1]))
t = x("v")
hvd.broadcast_parameters({"t": t}, root_rank=1)
arrays["bcast"] = t
t = x("v")
hvd.broadcast_parameters([("t", t)], root_rank=n - 1,
                         process_set=hvd.ProcessSet([1, n - 1]))
arrays["ps_bcast"] = t
arrays["allgather"] = hvd.allgather(x("gather"))
arrays["alltoall"] = hvd.alltoall(x("a2a"))
arrays["alltoall_splits"] = hvd.alltoall(x("a2a"), splits=[2] * n)
ga, gb = hvd.grouped_allreduce([x("a"), x("b")])
arrays["grouped_a"], arrays["grouped_b"] = ga, gb
for name, op in (("async_sum", hvd.Sum), ("async_avg", hvd.Average),
                 ("async_max", hvd.Max), ("async_adasum", hvd.Adasum)):
    t = x("v")
    handle = hvd.allreduce_async_(t, op=op)
    got = hvd.synchronize(handle)
    assert got is t
    arrays[name] = got

refused("root_not_member", lambda: hvd.broadcast_parameters(
    {"t": x("v")}, root_rank=0, process_set=hvd.ProcessSet([1])))
refused("set_out_of_range", lambda: hvd.allreduce(
    x("v"), process_set=hvd.ProcessSet([0, n])))
refused("negative_rank", lambda: collectives.masked_allreduce(
    x("v"), collectives.process_group(), [-1, 0]))
refused("root_out_of_range", lambda: hvd.broadcast_parameters(
    {"t": x("v")}, root_rank=n))
refused("min_on_a_set", lambda: hvd.allreduce(
    x("v"), op=hvd.Min, process_set=hvd.ProcessSet([0])))
refused("ragged_splits", lambda: hvd.alltoall(
    x("a2a"), splits=[1] + [2] * (n - 2) + [3]))
refused("object_root_out_of_range", lambda: hvd.broadcast_object(1, n))

info["bobj"] = hvd.broadcast_object({"rank": r, "pad": "x" * 100 * r},
                                    root_rank=n - 1)
info["gobj"] = hvd.allgather_object("y" * (37 * r + 1))
info["world"] = [hvd.size(), hvd.rank(), hvd.local_rank(),
                 hvd.local_size(), hvd.is_primary()]
hvd.barrier()
info["join"] = hvd.join()


class Lin(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.weight = torch.nn.Parameter(torch.from_numpy(data["w0"].copy()))
        self.bias = torch.nn.Parameter(torch.from_numpy(data["b0"].copy()))


for opt, how in opt_cases:
    model = Lin()
    cfg = dict(name="hvd", model="none", optimizer=opt, base_lr=0.1,
               scale_lr_by_batch=False, schedule="constant",
               weight_decay=0.1 if opt == "adamw" else 0.0)
    kw = {"average": {}, "sum": {"op": hvd.Sum}, "adasum": {"op": hvd.Adasum},
          "fp16": {"compression": hvd.Compression.fp16},
          "int8": {"compression": "int8"}}[how]
    dopt = hvd.DistributedOptimizer(build_optimizer(TrainConfig(**cfg), model),
                                    **kw)
    model.weight.grad, model.bias.grad = x("gw"), x("gb")
    dopt.step()
    assert dopt.count == 1 and dopt.state_dict()["count"] == 1
    arrays[f"opt_{opt}_{how}_w"] = model.weight.detach()
    arrays[f"opt_{opt}_{how}_b"] = model.bias.detach()

# broadcast_optimizer_state: rank 0's moments and count on every rank
model = Lin()
inner = build_optimizer(TrainConfig(**{**cfg, "optimizer": "adamw"}), model)
inner.count = 5 + r
for m in inner.moments["mu"]:
    m.fill_(float(r + 1))
hvd.broadcast_optimizer_state(hvd.DistributedOptimizer(inner), root_rank=0)
info["opt_state"] = [inner.count, float(inner.moments["mu"][0].sum())]

np.savez(f"{out}.{r}.npz", **{k: v.numpy() for k, v in arrays.items()})
with open(f"{out}.{r}.json", "w") as f:
    json.dump(info, f)
hvd.shutdown()
"""


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """``{n: (inputs, [rank r's arrays], [rank r's json])}``."""
    root = tmp_path_factory.mktemp("hvd")
    out = {}
    for n in WORLDS:
        inputs = _inputs(n)
        path = root / f"in{n}.npz"
        np.savez(path, **inputs)
        stem = root / f"out{n}"
        LocalCluster(n, timeout=300, extra_env={"PYTHONPATH": REPO}).launch(
            [sys.executable, "-c", _WORKER, str(path), str(stem),
             json.dumps(OPT_CASES)])
        arrays = [dict(np.load(f"{stem}.{r}.npz")) for r in range(n)]
        infos = [json.loads(open(f"{stem}.{r}.json").read())
                 for r in range(n)]
        out[n] = (inputs, arrays, infos)
    return out


def _jax(n, fn, *xs):
    """``fn`` on each replica's row of ``xs`` under ``shard_map`` on a data
    mesh of ``n`` devices; the outputs stacked by replica."""
    mesh = Mesh(np.asarray(jax.devices()[:n]), ("data",))

    def body(*blocks):
        outs = fn(*(b[0] for b in blocks))
        return tuple(o[None] for o in outs)

    f = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=P("data"),
                              out_specs=P("data")))
    return [np.asarray(o) for o in f(*xs)]


def _got(worlds, n, key):
    return np.stack([a[key] for a in worlds[n][1]])


# port key -> (JAX verb on one replica's row, input key)
_VERBS = {
    "avg": (lambda t: jax_hvd.allreduce(t), "v"),
    "avg_flag": (lambda t: jax_hvd.allreduce(t, average=True), "v"),
    "sum": (lambda t: jax_hvd.allreduce(t, op=jax_hvd.Sum), "v"),
    "sum_flag": (lambda t: jax_hvd.allreduce(t, average=False), "v"),
    "min": (lambda t: jax_hvd.allreduce(t, op=jax_hvd.Min), "v"),
    "max": (lambda t: jax_hvd.allreduce(t, op=jax_hvd.Max), "v"),
    "prod": (lambda t: jax_hvd.allreduce(t, op=jax_hvd.Product), "prod"),
    "allgather": (lambda t: jax_hvd.allgather(t), "gather"),
    "alltoall": (lambda t: jax_hvd.alltoall(t), "a2a"),
    "async_sum": (lambda t: jax_hvd.synchronize(
        jax_hvd.allreduce_async_(t, op=jax_hvd.Sum)), "v"),
    "async_avg": (lambda t: jax_hvd.synchronize(
        jax_hvd.allreduce_async_(t)), "v"),
    "async_max": (lambda t: jax_hvd.allreduce(t, op=jax_hvd.Max), "v"),
}
_EXACT = {"min", "max", "allgather", "alltoall", "async_max"}


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("key", sorted(_VERBS))
def test_verb_matches_the_jax_verb(worlds, n, key):
    fn, src = _VERBS[key]
    (want,) = _jax(n, lambda t: (fn(t),), worlds[n][0][src])
    got = _got(worlds, n, key)
    assert got.shape == want.shape
    if key in _EXACT:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL)


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("key", ["adasum", "async_adasum"])
def test_adasum_op_matches_the_jax_butterfly(worlds, n, key):
    (want,) = _jax(n, lambda t: (jax_hvd.allreduce(t, op=jax_hvd.Adasum),),
                   worlds[n][0]["v"])
    np.testing.assert_allclose(_got(worlds, n, key), want,
                               rtol=ADASUM_RTOL, atol=1e-6)


@pytest.mark.parametrize("n", WORLDS)
def test_product_keeps_zeros_and_signs(worlds, n):
    got = _got(worlds, n, "prod")
    want = np.prod(worlds[n][0]["prod"], axis=0)
    assert got[0, 0, 1] == 0.0
    np.testing.assert_array_equal(np.sign(got[0]), np.sign(want))
    for r in range(n):
        np.testing.assert_array_equal(got[r], got[0])


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("key,ranks,op", [
    ("ps_avg", lambda n: [1, n - 1], None),
    ("ps_sum", lambda n: [0, n - 1], "sum")])
def test_process_set_reduces_members_and_leaves_the_rest(worlds, n, key,
                                                         ranks, op):
    members = ranks(n)
    ps = jax_hvd.ProcessSet(members)
    kw = {"op": jax_hvd.Sum} if op else {}
    x = worlds[n][0]["v"]
    (want,) = _jax(n, lambda t: (jax_hvd.allreduce(t, process_set=ps, **kw),),
                   x)
    got = _got(worlds, n, key)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL)
    for r in range(n):
        if r not in members:
            np.testing.assert_array_equal(got[r], x[r])


@pytest.mark.parametrize("n", WORLDS)
def test_broadcast_parameters_in_place(worlds, n):
    x = worlds[n][0]["v"]
    (want,) = _jax(n, lambda t: (jax_hvd.broadcast_parameters(
        t, root_rank=1),), x)
    np.testing.assert_array_equal(_got(worlds, n, "bcast"), want)
    members = sorted({1, n - 1})
    ps = jax_hvd.ProcessSet(members)
    (want,) = _jax(n, lambda t: (jax_hvd.broadcast_parameters(
        t, root_rank=n - 1, process_set=ps),), x)
    got = _got(worlds, n, "ps_bcast")
    np.testing.assert_array_equal(got, want)
    for r in range(n):
        np.testing.assert_array_equal(got[r], x[n - 1] if r in members
                                      else x[r])


@pytest.mark.parametrize("n", WORLDS)
def test_alltoall_with_uniform_splits_and_grouped_allreduce(worlds, n):
    np.testing.assert_array_equal(_got(worlds, n, "alltoall_splits"),
                                  _got(worlds, n, "alltoall"))
    inputs = worlds[n][0]
    want = _jax(n, lambda a, b: tuple(jax_hvd.grouped_allreduce([a, b])),
                inputs["a"], inputs["b"])
    for key, w in zip(("grouped_a", "grouped_b"), want):
        np.testing.assert_allclose(_got(worlds, n, key), w, rtol=RTOL,
                                   atol=RTOL)


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("case,match", [
    ("root_not_member", "ValueError: root 0 is not a member"),
    ("set_out_of_range", "ValueError: ranks .* out of range"),
    ("negative_rank", r"ValueError: ranks \[-1\] out of range"),
    ("root_out_of_range", "ValueError: ranks .* out of range"),
    ("min_on_a_set", "NotImplementedError: process_set"),
    ("ragged_splits", "NotImplementedError: alltoall with splits"),
    ("object_root_out_of_range", "ValueError: broadcast_object root"),
])
def test_invalid_ranks_and_splits_raise(worlds, n, case, match):
    import re

    for info in worlds[n][2]:
        assert info[case] is not None and re.match(match, info[case]), \
            info[case]


@pytest.mark.parametrize("n", WORLDS)
def test_object_verbs_and_the_world(worlds, n):
    infos = worlds[n][2]
    for r, info in enumerate(infos):
        assert info["bobj"] == {"rank": n - 1, "pad": "x" * 100 * (n - 1)}
        assert info["gobj"] == ["y" * (37 * i + 1) for i in range(n)]
        # one host: local rank is the rank
        assert info["world"] == [n, r, r, n, r == 0]
        assert info["join"] == -1
        assert info["opt_state"] == [5, float(4 * 3 * 1)]


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("opt,how", [c for c in OPT_CASES
                                     if c[1] != "int8"])
def test_distributed_optimizer_step_matches_the_jax_wrapper(worlds, n, opt,
                                                            how):
    inputs = worlds[n][0]
    jcfg = JaxTrainConfig(**_opt_cfg(opt))
    params = {"weight": jnp.asarray(inputs["w0"]),
              "bias": jnp.asarray(inputs["b0"])}
    kw = {"average": {}, "sum": {"op": jax_hvd.Sum},
          "adasum": {"op": jax_hvd.Adasum},
          "fp16": {"compression": jax_hvd.Compression.fp16}}[how]
    tx = jax_hvd.DistributedOptimizer(jax_optim.build_optimizer(jcfg, params),
                                      **kw)

    def one_step(gw, gb):
        upd, _ = tx.update({"weight": gw, "bias": gb}, tx.init(params),
                           params)
        new = optax.apply_updates(params, upd)
        return new["weight"], new["bias"]

    want_w, want_b = _jax(n, one_step, inputs["gw"], inputs["gb"])
    atol = BF16_SGD_ATOL if (how, opt) == ("fp16", "sgd") else OPT_ATOL
    np.testing.assert_allclose(_got(worlds, n, f"opt_{opt}_{how}_w"), want_w,
                               rtol=0, atol=atol)
    np.testing.assert_allclose(_got(worlds, n, f"opt_{opt}_{how}_b"), want_b,
                               rtol=0, atol=atol)
    # the step moved the parameters
    assert np.abs(want_w[0] - inputs["w0"]).max() > 1e-3


def test_distributed_optimizer_int8_matches_the_jax_pair(worlds):
    n = 2
    inputs = worlds[n][0]
    jcfg = JaxTrainConfig(**_opt_cfg("sgd"))
    params = {"weight": jnp.asarray(inputs["w0"]),
              "bias": jnp.asarray(inputs["b0"])}
    tx = jax_optim.build_optimizer(jcfg, params)

    def mean(g):
        flat = jnp.pad(g.reshape(-1), (0, (-g.size) % n))
        full = jax_qw.all_gather(jax_qw.reduce_scatter_mean(flat, "data"),
                                 "data")
        return full[:g.size].reshape(g.shape)

    def one_step(gw, gb):
        grads = {"weight": mean(gw), "bias": mean(gb)}
        upd, _ = tx.update(grads, tx.init(params), params)
        new = optax.apply_updates(params, upd)
        return new["weight"], new["bias"]

    mesh = Mesh(np.asarray(jax.devices()[:n]), ("data",))
    f = jax.jit(jax.shard_map(
        lambda gw, gb: tuple(o[None] for o in one_step(gw[0], gb[0])),
        mesh=mesh, in_specs=P("data"), out_specs=P("data"),
        check_vma=False))
    want_w, want_b = (np.asarray(o) for o in f(inputs["gw"], inputs["gb"]))
    np.testing.assert_allclose(_got(worlds, n, "opt_sgd_int8_w"), want_w,
                               rtol=0, atol=OPT_ATOL)
    np.testing.assert_allclose(_got(worlds, n, "opt_sgd_int8_b"), want_b,
                               rtol=0, atol=OPT_ATOL)
    assert np.abs(want_w[0] - inputs["w0"]).max() > 1e-3


def test_average_and_op_conflict():
    with pytest.raises(ValueError, match="not both"):
        hvd.allreduce(torch.ones(3), average=True, op=hvd.Sum)


def test_verbs_are_the_identity_without_a_world():
    t = torch.arange(4.0)
    for op in (hvd.Average, hvd.Sum, hvd.Min, hvd.Max, hvd.Product,
               hvd.Adasum):
        torch.testing.assert_close(hvd.allreduce(t, op=op), t, rtol=0,
                                   atol=0)
    assert hvd.size() == 1 and hvd.rank() == 0 and hvd.is_primary()
    assert hvd.allgather_object(3) == [3]
    assert hvd.broadcast_object("x") == "x"
    assert hvd.join() == -1
    torch.testing.assert_close(hvd.synchronize(hvd.allreduce_async_(
        t.clone(), op=hvd.Sum)), t, rtol=0, atol=0)


def test_distributed_optimizer_refusals():
    model = torch.nn.Linear(2, 2)
    opt = build_optimizer(TrainConfig(**_opt_cfg("sgd")), model)
    with pytest.raises(ValueError, match="int8.*average=True"):
        hvd.DistributedOptimizer(opt, compression="int8", average=False)
    with pytest.raises(ValueError, match="compression"):
        hvd.DistributedOptimizer(opt, op=hvd.Adasum, compression="int8")
    with pytest.raises(ValueError, match="compression"):
        hvd.DistributedOptimizer(opt, op=hvd.Adasum,
                                 compression=hvd.Compression.fp16)
    with pytest.raises(ValueError, match="not both"):
        hvd.DistributedOptimizer(opt, average=False, op=hvd.Average)
    with pytest.raises(ValueError, match="Average/Sum/Adasum"):
        hvd.DistributedOptimizer(opt, op=hvd.Min)


def test_process_set_validation_and_compression_namespace():
    with pytest.raises(ValueError):
        hvd.ProcessSet([])
    with pytest.raises(ValueError):
        hvd.ProcessSet([-1, 2])
    assert hvd.ProcessSet([3, 1, 3, 2]).ranks == (1, 2, 3)
    assert hvd.Compression.fp16 == jax_hvd.Compression.fp16 == "bf16"
    assert hvd.Compression.none is None
    model = torch.nn.Linear(2, 2)
    dopt = hvd.DistributedOptimizer(
        build_optimizer(TrainConfig(**_opt_cfg("sgd")), model),
        compression=hvd.Compression.fp16)
    assert dopt.state_dict() == dopt.inner.state_dict()


def test_build_introspection_answers_from_torch_distributed():
    import torch.distributed as dist

    assert hvd.nccl_built() == dist.is_nccl_available()
    assert hvd.gloo_built() == dist.is_gloo_available()
    assert hvd.mpi_built() == dist.is_mpi_available()
    assert hvd.cuda_built() == (torch.version.cuda is not None)
    assert not hvd.mpi_enabled()
