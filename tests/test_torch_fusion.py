"""``tpuframe_torch.parallel.fusion`` against ``tpuframe.parallel.fusion``.

The bucket census and the threshold's resolution run in this process
against the JAX functions on the same inputs.  The reductions run in gloo
worlds of 2 and 4 CPU processes (one ``LocalCluster`` launch a world
size, each rank running every case of ``_WORKER``); the JAX
``fused_psum``/``staged_psum`` run under ``shard_map`` on a data mesh of
the first 2 or 4 of the conftest's virtual CPU devices, on the same
per-replica inputs (numpy, from a seed).

The data are integer-valued (f32, f64 and bf16 leaves; small integers
and their means over 2 or 4 ranks are exact in every dtype), so every
sum is exact whatever order gloo's ring adds in, and the bucketed,
staged, per-tensor and JAX results are held bit-equal.  The step-level
cases (accumulation, BatchNorm statistics) take float data: over 2 ranks
each element is ``a + b`` and the results are bit-equal; over 4 ranks
gloo's ring may add an element in an order that depends on its offset in
the buffer, so those are held to 1e-6 relative.
"""

import functools
import json
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh, PartitionSpec as P  # noqa: E402

from tpuframe.parallel import fusion as jax_fusion  # noqa: E402
from tpuframe_torch import models as port_models  # noqa: E402
from tpuframe_torch.launch.launcher import LocalCluster  # noqa: E402
from tpuframe_torch.parallel import fusion  # noqa: E402
from tpuframe_torch.parallel import step as port_step  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLDS = (2, 4)
THRESHOLDS = (0, 512, 1 << 20)
# The reduced leaves: (shape, dtype); the bf16 leaf sits between f32 ones
# so that a dtype change closes a bucket mid-list.
LEAVES = [((3, 4), "float32"), ((5,), "float32"), ((40,), "float32"),
          ((2, 3), "bfloat16"), ((7,), "float32"), ((200,), "float32"),
          ((6,), "float64"), ((1,), "float32")]
STEP_RTOL = {2: 0.0, 4: 1e-6}


def _inputs(n: int) -> dict:
    """Per-rank integer-valued leaves, stored as f32 (npz has no bf16)."""
    rng = np.random.default_rng(n)
    return {f"l{i}": rng.integers(-8, 9, (n, *shape)).astype(np.float32)
            for i, (shape, _) in enumerate(LEAVES)}


_WORKER = r"""
import json, os, sys
import numpy as np
import torch
import torch.distributed as dist
from tpuframe_torch.obs import spmd_check
from tpuframe_torch.parallel import collectives, fusion, hvd
from tpuframe_torch.parallel import step as port_step
from tpuframe_torch.utils.config import TrainConfig
from tpuframe_torch.utils.optim import build_optimizer

inp, out = sys.argv[1], sys.argv[2]
leaf_dtypes = json.loads(sys.argv[3])
thresholds = json.loads(sys.argv[4])
hvd.init(device="cpu")
n, r = hvd.size(), hvd.rank()
grp = collectives.group()
data = np.load(inp)
DT = {"float32": torch.float32, "float64": torch.float64,
      "bfloat16": torch.bfloat16}


def leaves():
    return [torch.from_numpy(data[f"l{i}"][r].copy()).to(DT[d])
            for i, d in enumerate(leaf_dtypes)]


calls = [0]
_real = dist.all_reduce


sizes = []


def _counting(*a, **k):
    calls[0] += 1
    sizes.append(a[0].numel())
    return _real(*a, **k)


dist.all_reduce = _counting
arrays, info = {}, {"calls": {}}


def keep(name, ts):
    for i, t in enumerate(ts):
        arrays[f"{name}/{i}"] = t.double().numpy()


def counted(name, fn):
    calls[0] = 0
    fn()
    info["calls"][name] = calls[0]


ts = leaves()
counted("per_sum", lambda: [t.copy_(collectives.allreduce(t, grp, "sum"))
                            for t in ts])
keep("per_sum", ts)
ts = leaves()
counted("per_mean", lambda: collectives.mean_(ts, grp))
keep("per_mean", ts)
for th in thresholds:
    for mean in (False, True):
        ts = leaves()
        name = f"fused_{'mean' if mean else 'sum'}_{th}"
        counted(name, lambda: fusion.fused_sum_(ts, grp, threshold_bytes=th,
                                                mean=mean))
        keep(name, ts)


class Leaves(torch.nn.Module):
    # one parameter a leaf, registered in list order
    def __init__(self, extra=()):
        super().__init__()
        self.ps = torch.nn.ParameterList(
            [torch.nn.Parameter(torch.zeros_like(t)) for t in leaves()])
        for name in extra:
            self.register_parameter(name, torch.nn.Parameter(torch.ones(3)))


def staged(th, model, loss_of):
    reducer = fusion.StagedReducer(model, grp, threshold_bytes=th)
    reducer.arm()
    calls[0] = 0
    loss_of(model).backward()
    before = calls[0]
    reducer.finish()
    reducer.remove()
    return reducer, before


def linear_loss(model):
    # d loss / d p_i = this rank's leaf i
    return sum((p * t).sum() for p, t in zip(model.ps, leaves()))


for th in thresholds:
    model = Leaves()
    reducer, before = staged(th, model, linear_loss)
    keep(f"staged_{th}", [p.grad for p in model.ps])
    info[f"staged_{th}"] = {"early": reducer.early, "calls_in_backward":
                            before, "census": reducer.census()}

# gradients that arrive against the plan's order (the first registered
# parameter's term is built last, so its gradient comes first): the
# buckets still start in plan order
model = Leaves()
sizes.clear()
reducer, _ = staged(0, model, lambda m: sum(
    (p * t).sum() for p, t in reversed(list(zip(m.ps, leaves())))))
info["reversed_sizes"] = list(sizes)
info["plan_sizes"] = [sum(reducer.params[i].numel() for i in b)
                      for b in reducer.buckets]
keep("reversed", [p.grad for p in model.ps])

# a parameter with no gradient in this backward: zeros on the wire, .grad
# stays None, and no rank hangs
model = Leaves(extra=("unused",))
reducer, _ = staged(1 << 20, model, linear_loss)
info["unused"] = {"grad_is_none": model.unused.grad is None,
                  "n_buckets": len(reducer.buckets)}
keep("unused", [p.grad for p in model.ps])


# a parameter used twice in the forward: its hook fires once, after both
# contributions
class Tied(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.zeros(5))
        self.b = torch.nn.Parameter(torch.zeros(5))


model = Tied()
fired = []
model.w.register_post_accumulate_grad_hook(lambda p: fired.append(1))
a = torch.from_numpy(data["l1"][r].copy())
reducer, _ = staged(1 << 20, model, lambda m: (m.w * a).sum()
                    + (m.w * 2 * a).sum() + (m.b * a).sum())
info["tied_fired"] = len(fired)
keep("tied", [model.w.grad, model.b.grad])

# accum_steps=2 through the step: one reduction, at the end
torch.manual_seed(0)     # the same init on every rank
init = torch.nn.Sequential(torch.nn.Linear(6, 4), torch.nn.BatchNorm1d(4),
                           torch.nn.Linear(4, 3)).state_dict()
x = torch.from_numpy(np.random.default_rng(r).standard_normal(
    (8, 6)).astype(np.float32))
y = torch.from_numpy(np.arange(8) % 3)


def loss_fn(model, batch, seed):
    logits = model(batch["x"])
    loss = torch.nn.functional.cross_entropy(logits, batch["y"])
    acc = (logits.argmax(-1) == batch["y"]).float().mean()
    return loss, {"accuracy": acc}


cfg = TrainConfig(name="f", model="none", optimizer="sgd", base_lr=0.1,
                  scale_lr_by_batch=False, schedule="constant")
for th in (None, 64, 1 << 20):
    model = torch.nn.Sequential(torch.nn.Linear(6, 4),
                                torch.nn.BatchNorm1d(4),
                                torch.nn.Linear(4, 3))
    model.load_state_dict(init)
    state = port_step.TrainState(model, build_optimizer(cfg, model))
    step = port_step.make_train_step(loss_fn, accum_steps=2,
                                     fusion_threshold=th)
    calls[0] = 0
    m = step(state, {"x": x, "y": y})
    stats = [b for b in model.buffers() if b.is_floating_point()]
    info[f"accum_{th}"] = {
        "calls": calls[0], "loss": float(m["loss"]),
        "want": None if th is None else (
            fusion.bucket_census([p for _, p in fusion.plan_params(model)],
                                 th)["n_buckets"]
            + fusion.bucket_census(stats + [m["loss"], m["accuracy"]],
                                   th)["n_buckets"])}
    keep(f"accum_{th}", list(model.state_dict().values()))

# hvd.DistributedOptimizer: the knob routes its reduction through the
# fusion buffers
for how in ("average", "sum", "fp16"):
    for knob in (None, "512"):
        if knob is None:
            os.environ.pop(fusion.ENV_VAR, None)
        else:
            os.environ[fusion.ENV_VAR] = knob
        model = Leaves()
        kw = {"average": {}, "sum": {"op": hvd.Sum},
              "fp16": {"compression": hvd.Compression.fp16}}[how]
        opt = hvd.DistributedOptimizer(build_optimizer(cfg, model), **kw)
        for p, t in zip(model.ps, leaves()):
            p.grad = t.clone()
        calls[0] = 0
        opt.step()
        info["calls"][f"hvd_{how}_{knob}"] = calls[0]
        keep(f"hvd_{how}_{knob}", [p.detach() for p in model.ps])
os.environ.pop(fusion.ENV_VAR, None)

# the program check: equal thresholds pass, a divergent one raises on
# every rank
def program(th):
    try:
        spmd_check.check_step_program(
            Leaves(), "train_step", grad_reduce="mean", accum_steps=1,
            fusion_threshold=th, metric_names=("accuracy", "loss"))
        return None
    except RuntimeError as e:
        return str(e)


info["spmd_equal"] = program(1 << 20)
info["spmd_divergent"] = program(512 if r == 0 else 1 << 20)

np.savez(f"{out}.{r}.npz", **arrays)
with open(f"{out}.{r}.json", "w") as f:
    json.dump(info, f)
hvd.shutdown()
"""


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """``{n: (inputs, [rank r's arrays], [rank r's json])}``."""
    root = tmp_path_factory.mktemp("fusion")
    out = {}
    for n in WORLDS:
        inputs = _inputs(n)
        path = root / f"in{n}.npz"
        np.savez(path, **inputs)
        stem = root / f"out{n}"
        LocalCluster(n, timeout=300, extra_env={"PYTHONPATH": REPO}).launch(
            [sys.executable, "-c", _WORKER, str(path), str(stem),
             json.dumps([d for _, d in LEAVES]), json.dumps(THRESHOLDS)])
        arrays = [dict(np.load(f"{stem}.{r}.npz")) for r in range(n)]
        infos = [json.loads(open(f"{stem}.{r}.json").read())
                 for r in range(n)]
        out[n] = (inputs, arrays, infos)
    return out


def _got(worlds, n, name):
    """Rank by rank, the leaves of case ``name``."""
    arrays = worlds[n][1]
    count = len([k for k in arrays[0] if k.startswith(name + "/")])
    return [[a[f"{name}/{i}"] for i in range(count)] for a in arrays]


def _assert_ranks_equal(got, want):
    for rank in got:
        assert len(rank) == len(want)
        for g, w in zip(rank, want):
            np.testing.assert_array_equal(g, w)


def _jax(n, fn, inputs):
    """``fn`` on each replica's leaves (cast to their dtypes) under
    ``shard_map`` on a data mesh of ``n`` devices; replica 0's results as
    float64 (every replica holds the same)."""
    mesh = Mesh(np.asarray(jax.devices()[:n]), ("data",))

    def body(*blocks):
        leaves = [b[0].astype(jnp.dtype(d))
                  for b, (_, d) in zip(blocks, LEAVES)]
        return tuple(o[None] for o in fn(leaves))

    with jax.enable_x64(True):
        xs = [inputs[f"l{i}"] for i in range(len(LEAVES))]
        f = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=P("data"),
                                  out_specs=P("data")))
        return [np.asarray(o[0]).astype(np.float64) for o in f(*xs)]


def _exact(inputs, n, mean):
    """The reduction in float64, from the inputs."""
    out = []
    for i, (_, d) in enumerate(LEAVES):
        s = inputs[f"l{i}"].astype(np.float64).sum(0)
        out.append(s / n if mean else s)
    return out


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("mean", [False, True], ids=["sum", "mean"])
def test_fused_and_staged_equal_the_per_tensor_path(worlds, n, mean):
    inputs = worlds[n][0]
    want = _exact(inputs, n, mean)
    kind = "mean" if mean else "sum"
    _assert_ranks_equal(_got(worlds, n, f"per_{kind}"), want)
    for th in THRESHOLDS:
        _assert_ranks_equal(_got(worlds, n, f"fused_{kind}_{th}"), want)
        if mean:
            _assert_ranks_equal(_got(worlds, n, f"staged_{th}"), want)


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("th", THRESHOLDS)
def test_fused_and_staged_equal_the_jax_passes(worlds, n, th):
    inputs = worlds[n][0]
    for mean in (False, True):
        want = _jax(n, lambda ls: jax_fusion.fused_psum(
            ls, "data", threshold_bytes=th, mean=mean), inputs)
        _assert_ranks_equal(
            _got(worlds, n, f"fused_{'mean' if mean else 'sum'}_{th}"), want)
    want = _jax(n, lambda ls: jax_fusion.staged_psum(
        ls, "data", threshold_bytes=th, mean=True), inputs)
    _assert_ranks_equal(_got(worlds, n, f"staged_{th}"), want)


@pytest.mark.parametrize("n", WORLDS)
def test_one_collective_a_bucket(worlds, n):
    """The fused pass issues one all_reduce a bucket of the census, the
    per-tensor path one a tensor; the staged pass reversed the leaf order
    (the plan order), so its census is that of the reversed list."""
    metas = [torch.empty(s, dtype=getattr(torch, d), device="meta")
             for s, d in LEAVES]
    for info in worlds[n][2]:
        assert info["calls"]["per_sum"] == len(LEAVES)
        assert info["calls"]["per_mean"] == len(LEAVES)
        for th in THRESHOLDS:
            want = fusion.bucket_census(metas, th)["n_buckets"]
            assert info["calls"][f"fused_sum_{th}"] == want
            assert info["calls"][f"fused_mean_{th}"] == want
            staged = info[f"staged_{th}"]
            assert staged["census"] == fusion.bucket_census(metas[::-1], th)
            assert 0 <= staged["early"] <= staged["census"]["n_buckets"]
            assert staged["calls_in_backward"] == staged["early"]
        assert (fusion.bucket_census(metas, 1 << 20)["n_buckets"]
                < fusion.bucket_census(metas, 512)["n_buckets"]
                < len(LEAVES))


@pytest.mark.parametrize("n", WORLDS)
def test_buckets_start_during_the_backward(worlds, n):
    """A bucket a leaf: the backward produces the gradients in reverse
    registration order here, the plan's order, so every bucket has
    started before ``backward()`` returned."""
    for info in worlds[n][2]:
        staged = info["staged_0"]
        assert staged["early"] >= 1
        assert staged["early"] == staged["census"]["n_buckets"]


@pytest.mark.parametrize("n", WORLDS)
def test_buckets_start_in_plan_order_whatever_the_backward_order(worlds, n):
    """The backward here produces the gradients in registration order,
    the reverse of the plan's: every rank still issues the buckets in
    plan order (gloo matches collectives by issue order), and the values
    are unchanged."""
    for info in worlds[n][2]:
        assert info["reversed_sizes"] == info["plan_sizes"]
        assert info["plan_sizes"] == [
            int(np.prod(s)) for s, _ in LEAVES][::-1]
    _assert_ranks_equal(_got(worlds, n, "reversed"),
                        _exact(worlds[n][0], n, mean=True))


@pytest.mark.parametrize("n", WORLDS)
def test_accum_steps_reduces_once(worlds, n):
    per = _got(worlds, n, "accum_None")
    for th in (64, 1 << 20):
        got = _got(worlds, n, f"accum_{th}")
        for rank, (g_rank, p_rank) in enumerate(zip(got, per)):
            for g, p in zip(g_rank, p_rank):
                np.testing.assert_allclose(g, p, rtol=STEP_RTOL[n],
                                           atol=STEP_RTOL[n])
        for info in worlds[n][2]:
            case = info[f"accum_{th}"]
            assert case["calls"] == case["want"]
            assert case["loss"] == pytest.approx(
                info["accum_None"]["loss"], rel=STEP_RTOL[n] or 1e-12)
    # the ranks end bit-identical
    for th in (None, 64, 1 << 20):
        got = _got(worlds, n, f"accum_{th}")
        _assert_ranks_equal(got[1:], got[0])
    assert worlds[n][2][0]["accum_1048576"]["want"] == 2


@pytest.mark.parametrize("n", WORLDS)
def test_a_parameter_with_no_gradient_neither_hangs_nor_gets_one(worlds, n):
    want = _exact(worlds[n][0], n, mean=True)[::-1]
    for info in worlds[n][2]:
        assert info["unused"]["grad_is_none"]
    # the unused parameter was registered last: first in the plan, in the
    # first bucket with the others
    _assert_ranks_equal(_got(worlds, n, "unused"), want[::-1])


@pytest.mark.parametrize("n", WORLDS)
def test_a_parameter_used_twice_fires_its_hook_once(worlds, n):
    a = worlds[n][0]["l1"].astype(np.float64)
    want = [3 * a.sum(0) / n, a.sum(0) / n]
    for info in worlds[n][2]:
        assert info["tied_fired"] == 1
    _assert_ranks_equal(_got(worlds, n, "tied"), want)


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("how", ["average", "sum", "fp16"])
def test_hvd_optimizer_honours_the_fusion_knob(worlds, n, how):
    """``hvd.DistributedOptimizer`` with ``TPUFRAME_FUSION_THRESHOLD``
    set: one collective a bucket, and the parameters array-equal to the
    per-tensor path's (the JAX package's own test holds the same)."""
    _assert_ranks_equal(_got(worlds, n, f"hvd_{how}_512"),
                        _got(worlds, n, f"hvd_{how}_None")[0])
    metas = [torch.empty(s, dtype=getattr(torch, d), device="meta")
             for s, d in LEAVES]
    if how == "fp16":   # the f32 leaves go over the wire in bf16
        metas = [m.to(torch.bfloat16) if m.dtype == torch.float32 else m
                 for m in metas]
    for info in worlds[n][2]:
        assert info["calls"][f"hvd_{how}_None"] == len(LEAVES)
        assert info["calls"][f"hvd_{how}_512"] == fusion.bucket_census(
            metas, 512)["n_buckets"]


@pytest.mark.parametrize("n", WORLDS)
def test_spmd_check_catches_a_divergent_threshold_on_every_rank(worlds, n):
    for r, info in enumerate(worlds[n][2]):
        assert info["spmd_equal"] is None
        msg = info["spmd_divergent"]
        assert msg is not None and "SPMD divergence in 'train_step:program'" \
            in msg and f"host {r} disagrees" in msg


def test_adasum_with_a_threshold_raises():
    with pytest.raises(ValueError, match="adasum.*fusion_threshold"):
        port_step.make_train_step(lambda *a: None, grad_reduce="adasum",
                                  fusion_threshold=1 << 20)


@functools.lru_cache(maxsize=None)
def _leaf_list(name):
    mixed = [((100,), "float32"), ((100,), "float32"), ((7,), "float32"),
             ((64,), "int8"), ((300,), "float32"), ((1,), "float32"),
             ((3, 5), "bfloat16"), ((2,), "bfloat16"), ((9,), "float32")]
    over = [((10,), "float32"), ((1000, 300), "float32"), ((4,), "float32"),
            ((5,), "float32")]
    if name == "mixed":
        return mixed
    if name == "over_threshold":
        return over
    # the real models in plan order, built on the CPU (no meta init)
    kw = {"resnet18": {"num_classes": 10, "cifar_stem": True},
          "resnet50": {"bn": "fused"}}[name]
    model = port_models.get_model(name, device="cpu", **kw)
    return [(tuple(p.shape), str(p.dtype).removeprefix("torch."))
            for _, p in fusion.plan_params(model)]


LEAF_LISTS = ("mixed", "over_threshold", "resnet18", "resnet50")


@pytest.mark.parametrize("threshold", [0, -1, 512, 1 << 20, 64 << 20])
@pytest.mark.parametrize("name", LEAF_LISTS)
def test_bucket_census_matches_jax(name, threshold):
    spec = _leaf_list(name)
    got = fusion.bucket_census(
        [torch.empty(s, dtype=getattr(torch, d), device="meta")
         for s, d in spec], threshold)
    want = jax_fusion.bucket_census(
        [jax.ShapeDtypeStruct(s, jnp.dtype(d)) for s, d in spec], threshold)
    assert got == want


def test_real_model_censuses():
    """The counts the chip check is held to: cifar10_resnet18 at 64 MiB is
    one bucket of 62 leaves (44.7 MB), at 4 MiB 12; ResNet-50 at 4 MiB
    161 leaves in 32 buckets."""
    def census(name, th):
        return fusion.bucket_census(
            [torch.empty(s, dtype=getattr(torch, d), device="meta")
             for s, d in _leaf_list(name)], th)

    big = census("resnet18", 64 << 20)
    assert (big["n_leaves"], big["n_buckets"], big["total_bytes"]) == (
        62, 1, 44695848)
    assert census("resnet18", 4 << 20)["n_buckets"] == 12
    r50 = census("resnet50", 4 << 20)
    assert (r50["n_leaves"], r50["n_buckets"]) == (161, 32)


@pytest.mark.parametrize("raw", [None, "0", "-1", "65536", "64MiB"])
def test_threshold_resolution_matches_jax(raw, monkeypatch):
    if raw is None:
        monkeypatch.delenv(fusion.ENV_VAR, raising=False)
    else:
        monkeypatch.setenv(fusion.ENV_VAR, raw)
    env = {} if raw is None else {fusion.ENV_VAR: raw}
    if raw == "64MiB":
        for mod in (fusion, jax_fusion):
            with pytest.raises(ValueError, match=fusion.ENV_VAR):
                mod.validate_threshold(raw)
            with pytest.raises(ValueError, match=fusion.ENV_VAR):
                mod.threshold_from_env(env)
            with pytest.raises(ValueError, match=fusion.ENV_VAR):
                mod.resolve()
        assert any(fusion.ENV_VAR in p for p in fusion.check_static())
        return
    if raw is not None:
        assert fusion.validate_threshold(raw) == \
            jax_fusion.validate_threshold(raw)
    assert fusion.threshold_from_env(env) == \
        jax_fusion.threshold_from_env(env)
    assert fusion.resolve() == jax_fusion.resolve()
    assert fusion.resolve(default=7) == jax_fusion.resolve(default=7)
    # no tuning DB in the port: a program or family changes nothing
    assert fusion.resolve(program="train_resnet50_b256",
                          family="fusion_threshold") == fusion.resolve()
    assert fusion.check_static() == []
