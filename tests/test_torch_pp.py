"""tpuframe_torch's pipeline (``parallel/pp.py``, the pipe verbs of
``parallel/collectives.py``, the pipe groups of ``parallel/mesh.py``)
against the JAX package's ``tpuframe.parallel.pp``.

The rank layout is the JAX mesh's device order on a data=2 x pipe=4
mesh.  One gloo world of four CPU processes (pipe=4) runs
``pipeline_apply`` of ``tanh(x @ W_s)`` stages with 4 and 8
microbatches, the loss taken from ``last_stage_value`` on every stage
(JAX's form) and on the last stage alone (the LM step's form), while
this process runs the JAX pipeline under ``shard_map`` on four of the
conftest's virtual devices.  Held: outputs and every stage's weight
gradient against JAX and against the sequential model at 1e-6 (the
gradients with the JAX test's rtol of 1e-5); the two loss forms'
gradients bit for bit; the bubbles computing nothing; the rotations'
calls and bytes the schedule's.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from tpuframe.parallel import mesh as jax_mesh  # noqa: E402
from tpuframe.parallel import pp as jax_pp  # noqa: E402
from tpuframe_torch.parallel import mesh as mesh_lib  # noqa: E402
from tpuframe_torch.parallel import pp  # noqa: E402

from test_torch_fsdp import start_world  # noqa: E402

HID = 16
STAGES = 4
MICROS = (4, 8)
BATCH = 16
ATOL = 1e-6


class TestMicrobatch:
    def test_shape(self):
        x = torch.arange(24.0).reshape(12, 2)
        got = pp.microbatch(x, 4)
        assert got.shape == (4, 3, 2)
        assert torch.equal(got[1], x[3:6])

    def test_indivisible_raises(self):
        with pytest.raises(ValueError, match="not divisible"):
            pp.microbatch(torch.zeros((10, 2)), 4)


def test_rank_layout_is_the_jax_meshs_with_pipe():
    """Rank r sits where device r of the JAX data=2 x pipe=4 mesh sits;
    the pipe groups are the mesh's pipe rows and the data groups its
    columns; the stages of one data index take the same rows."""
    sizes = {"data": 2, "fsdp": 1, "pipe": 4, "seq": 1, "expert": 1,
             "model": 1}
    mesh = jax_mesh.make_mesh(jax_mesh.MeshSpec(data=2, pipe=4),
                              devices=jax.devices()[:8])
    assert mesh.axis_names[2] == "pipe"
    ids = np.vectorize(lambda d: d.id)(mesh.devices)
    for r in range(8):
        lay = mesh_lib.Layout(sizes=sizes, rank=r)
        c = lay.coords()
        assert ids[c["data"], 0, c["pipe"], 0, 0, 0] == r
        assert (lay.pipe_index, lay.batch_index, lay.batch_size) == (
            c["pipe"], c["data"], 2)
    assert mesh_lib.axis_groups(sizes, ("pipe",)) == [
        tuple(ids[d, 0, :, 0, 0, 0]) for d in range(2)]
    assert mesh_lib.axis_groups(sizes, ("data",)) == [
        tuple(ids[:, 0, s, 0, 0, 0]) for s in range(4)]


@pytest.mark.parametrize("mixed", [{"seq": 2}, {"fsdp": 2}, {"model": 2},
                                   {"expert": 2}])
def test_pipe_composes_with_data_alone(mixed):
    sizes = dict({"data": 1, "fsdp": 1, "pipe": 2, "seq": 1, "expert": 1,
                  "model": 1}, **mixed)
    with pytest.raises(ValueError, match="composes with data parallelism"):
        mesh_lib.build(sizes, 0)


def _params():
    rng = np.random.default_rng(0)
    return (rng.normal(size=(STAGES, HID, HID)) * 0.5).astype(np.float32)


def _data():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(BATCH, HID)).astype(np.float32)
    t = rng.normal(size=(BATCH, HID)).astype(np.float32)
    return x, t


def _sequential(w, x):
    for i in range(w.shape[0]):
        x = torch.tanh(x @ w[i])
    return x


# One stage of the world of four: for each microbatch count, the
# pipeline's output and its weight's gradient with the loss on every
# stage (from last_stage_value) and on the last stage alone, the stage
# function's calls and the pipe verbs' counts.  os._exit(0) once the
# results are written (a gloo world's teardown can abort).
_WORKER = r"""
import os, sys
import numpy as np
import torch
import torch.distributed as dist
from tpuframe_torch.parallel import collectives, mesh as mesh_lib, pp

rank, port, root = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        world_size=4, rank=rank)
lay = mesh_lib.build({"data": 1, "fsdp": 1, "pipe": 4, "seq": 1,
                      "expert": 1, "model": 1}, rank)
data = np.load(f"{root}/inputs.npz")
x, t = torch.from_numpy(data["x"]), torch.from_numpy(data["t"])
result = {}
for m in (4, 8):
    for form in ("every", "last"):
        w = torch.from_numpy(data["w"][lay.pipe_index]).requires_grad_()
        calls = []

        def stage(h):
            calls.append(tuple(h.shape))
            return torch.tanh(h @ w)

        collectives.reset_pipe()
        out = pp.pipeline_apply(stage, pp.microbatch(x, m), lay.pipe)
        fwd = (dict(collectives.PIPE_CALLS), dict(collectives.PIPE_BYTES))
        y = collectives.last_stage_value(out, lay.pipe).reshape(x.shape)
        if form == "every" or lay.pipe_index == 3:
            ((y - t) ** 2).mean().backward()
        else:
            pp.backward_from(out)
        result[(m, form)] = {
            "y": y.detach(), "grad": w.grad.clone(), "calls": calls,
            "fwd": fwd, "all": (dict(collectives.PIPE_CALLS),
                                dict(collectives.PIPE_BYTES))}
torch.save(result, f"{root}/rank{rank}.pt")
os._exit(0)
"""


def _jax_run(w, x, t, n_micro):
    """The JAX pipeline's output and its gradient on pipe=4."""
    mesh = jax_mesh.make_mesh(jax_mesh.MeshSpec(data=1, pipe=STAGES),
                              devices=jax.devices()[:STAGES])

    def stage_fn(params, h):
        return jnp.tanh(h @ params[0])

    def body(params, xb, tb):
        def loss_fn(p):
            micro = jax_pp.microbatch(xb, n_micro)
            out = jax_pp.last_stage_value(
                jax_pp.pipeline_apply(stage_fn, p, micro))
            y = out.reshape(xb.shape)
            return jnp.mean((y - tb) ** 2), y

        (_, y), g = jax.value_and_grad(loss_fn, has_aux=True)(params)
        return y, g

    y, g = jax.jit(jax.shard_map(
        body, mesh=mesh, in_specs=(P("pipe"), P(), P()),
        out_specs=(P(), P("pipe"))))(jnp.asarray(w), jnp.asarray(x),
                                     jnp.asarray(t))
    return np.asarray(y), np.asarray(g)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("pp")
    w = _params()
    x, t = _data()
    np.savez(root / "inputs.npz", w=w, x=x, t=t)
    results = start_world(root, _WORKER, n=STAGES, timeout=240)
    try:
        want = {m: _jax_run(w, x, t, m) for m in MICROS}
    finally:
        ranks = results()
    wt = torch.from_numpy(w).requires_grad_()
    xt, tt = torch.from_numpy(x), torch.from_numpy(t)
    y = _sequential(wt, xt)
    ((y - tt) ** 2).mean().backward()
    seq = (y.detach(), wt.grad)
    return want, seq, ranks


@pytest.mark.parametrize("m", MICROS)
def test_pipeline_matches_sequential_and_jax(world, m):
    want, (y_seq, _), ranks = world
    for r in ranks:
        y = r[(m, "every")]["y"]
        np.testing.assert_allclose(y.numpy(), y_seq.numpy(), atol=ATOL,
                                   rtol=ATOL)
        np.testing.assert_allclose(y.numpy(), want[m][0], atol=ATOL,
                                   rtol=ATOL)


@pytest.mark.parametrize("m", MICROS)
def test_pipeline_grads_match_sequential_and_jax(world, m):
    """Each stage's gradient is its slice of the sequential model's and of
    the JAX pipeline's (the backward pipeline: the rotations' reverse
    shifts)."""
    want, (_, g_seq), ranks = world
    for s, r in enumerate(ranks):
        g = r[(m, "every")]["grad"].numpy()
        np.testing.assert_allclose(g, g_seq[s].numpy(), atol=ATOL,
                                   rtol=1e-5)
        np.testing.assert_allclose(g, want[m][1][s], atol=ATOL, rtol=1e-5)


@pytest.mark.parametrize("m", MICROS)
def test_loss_on_the_last_stage_alone_gives_the_same_grads(world, m):
    """The LM step's form: the stages before the last start their
    backward from a zero cotangent (``backward_from``)."""
    _, _, ranks = world
    for r in ranks:
        assert torch.equal(r[(m, "last")]["grad"], r[(m, "every")]["grad"])


@pytest.mark.parametrize("m", MICROS)
def test_bubbles_compute_nothing(world, m):
    _, _, ranks = world
    for r in ranks:
        assert r[(m, "every")]["calls"] == [(BATCH // m, HID)] * m


@pytest.mark.parametrize("m", MICROS)
def test_rotation_traffic_is_the_schedules(world, m):
    """M + S - 2 rotations a pass (the last tick's would go nowhere):
    each stage but the last sends its M outputs forward, each stage but
    the first its M input cotangents back; one last_stage_value, its
    payload sent by the last stage alone."""
    _, _, ranks = world
    mb = BATCH // m * HID * 4
    x_bytes = BATCH * HID * 4
    for s, r in enumerate(ranks):
        calls, nbytes = r[(m, "every")]["fwd"]
        assert calls["pipe_rotate"] == m + STAGES - 2
        assert nbytes["pipe_rotate"] == (m * mb if s < STAGES - 1 else 0)
        calls, nbytes = r[(m, "every")]["all"]
        assert calls == {"pipe_rotate": 2 * (m + STAGES - 2),
                         "last_stage_value": 1, "pipe_broadcast": 0,
                         "pipe_all_reduce": 0}
        assert nbytes["pipe_rotate"] == m * mb * (
            (s < STAGES - 1) + (s > 0))
        assert nbytes["last_stage_value"] == (
            x_bytes if s == STAGES - 1 else 0)


def test_one_stage_is_the_stage_function():
    """No pipe group (or one stage): the stage function on each
    microbatch, no collective."""
    x = torch.randn(8, HID)
    w = torch.randn(HID, HID)
    out = pp.pipeline_apply(lambda h: h @ w, pp.microbatch(x, 2), None)
    assert torch.equal(out.reshape(x.shape), torch.cat([x[:4] @ w,
                                                        x[4:] @ w]))

