"""tpuframe_torch's sequence-parallel attention against the JAX package's.

The port's ``ring_attention`` (plain and flash stages) and
``ulysses_attention`` run in a gloo world of four CPU processes, one seq
ring of four; the JAX functions run under ``shard_map`` on a ``seq=4``
mesh of the conftest's virtual CPU devices, its flash stages in the
Pallas interpreter with ``TPUFRAME_RING_FLASH_INTERPRET=1`` and
``check_vma=False``, as tests/test_seq_parallel.py runs them.  The same
inputs and output cotangent, drawn with numpy from a seed, go to both,
and the forward and ``dq``/``dk``/``dv`` are compared.  On the CPU the
port's flash stages run the kernels' plain versions.  The same world
holds the mask gather of Ulysses and its transpose.

Tolerances, f32 both sides: the forward within 2e-5 (the JAX module's own
against whole attention); the gradients within 5e-5, where the two sum
the stages' partial gradients and the rotated chunks' cotangents in other
orders.
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
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

from tpuframe.ops import flash_attention as jax_fa  # noqa: E402
from tpuframe.ops import seq_parallel as jax_sp  # noqa: E402
from tpuframe.parallel import mesh as jax_mesh  # noqa: E402
from tpuframe_torch.ops import flash_attention as fa  # noqa: E402
from tpuframe_torch.ops import seq_parallel as sp  # noqa: E402
from tpuframe_torch.parallel import mesh as mesh_lib  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RING = 4
B, S, N, D = 2, 64, 4, 16
FWD_ATOL = 2e-5
GRAD_ATOL = 5e-5

# name: (function, impl, causal, mask, q_chunk)
CASES = {
    f"{fn}-{impl}-{'causal' if causal else 'full'}-{mask}"
    + ("" if qc is None else f"-q{qc}"): (fn, impl, causal, mask, qc)
    for fn, impl, causal, mask, qc in [
        ("ring", "xla", False, "none", None),
        ("ring", "xla", True, "none", None),
        ("ring", "xla", False, "padded", None),
        ("ring", "xla", True, "padded", 8),
        ("ring", "xla", False, "padded", 8),
        ("ring", "xla", False, "none", 8),
        ("ring", "pallas", False, "none", None),
        ("ring", "pallas", True, "none", None),
        ("ring", "pallas", False, "padded", None),
        ("ring", "pallas", True, "padded", None),
        ("ulysses", "xla", True, "none", None),
        ("ulysses", "xla", False, "padded", None),
        ("ulysses", "pallas", True, "none", None),
        ("ulysses", "pallas", False, "padded", None),
    ]}


def _inputs():
    rng = np.random.default_rng(0)
    q, k, v, g = (rng.standard_normal((B, S, N, D)).astype(np.float32) * 0.5
                  for _ in range(4))
    # batch row 0 keeps a ragged prefix of keys, row 1 none: its rows are
    # fully masked
    mask = np.zeros((B, S), np.int32)
    mask[0, :37] = 1
    return q, k, v, g, mask


_WORKER = r"""
import json, sys
import numpy as np
import torch
import torch.distributed as dist
from tpuframe_torch.ops import seq_parallel as sp
from tpuframe_torch.parallel import collectives
from tpuframe_torch.parallel import mesh as mesh_lib

rank, port, path, cases = (int(sys.argv[1]), sys.argv[2], sys.argv[3],
                           json.loads(sys.argv[4]))
n = 4
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        world_size=n, rank=rank)
seq = mesh_lib.build({"data": 1, "seq": n}, rank).seq
data = np.load(path)
c = data["q"].shape[1] // n
block = lambda a: a[:, rank * c:(rank + 1) * c]
out = {}
for name, (fn, impl, causal, mask, qc) in cases.items():
    q, k, v = (torch.from_numpy(block(data[x]).copy()).requires_grad_()
               for x in "qkv")
    m = None if mask == "none" else torch.from_numpy(block(data["mask"]))
    if fn == "ring":
        y = sp.ring_attention(q, k, v, seq=seq, mask=m, causal=causal,
                              q_chunk=qc, impl=impl)
    else:
        y = sp.ulysses_attention(q, k, v, seq=seq, mask=m, causal=causal,
                                 impl=impl)
    g = torch.from_numpy(block(data["g"]).copy())
    dq, dk, dv = torch.autograd.grad(y, (q, k, v), g)
    for key, t in (("out", y), ("dq", dq), ("dk", dk), ("dv", dv)):
        out[f"{name}/{key}"] = t.detach().numpy()
# the mask gather's backward: each rank weighs the gathered sequence by
# (rank + 1), so a block's gradient is the sum of the weights, n(n+1)/2 W
x = torch.from_numpy(block(data["g"]).copy()).requires_grad_()
y = collectives.gather_seq(x, seq)
(gx,) = torch.autograd.grad(y, x, torch.from_numpy(data["q"]) * (rank + 1))
out["gather/y"], out["gather/dx"] = y.detach().numpy(), gx.numpy()
np.savez(f"{path}.{rank}.npz", **out)
dist.destroy_process_group()
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def port_world(tmp_path_factory):
    """Every case through the port in one world of four: name -> {out,
    dq, dk, dv}, the ranks' blocks joined along the sequence."""
    root = tmp_path_factory.mktemp("seq")
    path = str(root / "inputs.npz")
    q, k, v, g, mask = _inputs()
    np.savez(path, q=q, k=k, v=v, g=g, mask=mask)
    port = str(_free_port())
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(r), port, path,
         json.dumps(CASES)], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(RING)]
    for p in procs:
        _, err = p.communicate(timeout=300)
        assert p.returncode == 0, err
    parts = [np.load(f"{path}.{r}.npz") for r in range(RING)]
    got = {name: {key: np.concatenate([p[f"{name}/{key}"] for p in parts],
                                      axis=1)
                  for key in ("out", "dq", "dk", "dv")}
           for name in CASES}
    got["gather"] = {"y": [p["gather/y"] for p in parts],
                     "dx": np.concatenate([p["gather/dx"] for p in parts],
                                          axis=1)}
    return got


def _jax_case(fn, impl, causal, mask_kind, qc, monkeypatch):
    q, k, v, g, mask = _inputs()
    mesh = jax_mesh.make_mesh(jax_mesh.MeshSpec(data=1, seq=RING),
                              devices=jax.devices()[:RING])
    act = P("data", "seq")
    if impl == "pallas":
        monkeypatch.setenv("TPUFRAME_RING_FLASH_INTERPRET", "1")

    def local(q, k, v, m):
        m = None if mask_kind == "none" else m
        if fn == "ring":
            return jax_sp.ring_attention(q, k, v, axis="seq", mask=m,
                                         causal=causal, q_chunk=qc,
                                         impl=impl)
        return jax_sp.ulysses_attention(q, k, v, axis="seq", mask=m,
                                        causal=causal, impl=impl)

    mapped = jax.jit(jax.shard_map(local, mesh=mesh, in_specs=(act,) * 4,
                                   out_specs=act,
                                   check_vma=impl != "pallas"))
    put = lambda a: jax.device_put(jnp.asarray(a),  # noqa: E731
                                   NamedSharding(mesh, act))
    args = [put(a) for a in (q, k, v, mask)]
    out, vjp = jax.vjp(lambda q, k, v: mapped(q, k, v, args[3]), *args[:3])
    dq, dk, dv = vjp(put(g))
    return {key: np.asarray(jax.device_get(t)) for key, t in
            (("out", out), ("dq", dq), ("dk", dk), ("dv", dv))}


@pytest.mark.parametrize("name", list(CASES))
def test_matches_jax_shard_map(name, port_world, monkeypatch):
    fn, impl, causal, mask, qc = CASES[name]
    want = _jax_case(fn, impl, causal, mask, qc, monkeypatch)
    got = port_world[name]
    np.testing.assert_allclose(got["out"], want["out"], atol=FWD_ATOL,
                               rtol=0, err_msg="out")
    for key in ("dq", "dk", "dv"):
        np.testing.assert_allclose(got[key], want[key], atol=GRAD_ATOL,
                                   rtol=0, err_msg=key)
    if mask == "padded" and (fn == "ring" or impl == "pallas"):
        # batch row 1 keeps no key: its rows stay exactly zero (Ulysses's
        # einsum attention fills masked scores with -1e9 instead, as the
        # JAX package's does, and averages v)
        assert not got["out"][1].any()


def test_the_mask_gather_and_its_transpose(port_world):
    """``gather_seq`` joins the ring's blocks in ring order on every
    rank; its backward sums each rank's slice of the cotangents over the
    ring (JAX's ``psum_scatter``, the transpose of a tiled
    ``all_gather``)."""
    q, _, _, g, _ = _inputs()
    got = port_world["gather"]
    for y in got["y"]:
        np.testing.assert_array_equal(y, g)
    np.testing.assert_allclose(got["dx"], q * RING * (RING + 1) / 2,
                               rtol=1e-6, atol=0)


def test_flash_mha_lse_backward_with_an_lse_cotangent():
    """The ring's stage: both outputs of ``flash_mha_lse`` get cotangents
    (the merge weights carry the lse's), held to ``jax.vjp`` of the JAX
    kernel in interpret mode."""
    rng = np.random.default_rng(3)
    q, k, v, do = (rng.standard_normal((2, 48, 3, 16)).astype(np.float32)
                   for _ in range(4))
    dlse = rng.standard_normal((2, 3, 48)).astype(np.float32)
    mask = np.ones((2, 48), np.int32)
    mask[1, 20:] = 0
    _, vjp = jax.vjp(lambda q, k, v: jax_fa.flash_mha_lse(
        q, k, v, mask=jnp.asarray(mask), causal=True, interpret=True),
        *map(jnp.asarray, (q, k, v)))
    want = vjp((jnp.asarray(do), jnp.asarray(dlse)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out, lse = fa.flash_mha_lse(tq, tk, tv, mask=torch.from_numpy(mask),
                                causal=True)
    got = torch.autograd.grad((out, lse), (tq, tk, tv),
                              (torch.from_numpy(do), torch.from_numpy(dlse)))
    assert float(np.abs(dlse).max()) > 0.5
    for g, w, key in zip(got, want, ("dq", "dk", "dv")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=1e-5, err_msg=key)


def test_ulysses_raises_when_heads_do_not_split():
    ring = mesh_lib.SeqGroup(group=None, size=3, index=0, ranks=(0, 1, 2))
    x = torch.zeros((1, 4, 4, 8))
    with pytest.raises(ValueError, match=r"heads \(4\) % seq ring \(3\)"):
        sp.ulysses_attention(x, x, x, seq=ring, causal=True)


def test_ring_needs_a_ring():
    x = torch.zeros((1, 4, 2, 8))
    with pytest.raises(ValueError, match="needs a seq ring"):
        sp.ring_attention(x, x, x, causal=True)


def test_rank_layout_is_the_jax_meshs():
    """Rank r sits where device r of the JAX mesh sits: data index x seq +
    seq index, and the seq rings are the mesh's seq rows."""
    sizes = {"data": 2, "fsdp": 1, "pipe": 1, "seq": 4, "expert": 1,
             "model": 1}
    mesh = jax_mesh.make_mesh(jax_mesh.MeshSpec(data=2, seq=4),
                              devices=jax.devices()[:8])
    ids = np.vectorize(lambda d: d.id)(mesh.devices)
    for r in range(8):
        lay = mesh_lib.Layout(sizes=sizes, rank=r)
        assert lay.data_index * 4 + lay.seq_index == r
        assert ids[lay.data_index, 0, 0, lay.seq_index, 0, 0] == r
    assert mesh.axis_names[0] == "data" and mesh.axis_names[3] == "seq"
    rings = mesh_lib.seq_rings(2, 4)
    assert rings == [tuple(ids[0, 0, 0, :, 0, 0]),
                     tuple(ids[1, 0, 0, :, 0, 0])] == [(0, 1, 2, 3),
                                                       (4, 5, 6, 7)]
    with pytest.raises(ValueError, match="composes with data parallelism"):
        mesh_lib.build(dict(sizes, pipe=2, data=1), 0)
