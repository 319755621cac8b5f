"""tpuframe_torch's trainer on a data x seq mesh against the JAX harness's.

Step parity: ``lm_smoke`` (the tiny LM, f32, adamw) with ``seq_mode``
ring and ulysses, two steps in a gloo world of four CPU processes laid out
``data=2 x seq=2`` by the port's trainer (``train.build_harness``: the
rank layout, the seq rings, the ring handed to the model), from the weights of the
JAX init converted with ``params_from_jax``; the JAX harness's step
(``make_loss_fn``, ``make_train_step`` with the ``_batch_layout`` of a
``shard_seq`` config) on a ``data=2 x seq=2`` mesh of the conftest's
virtual CPU devices, on the same global batches; and the ring again with
``TPUFRAME_FUSION_THRESHOLD`` set, its gradient buckets reduced during
the backward beside the ring's own collectives.  Each rank takes its
data rank's rows and its seq rank's block of columns, as the JAX layout
``P(('data', 'fsdp'), 'seq')`` does.  Losses within 1e-5 and parameters
within 1e-5 absolute (``test_torch_train.py``'s f32 tolerances: summation
order only), except on the tensors of :data:`LAYOUT_SENSITIVE`, where
the JAX step itself moves further when only its layout changes (the same
two steps on a ``data=4`` mesh with no sequence split): those within
twice that move, measured in the run.  Two Adam steps amplify the f32
summation order of a gradient that nearly cancels between the steps.

Also: the RoPE positions of a rank's chunk start at ``seq_index x
S_local``, and ``lm_smoke`` trains through ``train.main`` on its own
``data=2 x seq=4`` mesh of eight ranks.
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

from tpuframe import models as jax_models  # noqa: E402
from tpuframe import train as jax_train  # noqa: E402
from tpuframe.parallel import mesh as jax_mesh  # noqa: E402
from tpuframe.parallel import step as jax_step  # noqa: E402
from tpuframe.utils import build_optimizer as jax_build_optimizer  # noqa: E402
from tpuframe.utils.config import get_config as jax_get_config  # noqa: E402
from tpuframe_torch.data import datasets  # noqa: E402
from tpuframe_torch.launch.launcher import LocalCluster  # noqa: E402
from tpuframe_torch.models import transformer_lm as torch_lm  # noqa: E402
from tpuframe_torch.models.convert import params_from_jax  # noqa: E402
from tpuframe_torch.parallel import mesh as mesh_lib  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESH = {"data": 2, "seq": 2}
MODES = ("ring", "ulysses")
STEPS = 2
# The tensors whose JAX steps on data=4 and on data=2 x seq=2 differ by
# more than 1e-5, with that difference as measured on the CPU (ring,
# ulysses): the port's distance from the data=2 x seq=2 step was 1.68e-5
# and 9.1e-6.  Every other tensor is held to 1e-5.
LAYOUT_SENSITIVE = {"blocks.0.attn.key.weight": (1.53e-5, 1.12e-5)}


def _batches():
    """lm_smoke's first global batches, rows in order."""
    cfg = jax_get_config("lm_smoke")
    train, _ = datasets.lm_text(None, **cfg.dataset_kwargs)
    b = cfg.global_batch
    return [train[np.arange(b * i, b * (i + 1))] for i in range(STEPS)]


def _jax_steps(mode, mesh_kw=MESH):
    """Two JAX harness steps of lm_smoke on a ``mesh_kw`` mesh (default
    data=2 x seq=2; seq_mode "none" for a mesh without seq): (losses,
    final params as the port's state_dict, init)."""
    jcfg = jax_get_config("lm_smoke").with_overrides(
        mesh=mesh_kw, model_kwargs={"seq_mode": mode},
        shard_seq=mesh_kw.get("seq", 1) > 1)
    model = jax_models.get_model(jcfg.model, dtype=jnp.float32,
                                 **jcfg.model_kwargs)
    seq_len = jcfg.dataset_kwargs["seq_len"]
    params = jax.tree.map(np.asarray, model.init(
        jax.random.key(0), jnp.zeros((1, seq_len), jnp.int32))["params"])
    tx = jax_build_optimizer(jcfg, params)
    state = jax_step.TrainState.create(params, tx)
    mesh = jax_mesh.make_mesh(jax_mesh.MeshSpec(**mesh_kw),
                              devices=jax.devices()[:4])
    _, part, axes = jax_train._batch_layout(jcfg)
    step = jax_step.make_train_step(jax_train.make_loss_fn(jcfg, model), tx,
                                    mesh, donate=False, batch_partition=part,
                                    reduce_axes=axes)
    losses = []
    for b in _batches():
        state, m = step(state, {k: jnp.asarray(x) for k, x in b.items()})
        losses.append(float(m["loss"]))
    return (losses, params_from_jax(jax.tree.map(np.asarray, state.params)),
            params_from_jax(params))


# One rank of the data=2 x seq=2 world: the trainer's harness for each
# mode, the JAX init loaded, two steps on this rank's rows and columns of
# each global batch.  Rank 0 writes the losses and the state.
_WORKER = r"""
import json, os, sys
import numpy as np
import torch
import torch.distributed as dist
from tpuframe_torch import train as port_train
from tpuframe_torch.data import datasets

rank, port, out, root = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        world_size=4, rank=rank)
result = {}
for run in ("ring", "ulysses", "ring-fused"):
    mode = run.split("-")[0]
    if run.endswith("fused"):
        # the fusion buckets' all_reduces on the world group start from
        # gradient hooks while the ring's backward runs on its seq group
        os.environ["TPUFRAME_FUSION_THRESHOLD"] = "4096"
    cfg = port_train.get_config("lm_smoke").with_overrides(
        mesh={"data": 2, "seq": 2}, model_kwargs={"seq_mode": mode})
    h = port_train.build_harness(cfg, device="cpu")
    h.state.model.load_state_dict(torch.load(f"{root}/{mode}.pt"))
    lay = h.layout
    assert (lay.data_index, lay.seq_index) == divmod(rank, 2), lay
    train, _ = datasets.lm_text(None, **cfg.dataset_kwargs)
    b, s = cfg.global_batch, cfg.dataset_kwargs["seq_len"]
    rows = b // 2
    c = s // 2
    losses = []
    for i in range(2):
        glob = train[np.arange(b * i, b * (i + 1))]
        mine = {k: torch.from_numpy(np.ascontiguousarray(
                    v[lay.data_index * rows:(lay.data_index + 1) * rows,
                      lay.seq_index * c:(lay.seq_index + 1) * c]))
                for k, v in glob.items()}
        losses.append(float(h.train_step(h.state, mine)["loss"]))
    if run.endswith("fused"):
        assert h.train_step.reducer.early > 0
        del os.environ["TPUFRAME_FUSION_THRESHOLD"]
    result[run] = {"losses": losses, "state": {
        k: v.tolist() for k, v in h.state.model.state_dict().items()}}
if rank == 0:
    with open(out, "w") as f:
        json.dump(result, f)
dist.destroy_process_group()
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def seq_world(tmp_path_factory):
    """The JAX steps of both modes and the port's four-rank run of each."""
    want = {mode: _jax_steps(mode) for mode in MODES}
    want["layout"] = _jax_steps("none", {"data": 4, "seq": 1})
    for k, w in want["layout"][2].items():      # the same init
        assert torch.equal(w, want["ring"][2][k]), k
    root = tmp_path_factory.mktemp("seq_train")
    for mode in MODES:
        torch.save(want[mode][2], root / f"{mode}.pt")
    out = root / "rank0.json"
    port = str(_free_port())
    env = {k: v for k, v in os.environ.items()
           if k not in ("TPUFRAME_ATTN_IMPL", "TPUFRAME_FUSION_THRESHOLD")}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(r), port, str(out), str(root)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(4)]
    for p in procs:
        _, err = p.communicate(timeout=300)
        assert p.returncode == 0, err
    return json.loads(out.read_text()), want


@pytest.mark.parametrize("run", [*MODES, "ring-fused"])
def test_seq_steps_match_the_jax_data2_seq2_mesh(seq_world, run):
    """``ring-fused``: the ring with ``TPUFRAME_FUSION_THRESHOLD`` set, its
    gradient buckets reduced over the world while the backward's ring
    collectives run on the seq groups (a local loss then, as in the JAX
    harness: with no ``-100`` labels the same mean)."""
    got, want = seq_world
    mode = run.split("-")[0]
    losses, final, _ = want[mode]
    _, other_layout, _ = want["layout"]
    np.testing.assert_allclose(got[run]["losses"], losses, atol=1e-5,
                               rtol=0)
    assert set(final) <= set(got[run]["state"])
    for k, w in final.items():
        atol = 1e-5
        if k in LAYOUT_SENSITIVE:
            atol = max(atol, 2 * float((w - other_layout[k]).abs().max()))
        np.testing.assert_allclose(np.asarray(got[run]["state"][k]),
                                   w.numpy(), atol=atol, rtol=0, err_msg=k)


@pytest.mark.parametrize("seq_mode,index,start", [
    ("ring", 1, 32), ("ulysses", 1, 32), ("ring", 0, 0), ("none", 1, 0)])
def test_rope_positions_start_at_the_ranks_chunk(seq_mode, index, start,
                                                 monkeypatch):
    """Rank ``index`` of a seq ring of two holds positions ``[index * 32,
    index * 32 + 32)`` of a 64-token sequence; a ``seq_mode="none"``
    model ignores the ring set on it.  The ring's attention is replaced by
    whole-chunk attention here: only the positions are under test."""
    seen = []
    real_rope = torch_lm.rope

    def recording_rope(x, positions, theta):
        seen.append(positions.clone())
        return real_rope(x, positions, theta)

    def local(q, k, v, *, seq, causal, impl):
        return torch_lm.attn_ops.multihead_attention(q, k, v, causal=causal)

    monkeypatch.setattr(torch_lm, "rope", recording_rope)
    monkeypatch.setattr(torch_lm.seq_parallel, "ring_attention", local)
    monkeypatch.setattr(torch_lm.seq_parallel, "ulysses_attention", local)
    model = torch_lm.TransformerLM(
        torch_lm.LMConfig.tiny(seq_mode=seq_mode, num_layers=1),
        device="cpu")
    model.seq = mesh_lib.SeqGroup(group=None, size=2, index=index,
                                  ranks=(0, 1))
    model(torch.zeros((2, 32), dtype=torch.int64))
    assert seen and all(torch.equal(p, torch.arange(start, start + 32))
                        for p in seen)


def test_lm_smoke_trains_on_its_own_mesh():
    """``lm_smoke``'s own mesh, data=2 x seq=4, through ``train.main`` in
    eight gloo processes: every rank finishes, and rank 0's loss falls."""
    steps = 8
    procs = LocalCluster(8, timeout=240, extra_env={
        "OMP_NUM_THREADS": "1", "TPUFRAME_ATTN_IMPL": "xla"}).launch(
        [sys.executable, "-m", "tpuframe_torch.train", "--config",
         "lm_smoke", "--device", "cpu", "--set", f"total_steps={steps}",
         "--set", f"eval_every={steps}", "--set", "log_every=1"])
    assert all(p.returncode == 0 for p in procs)
    out = procs[0].stdout
    assert "devices=8" in out and f"[eval {steps}]" in out
    losses = [float(line.split("loss=")[1].split()[0])
              for line in out.splitlines() if line.startswith("[train ")]
    assert len(losses) == steps and losses[-1] < losses[0]


def test_step_flops_count_the_whole_sequence_once():
    """A rank holds S/n tokens of each row; the step's model FLOPs (MFU's
    numerator) are those of the whole sequence: its tokens and its causal
    pairs, counted once."""
    from tpuframe_torch import train as port_train
    from tpuframe_torch.obs import flops

    cfg = port_train.get_config("lm_smoke")
    model = torch_lm.TransformerLM(torch_lm.LMConfig.tiny(vocab_size=64),
                                   device="cpu")
    local = {"input_ids": torch.zeros((2, 16), dtype=torch.int64)}
    got, src = flops.step_flops(cfg, model, local, 4)
    assert src == "model"
    assert got == flops.lm_step_flops(model.cfg, cfg.global_batch, 64)
    assert got != flops.step_flops(cfg, model, local)[0]


def test_the_program_check_sees_the_mesh_and_the_seq_mode():
    """Ranks that disagree on the seq degree or the attention's seq_mode
    issue other collectives: their step programs differ."""
    from tpuframe_torch.obs import spmd_check

    model = torch_lm.TransformerLM(torch_lm.LMConfig.tiny(vocab_size=64),
                                   device="cpu")
    kw = dict(grad_reduce="mean", accum_steps=1, fusion_threshold=None,
              metric_names=("accuracy", "loss"))
    base = spmd_check.step_program(model, mesh={"data": 2, "seq": 2},
                                   seq_mode="ring", **kw)
    assert base != spmd_check.step_program(
        model, mesh={"data": 1, "seq": 4}, seq_mode="ring", **kw)
    assert base != spmd_check.step_program(
        model, mesh={"data": 2, "seq": 2}, seq_mode="ulysses", **kw)
