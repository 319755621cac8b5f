"""tpuframe_torch's ``TPUFRAME_SPEC`` grammar (``parallel/pspec.py``)
against the JAX package's, and the trainer's use of it.

Grammar: every string of ``tests/test_pspec.py``'s case tables (round
trips, malformed and overcommitted specs) and its whitespace, wildcard
and ``;slices=N`` cases goes through both modules: both parse it to the
same ``canonical()`` and the same ``sizes(n)`` on 1, 2, 4 and 8 ranks, or
both raise ``SpecError`` on the same inputs.  ``resolve`` keeps the
argument > environment > default order and raises on an ask that does
not parse.  ``lower`` and ``lower_pp`` refuse what the JAX functions
refuse, case by case, with a ``SpecError`` naming the same fault, and
lower the same specs (onto the port's step seams: a ``mesh.Layout`` of
the spec's sizes in place of the JAX mesh).

Trainer: a two-rank gloo world trains the ``smoke`` ConvNet three steps
with ``TPUFRAME_SPEC="dp=1,fsdp=2"`` and again with ``mesh={"data": 1,
"fsdp": 2}``: the losses, the eval loss and the saved states are
bit-equal, and the spec run's log holds its ``pspec`` event.  A spec
with ``;slices=2`` meets the multi-slice refusal (ROADMAP.md item 12).
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from tpuframe import models as jax_models  # noqa: E402
from tpuframe.parallel import pspec as jax_pspec  # noqa: E402
from tpuframe.parallel import step as jax_step  # noqa: E402
from tpuframe_torch import ckpt  # noqa: E402
from tpuframe_torch import models as port_models  # noqa: E402
from tpuframe_torch import train as port_train  # noqa: E402
from tpuframe_torch.obs import events  # noqa: E402
from tpuframe_torch.parallel import mesh as port_mesh  # noqa: E402
from tpuframe_torch.parallel import pspec  # noqa: E402
from tpuframe_torch.utils.config import get_config  # noqa: E402
from test_torch_fsdp import start_world  # noqa: E402

STRINGS = sorted(
    {t for t, _ in jax_pspec._ROUNDTRIP_CASES}
    | set(jax_pspec._MALFORMED_CASES)
    | {t for t, _ in jax_pspec._OVERCOMMITTED_CASES}
    | {" dp=4, fsdp=2 ; slices=2 ", "dp=*,fsdp=2", "dp=2,fsdp=2;slices=2",
       "dp=1,fsdp=2", "dp = * ; slices = 4", "dp=*;slices=3"})
RANKS = (1, 2, 4, 8)


def _outcome(fn):
    """``("ok", value)`` or ``("SpecError", None)``; any other exception
    propagates."""
    try:
        return "ok", fn()
    except (jax_pspec.SpecError, pspec.SpecError) as e:
        assert isinstance(e, ValueError)
        return "SpecError", None


@pytest.mark.parametrize("text", STRINGS, ids=[repr(t) for t in STRINGS])
def test_grammar_matches_the_jax_module(text):
    """Same canonical form and the same sizes on every world, or a
    ``SpecError`` from both."""
    want = _outcome(lambda: jax_pspec.parse_spec(text))
    got = _outcome(lambda: pspec.parse_spec(text))
    assert got[0] == want[0], (text, got, want)
    if want[0] != "ok":
        return
    assert got[1].canonical() == want[1].canonical()
    assert pspec.parse_spec(got[1].canonical()) == got[1]
    assert dataclass_fields(got[1]) == dataclass_fields(want[1])
    for n in RANKS:
        w = _outcome(lambda: want[1].sizes(n))
        g = _outcome(lambda: got[1].sizes(n))
        assert g == w, (text, n, g, w)


def dataclass_fields(spec) -> dict:
    return {k: getattr(spec, k) for k in (*pspec.AXIS_KEYS, "slices")}


def test_case_tables_and_self_check_are_the_jax_modules():
    assert pspec._ROUNDTRIP_CASES == jax_pspec._ROUNDTRIP_CASES
    assert pspec._MALFORMED_CASES == jax_pspec._MALFORMED_CASES
    assert pspec._OVERCOMMITTED_CASES == jax_pspec._OVERCOMMITTED_CASES
    assert pspec.AXIS_KEYS == jax_pspec.AXIS_KEYS
    assert pspec._grammar_problems() == [] == jax_pspec._grammar_problems()


@pytest.mark.parametrize("env,arg,want", [
    (None, None, (None, "default")),
    ("dp=2,tp=4", None, ("dp=2,tp=4", "env")),
    ("dp=2", "dp=4;slices=2", ("dp=4;slices=2", "arg")),
    (None, "dp=banana", "SpecError"),
    ("dp=0", None, "SpecError"),
    ("   ", None, (None, "default")),
], ids=["default", "env", "arg-beats-env", "arg-malformed", "env-malformed",
        "env-blank"])
def test_resolve_precedence_matches(monkeypatch, env, arg, want):
    if env is None:
        monkeypatch.delenv(pspec.SPEC_ENV, raising=False)
    else:
        monkeypatch.setenv(pspec.SPEC_ENV, env)
    for mod in (jax_pspec, pspec):
        if want == "SpecError":
            with pytest.raises(mod.SpecError):
                mod.resolve(arg)
            continue
        spec, source = mod.resolve(arg)
        assert (None if spec is None else spec.canonical(), source) == want


_STATE = {}


def jax_state():
    """The tiny LM's TrainState as shapes (``jax.eval_shape``): the
    placement reads shapes alone."""
    if "jax" not in _STATE:
        model = jax_models.get_model("transformer-lm", tiny=True,
                                     vocab_size=64, max_seq=32)
        ids = jnp.zeros((2, 32), jnp.int32)
        _STATE["jax"] = jax.eval_shape(
            lambda: jax_step.TrainState.create(
                model.init(jax.random.key(0), ids)["params"],
                optax.adamw(1e-3)))
    return _STATE["jax"]


def port_model():
    if "port" not in _STATE:
        _STATE["port"] = port_models.get_model(
            "transformer-lm", tiny=True, vocab_size=64, max_seq=32,
            device="cpu")
    return _STATE["port"]


# (id, spec, layout's spec (None: the spec's own), pass the state,
#  keyword arguments, the error's common phrase or None)
LOWER = [
    ("dp-modifiers", "dp=8", None, False,
     {"weight_update": "zero1", "wire_format": "int8-block"}, None),
    ("dp-slices", "dp=4;slices=2", None, False, {}, None),
    ("fsdp", "dp=4,fsdp=2", None, True, {}, None),
    ("fsdp-zero1", "dp=4,fsdp=2", None, True, {"weight_update": "zero1"},
     "do not compose"),
    ("fsdp-no-state", "dp=4,fsdp=2", None, False, {}, "TrainState"),
    ("fsdp-sp", "dp=2,fsdp=2,sp=2", None, True, {}, "does not compose"),
    ("pp", "dp=4,pp=2", None, False, {}, "lower_pp"),
    ("wrong-mesh", "dp=4,fsdp=2", "dp=8", True, {},
     "lower the spec onto the mesh it built"),
    ("sp", "dp=4,sp=2", None, False, {}, None),
    ("sp-zero1", "dp=4,sp=2", None, False, {"weight_update": "zero1"},
     "do not compose"),
    ("sp-int8", "dp=4,sp=2", None, False, {"wire_format": "int8-block"},
     "do not compose"),
    ("sp-fusion", "dp=4,sp=2", None, False, {"fusion_threshold": 1 << 20},
     "do not compose"),
    ("sp-adasum", "dp=4,sp=2", None, False, {"grad_reduce": "adasum"},
     "do not compose"),
    ("tp-no-rules", "dp=2,tp=4", None, True, {}, "tp_rules"),
    ("adasum-zero1", "dp=8", None, False,
     {"weight_update": "zero1", "grad_reduce": "adasum"}, "adasum"),
    ("adasum", "dp=8", None, False, {"grad_reduce": "adasum"}, None),
    ("dcn-without-hier", "dp=8", None, False,
     {"wire_format_dcn": "int8-block"}, "needs hier='hier'"),
    ("bad-reduce", "dp=8", None, False, {"grad_reduce": "sum"},
     "expected 'mean'"),
]


def _layout(text: str):
    spec = pspec.parse_spec(text)
    return port_mesh.Layout(sizes=spec.mesh_spec().sizes(8), rank=0)


@pytest.mark.parametrize("text,mesh_text,state,kw,match",
                         [c[1:] for c in LOWER], ids=[c[0] for c in LOWER])
def test_lower_refuses_what_the_jax_lower_refuses(text, mesh_text, state, kw,
                                                  match):
    """Each case through both ``lower``s: the same ``SpecError`` (its
    common phrase), or both lower; the port's kwargs are those of its
    step seam (the replicated step's modifiers, or the sharded-state
    step's layout)."""
    jspec, spec = jax_pspec.parse_spec(text), pspec.parse_spec(text)
    jmesh = jax_pspec.parse_spec(mesh_text or text).make_mesh()
    layout = _layout(mesh_text or text)
    jstate, model = (jax_state(), port_model()) if state else (None, None)
    if match is not None:
        with pytest.raises(jax_pspec.SpecError, match=match):
            jax_pspec.lower(jspec, jmesh, jstate, **kw)
        with pytest.raises(pspec.SpecError, match=match):
            pspec.lower(spec, layout, model, **kw)
        return
    want = jax_pspec.lower(jspec, jmesh, jstate, **kw)
    got = pspec.lower(spec, layout, model, **kw)
    if "state_shardings" in want:
        assert got == {"layout": layout}
        return
    for key in ("weight_update", "wire_format", "fusion_threshold",
                "grad_reduce"):
        if key in got:
            assert got[key] == want[key], key
    assert set(got) >= {"weight_update", "wire_format", "fusion_threshold"}


@pytest.mark.parametrize("text,match", [("dp=8", "pp > 1"),
                                        ("dp=2,tp=2,pp=2", "dp only")],
                         ids=["no-pipe", "pipe-with-tp"])
def test_lower_pp_validates_before_delegating(text, match):
    with pytest.raises(jax_pspec.SpecError, match=match):
        jax_pspec.lower_pp(jax_pspec.parse_spec(text),
                           jax_pspec.parse_spec(text).make_mesh(), None,
                           None)
    with pytest.raises(pspec.SpecError, match=match):
        pspec.lower_pp(pspec.parse_spec(text), _layout(text), None)


def test_lower_pp_builds_the_pipeline_step():
    """A ``pp`` spec lowers onto ``pp_lm.make_pp_lm_step`` (built only:
    the layout has no groups to run over)."""
    spec = pspec.parse_spec("dp=4,pp=2")
    model = port_models.get_model("transformer-lm-pp", tiny=True,
                                  vocab_size=64, max_seq=32, num_layers=2,
                                  device="cpu")
    assert callable(pspec.lower_pp(spec, _layout("dp=4,pp=2"), model))


def test_a_multi_slice_spec_meets_the_slices_refusal(monkeypatch):
    monkeypatch.setenv(pspec.SPEC_ENV, "dp=1,fsdp=2;slices=2")
    cfg = get_config("smoke")
    with pytest.raises(NotImplementedError,
                       match=r"slices=2.*ROADMAP.md.*item 12"):
        port_train.build_harness(cfg, device="cpu")


# One rank of the world of two: the smoke ConvNet through train.main,
# once with TPUFRAME_SPEC and once with the same mesh as an override, each
# with its own checkpoint and event directories.
_WORKER = r"""
import os, sys
import torch
import torch.distributed as dist
from tpuframe_torch import train as port_train

rank, port, root = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        world_size=2, rank=rank)
base = ["--config", "smoke", "--device", "cpu", "--set", "total_steps=3",
        "--set", "eval_every=3", "--set", "log_every=1"]
out = {}
for run, env, extra in (
        ("spec", "dp=1,fsdp=2", []),
        ("mesh", None, ["--set", "mesh={'data': 1, 'fsdp': 2}"])):
    if env is None:
        os.environ.pop("TPUFRAME_SPEC", None)
    else:
        os.environ["TPUFRAME_SPEC"] = env
    m = port_train.main(base + extra + [
        "--ckpt-dir", f"{root}/ckpt_{run}",
        "--events-dir", f"{root}/events_{run}_{rank}"])
    out[run] = {"losses": m["losses"], "eval_loss": m["eval_loss"]}
torch.save(out, f"{root}/rank{rank}.pt")
os._exit(0)
"""


def _records(directory) -> list:
    out = []
    for name in sorted(os.listdir(directory)):
        if name.endswith(".jsonl"):
            with open(os.path.join(directory, name)) as f:
                out += [json.loads(line) for line in f if line.strip()]
    return out


def test_spec_run_is_the_mesh_run_bit_for_bit(tmp_path):
    """``TPUFRAME_SPEC="dp=1,fsdp=2"`` trains exactly as ``mesh={"data":
    1, "fsdp": 2}`` does, and its log names the spec."""
    root = tmp_path
    runs = start_world(root, _WORKER, n=2, timeout=300)()
    for r in runs:
        assert r["spec"] == r["mesh"] == runs[0]["spec"]
        assert len(r["spec"]["losses"]) == 3
    step = 3
    spec_tree = ckpt.restore(str(root / "ckpt_spec"), step)
    mesh_tree = ckpt.restore(str(root / "ckpt_mesh"), step)
    flat_s, flat_m = _flat(spec_tree), _flat(mesh_tree)
    assert set(flat_s) == set(flat_m) and flat_s
    for k, v in flat_s.items():
        assert np.array_equal(np.asarray(v), np.asarray(flat_m[k])), k
    for rank in range(2):
        spec_recs = _records(root / f"events_spec_{rank}")
        mesh_recs = _records(root / f"events_mesh_{rank}")
        got = [r for r in spec_recs if r["type"] == "pspec"]
        assert [(r["spec"], r["source"]) for r in got] == [
            ("dp=1,fsdp=2", "env")]
        assert all(not events.validate_record(r) for r in got)
        assert not [r for r in mesh_recs if r["type"] == "pspec"]
        start = [r for r in spec_recs if r["type"] == "run_start"][0]
        assert start["mesh"]["fsdp"] == 2 and start["mesh"]["data"] == 1


def _flat(tree, prefix=()) -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, (*prefix, k)))
        return out
    return {"/".join(map(str, prefix)): tree}
