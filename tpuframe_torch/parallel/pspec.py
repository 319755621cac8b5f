"""Declarative parallelism spec: one string lowered onto the mesh
(counterpart of ``tpuframe/parallel/pspec.py``, copied: the port imports
nothing of the JAX package).

``TPUFRAME_SPEC="dp=4,fsdp=2,tp=1;slices=2"`` names a whole parallelism
layout: the comma part declares the axes of ONE slice in grammar keys
(``dp``/``fsdp``/``tp``/``pp``/``sp``/``ep``; the values are positive
degrees, ``*`` on ``dp`` means "all remaining ranks"), and the optional
``;slices=N`` tail declares N such slices.  :func:`parse_spec` validates
the grammar, :meth:`ParallelSpec.mesh_spec` turns it into the trainer's
:class:`~tpuframe_torch.utils.config.MeshSpec`, and :func:`lower` maps it
onto the port's step seams with the JAX module's validation and its
:class:`SpecError`\\ s: the replicated data-parallel step and its
modifiers (zero1, the int8 wire, fusion, Adasum), sequence parallelism
(the model's seq ring, the world's loss reduction), the sharded-state
step (fsdp, tensor and expert parallelism over a ``mesh.Layout``) and,
through :func:`lower_pp`, the pipeline step.

The trainer reads ``TPUFRAME_SPEC`` through :func:`resolve` (an
argument, then the environment; an ask that does not parse raises) and
lets the spec's mesh win over the config's.  A spec with ``slices`` above
1 parses and sizes as in the JAX package, and the trainer refuses it, as
it refuses a multi-slice mesh.  Not ported: ``topology_devices`` (JAX's
compile-only TPU topologies) and the half of the JAX ``check()`` that
reads XLA programs (the replica-group detector and the ICI/DCN byte
split); :func:`_grammar_problems`, its grammar half, is here.
"""

from __future__ import annotations

import dataclasses
import os

SPEC_ENV = "TPUFRAME_SPEC"

#: the name the JAX mesh gives the slice axis (outermost)
SLICE_AXIS = "slice"

#: grammar key -> mesh axis name (the order here is the canonical
#: formatting order; the mesh's own axis order is ``mesh.AXES``).
AXIS_KEYS = {
    "dp": "data",
    "fsdp": "fsdp",
    "tp": "model",
    "pp": "pipe",
    "sp": "seq",
    "ep": "expert",
}


class SpecError(ValueError):
    """A malformed, overcommitted or unlowerable parallelism spec."""


@dataclasses.dataclass(frozen=True)
class ParallelSpec:
    """A parsed ``TPUFRAME_SPEC``.  ``dp == -1`` is the ``*`` wildcard
    ("all remaining ranks"); every other degree must be positive."""

    dp: int = 1
    fsdp: int = 1
    tp: int = 1
    pp: int = 1
    sp: int = 1
    ep: int = 1
    slices: int = 1

    def __post_init__(self):
        for key in AXIS_KEYS:
            v = getattr(self, key)
            if key == "dp" and v == -1:
                continue
            if not isinstance(v, int) or v < 1:
                raise SpecError(
                    f"axis {key}={v!r} must be a positive integer"
                    + (" (or * for all remaining chips)"
                       if key == "dp" else ""))
        if not isinstance(self.slices, int) or self.slices < 1:
            raise SpecError(f"slices={self.slices!r} must be a positive "
                            f"integer — a mesh spans at least one slice")

    def canonical(self) -> str:
        """The shortest spelling that round-trips: ``dp`` always, the
        other axes only at a degree above 1, ``;slices=N`` only above
        1."""
        parts = [f"dp={'*' if self.dp == -1 else self.dp}"]
        parts += [f"{k}={getattr(self, k)}" for k in AXIS_KEYS
                  if k != "dp" and getattr(self, k) != 1]
        text = ",".join(parts)
        if self.slices > 1:
            text += f";slices={self.slices}"
        return text

    def mesh_spec(self):
        """The trainer's :class:`~tpuframe_torch.utils.config.MeshSpec`
        this spec declares."""
        from tpuframe_torch.utils.config import MeshSpec

        kw = {AXIS_KEYS[k]: getattr(self, k) for k in AXIS_KEYS}
        return MeshSpec(slices=self.slices, **kw)

    def sizes(self, n_devices: int) -> dict:
        """Each mesh axis's degree on ``n_devices`` ranks, the wildcard
        filled, as the JAX mesh names them (a ``slice`` axis first where
        ``slices`` is above 1).  Raises :class:`SpecError` on an over- or
        under-committed spec."""
        import numpy as np

        try:
            raw = self.mesh_spec().sizes(n_devices)
        except ValueError as e:
            fixed = int(np.prod([getattr(self, k) for k in AXIS_KEYS
                                 if getattr(self, k) != -1])) * self.slices
            if fixed > n_devices:
                raise SpecError(
                    f"spec '{self.canonical()}' is overcommitted: axis "
                    f"product {fixed} exceeds the {n_devices} available "
                    f"devices") from e
            raise SpecError(f"spec '{self.canonical()}' does not fit "
                            f"{n_devices} devices: {e}") from e
        out = {SLICE_AXIS: raw["slices"]} if self.slices > 1 else {}
        out.update((axis, raw[axis]) for axis in
                   ("data", "fsdp", "pipe", "seq", "expert", "model"))
        return out


def parse_spec(text: str) -> ParallelSpec:
    """Parse ``"dp=4,fsdp=2,tp=1;slices=2"`` into a :class:`ParallelSpec`.

    A grammar error is a :class:`SpecError` naming the token at fault:
    an explicit spec (environment or argument) fails loudly."""
    if not isinstance(text, str) or not text.strip():
        raise SpecError("empty parallelism spec — expected e.g. "
                        "'dp=4,fsdp=2;slices=2'")
    text = "".join(text.split())  # whitespace is never meaningful
    head, sep, tail = text.partition(";")
    kw: dict[str, int] = {}
    if sep:
        skey, seq, sval = tail.partition("=")
        if skey != "slices" or not seq:
            raise SpecError(f"after ';' only 'slices=N' is allowed, "
                            f"got {tail!r}")
        try:
            kw["slices"] = int(sval)
        except ValueError:
            raise SpecError(f"slices={sval!r} is not an integer") from None
    if not head:
        raise SpecError(f"spec {text!r} has no axis part before ';'")
    for token in head.split(","):
        key, eq, val = token.partition("=")
        if not eq or not key or not val:
            raise SpecError(f"malformed axis token {token!r} — expected "
                            f"key=value")
        if key not in AXIS_KEYS:
            raise SpecError(f"unknown axis {key!r}; expected one of "
                            f"{sorted(AXIS_KEYS)}")
        if key in kw:
            raise SpecError(f"duplicate axis {key!r} in spec {text!r}")
        if val == "*":
            if key != "dp":
                raise SpecError(f"wildcard '*' is only allowed on dp, "
                                f"not {key!r}")
            kw[key] = -1
            continue
        try:
            kw[key] = int(val)
        except ValueError:
            raise SpecError(f"axis {key}={val!r} is not an integer "
                            f"(or * on dp)") from None
    return ParallelSpec(**kw)


def format_spec(spec: ParallelSpec) -> str:
    return spec.canonical()


def resolve(explicit: str | None = None) -> tuple:
    """``(ParallelSpec | None, source)``: an explicit argument wins, then
    ``TPUFRAME_SPEC``, then ``(None, "default")``; an ask that does not
    parse raises (never a silent fallback).  The JAX harness's tuning-DB
    leg has no counterpart here."""
    if explicit is not None:
        return parse_spec(explicit), "arg"
    raw = os.environ.get(SPEC_ENV)
    if raw is not None and raw.strip():
        return parse_spec(raw), "env"
    return None, "default"


# ---------------------------------------------------------------------------
# Lowering onto the port's step seams.
# ---------------------------------------------------------------------------


def _check_layout(spec: ParallelSpec, layout) -> None:
    """Refuse a ``mesh.Layout`` whose degrees are not the spec's on its
    own number of ranks."""
    n = 1
    for size in layout.sizes.values():
        n *= size
    declared = spec.sizes(n)
    for axis, size in declared.items():
        have = layout.sizes.get("slices" if axis == SLICE_AXIS else axis, 1)
        if int(have) != int(size):
            raise SpecError(
                f"mesh axis {axis!r} has size {have} "
                f"but spec '{spec.canonical()}' declares {size} — lower "
                f"the spec onto the mesh it built (mesh.build("
                f"spec.sizes(n), rank))")


def lower(spec: ParallelSpec, layout, model=None, *,
          weight_update: str = "replicated", wire_format: str | None = None,
          fusion_threshold: int | None = None, tp_rules=None,
          grad_reduce: str | None = None, hier: str | None = None,
          wire_format_dcn: str | None = None) -> dict:
    """Map a spec onto keyword arguments of the port's
    ``parallel.step.make_train_step(loss_fn, **kwargs)`` for the rank
    whose ``mesh.Layout`` is ``layout`` (built from the spec's sizes).

    The JAX module's three lowering classes, with its refusals:

      * pure data-parallel (only ``dp``/``slices`` above 1): the
        replicated step, whose ``weight_update`` (zero1),
        ``wire_format`` (int8-block), ``fusion_threshold`` and
        ``grad_reduce`` (``"adasum"``) stay orthogonal modifiers; Adasum
        refuses the others, and the DCN wire needs ``hier="hier"``.  The
        two-level lowering itself (``hier``) is not ported: it raises
        ``NotImplementedError`` once the spec validates;
      * sequence-parallel (``sp`` above 1, weights replicated): the
        replicated step, whose reduction group (the world) spans data and
        seq; the trainer hands the model its seq ring.  The modifiers do
        not compose;
      * weight-sharded (``fsdp``/``tp``/``ep`` above 1): the sharded-state
        step, ``{"layout": layout}``, after the placement
        (``fsdp.state_shardings`` of the whole ``model``, with
        ``tp_rules`` for ``tp``/``ep``) is checked to exist.  ``model``
        (the TrainState's) is required, ``tp``/``ep`` require
        ``tp_rules``, and ``sp`` and the modifiers do not compose.

    ``pp`` lowers through :func:`lower_pp`, not here."""
    _check_layout(spec, layout)
    if spec.pp > 1:
        raise SpecError(
            f"spec '{spec.canonical()}': pp does not lower through "
            f"make_train_step — use lower_pp(), which drives the pp_lm "
            f"GPipe harness")
    wire_format = wire_format or "fp"
    grad_reduce = grad_reduce or "mean"
    hier = hier or "flat"
    wire_format_dcn = wire_format_dcn or "fp"
    if grad_reduce not in ("mean", "adasum"):
        raise SpecError(f"grad_reduce={grad_reduce!r} — expected 'mean' "
                        f"or 'adasum'")
    modified = (weight_update != "replicated" or wire_format != "fp"
                or fusion_threshold is not None or hier != "flat"
                or wire_format_dcn != "fp")
    if spec.fsdp > 1 or spec.tp > 1 or spec.ep > 1:
        if spec.sp > 1:
            raise SpecError(
                f"spec '{spec.canonical()}': sp is a shard_map batch "
                f"partition and does not compose with the auto-SPMD "
                f"weight-sharded lowering")
        if modified or grad_reduce != "mean":
            raise SpecError(
                f"spec '{spec.canonical()}': weight-sharded lowering is "
                f"auto-SPMD — zero1/wire_format/fusion_threshold/adasum/"
                f"hier are shard_map modifiers and do not compose")
        if (spec.tp > 1 or spec.ep > 1) and tp_rules is None:
            raise SpecError(
                f"spec '{spec.canonical()}' shards weights over the "
                f"model/expert axis — pass tp_rules (e.g. "
                f"tp.rules_for_model(...)); without them the axis would "
                f"silently replicate")
        if model is None:
            raise SpecError(
                f"spec '{spec.canonical()}' shards weights — lowering "
                f"needs the TrainState's model to build the placement")
        from tpuframe_torch.parallel import fsdp

        try:
            fsdp.state_shardings(model, layout.sizes, tp_rules)
        except ValueError as e:
            raise SpecError(f"spec '{spec.canonical()}': {e}") from e
        return {"layout": layout}
    if spec.sp > 1:
        if modified or grad_reduce != "mean":
            raise SpecError(
                f"spec '{spec.canonical()}': sp shards activations, not "
                f"weights — zero1/wire_format/fusion_threshold/adasum/"
                f"hier assume batch-only sharding and do not compose")
        return {"weight_update": weight_update, "wire_format": wire_format,
                "fusion_threshold": fusion_threshold}
    if grad_reduce == "adasum" and modified:
        raise SpecError(
            f"spec '{spec.canonical()}': adasum's ppermute butterfly is "
            f"its own wire pattern — zero1/wire_format/fusion_threshold/"
            f"hier do not compose")
    if wire_format_dcn != "fp" and hier != "hier":
        raise SpecError(
            f"spec '{spec.canonical()}': wire_format_dcn="
            f"{wire_format_dcn!r} is the DCN leg of the two-level "
            f"lowering — it needs hier='hier'")
    if hier != "flat":
        raise NotImplementedError(
            f"spec '{spec.canonical()}' with hier={hier!r}: hierarchical "
            f"collectives are not ported yet (ROADMAP.md queue 1, item "
            f"12)")
    return {"weight_update": weight_update, "wire_format": wire_format,
            "fusion_threshold": fusion_threshold, "grad_reduce": grad_reduce}


def lower_pp(spec: ParallelSpec, layout, model, *, n_micro: int = 2,
             fused_xent: bool = False):
    """Lower a ``pp`` spec onto the GPipe step: validate as the JAX
    ``lower_pp`` does, then ``pp_lm.make_pp_lm_step(model.cfg, layout,
    ...)`` for ``model``, a ``ScanBlockLM`` whose layers the ``pp``
    degree divides (the step checks it)."""
    _check_layout(spec, layout)
    if spec.pp <= 1:
        raise SpecError(f"spec '{spec.canonical()}' declares no pipeline "
                        f"axis — lower_pp needs pp > 1")
    if spec.fsdp > 1 or spec.tp > 1 or spec.ep > 1 or spec.sp > 1:
        raise SpecError(
            f"spec '{spec.canonical()}': the GPipe harness composes pp "
            f"with dp only — fsdp/tp/ep/sp do not lower through it")
    from tpuframe_torch.parallel import pp_lm

    return pp_lm.make_pp_lm_step(model.cfg, layout, n_micro=n_micro,
                                 fused_xent=fused_xent)


# ---------------------------------------------------------------------------
# The grammar's self-check: the JAX module's pinned case tables.
# ---------------------------------------------------------------------------

#: (text, canonical) pairs the grammar must round-trip byte-exactly.
_ROUNDTRIP_CASES = (
    ("dp=8", "dp=8"),
    ("dp=*", "dp=*"),
    (" dp = 4 , fsdp = 2 ", "dp=4,fsdp=2"),
    ("dp=4,fsdp=2,tp=1;slices=2", "dp=4,fsdp=2;slices=2"),
    ("dp=2,fsdp=2;slices=2", "dp=2,fsdp=2;slices=2"),
    ("fsdp=2", "dp=1,fsdp=2"),
    ("dp=1,tp=4;slices=4", "dp=1,tp=4;slices=4"),
    ("dp=*,ep=2", "dp=*,ep=2"),
    ("dp=2,tp=4", "dp=2,tp=4"),
    ("tp=2,dp=2", "dp=2,tp=2"),
    ("dp=*,tp=2", "dp=*,tp=2"),
    ("dp=2,pp=4", "dp=2,pp=4"),
    ("pp=2", "dp=1,pp=2"),
    ("dp=*,pp=2;slices=2", "dp=*,pp=2;slices=2"),
    ("dp=2,sp=4", "dp=2,sp=4"),
    ("sp=2,dp=*", "dp=*,sp=2"),
    ("ep=2,dp=4", "dp=4,ep=2"),
    ("dp=2,sp=2,ep=1,pp=1", "dp=2,sp=2"),
    ("dp=2,tp=2,pp=2;slices=2", "dp=2,tp=2,pp=2;slices=2"),
)

#: specs the parser must REJECT (malformed grammar).
_MALFORMED_CASES = (
    "", "   ", ";slices=2", "dp", "dp=", "=4", "dp=4,", "dp=x",
    "dp=0", "dp=-2", "fsdp=*", "bogus=2", "dp=2,dp=4",
    "dp=2;slices=0", "dp=2;slices=x", "dp=2;foo=2", "dp=2;slices=",
    "tp=*", "pp=*", "sp=*", "ep=*", "tp=0", "pp=-1", "sp=x",
    "ep=", "dp=2,tp=2,tp=4", "dp=2,sp=1.5",
)

#: (spec, n_devices) pairs that parse but must fail validation.
_OVERCOMMITTED_CASES = (
    ("dp=16", 8),
    ("dp=4,fsdp=4", 8),
    ("dp=4;slices=4", 8),
    ("dp=3", 8),
    ("tp=4,pp=4", 8),
    ("dp=2,sp=8", 8),
    ("dp=2,tp=2,ep=4", 8),
    ("dp=*,pp=16", 8),
    ("dp=2,tp=2;slices=4", 8),
)


def _grammar_problems() -> list:
    """Every way the grammar fails its pinned cases (empty: none)."""
    problems = []
    for text, want in _ROUNDTRIP_CASES:
        try:
            spec = parse_spec(text)
        except SpecError as e:
            problems.append(f"pspec grammar: {text!r} must parse, "
                            f"got SpecError: {e}")
            continue
        got = spec.canonical()
        if got != want:
            problems.append(f"pspec grammar: {text!r} formats to {got!r}, "
                            f"expected {want!r}")
        elif parse_spec(got) != spec:
            problems.append(f"pspec grammar: {got!r} does not round-trip")
    for text in _MALFORMED_CASES:
        try:
            parse_spec(text)
        except SpecError:
            continue
        problems.append(f"pspec grammar: malformed {text!r} parsed "
                        f"without error — the validator is blind")
    for text, n in _OVERCOMMITTED_CASES:
        try:
            parse_spec(text).sizes(n)
        except SpecError:
            continue
        problems.append(f"pspec grammar: {text!r} validated on {n} "
                        f"devices — overcommit must be rejected")
    return problems
