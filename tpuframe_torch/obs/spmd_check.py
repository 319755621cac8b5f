"""SPMD-divergence checks (counterpart of ``tpuframe/obs/spmd_check.py``).

Ranks of one world must issue the same collectives in the same order:
gloo and NCCL match collectives by issue order, so a rank that builds
another step (a config drift, a host-dependent code path, a per-rank
knob such as ``TPUFRAME_FUSION_THRESHOLD`` set differently) hangs the
world or sums gradients of different parameters.  In debug mode
(``TPUFRAME_CHECK_SPMD=1``) every rank hashes its config and its step
program, and the hashes are compared with one object allgather before
the first step.

The JAX package hashes the step's lowered StableHLO.  An eager PyTorch
step has no program text, so :func:`step_program` writes down what
decides the step's collective sequence instead: the parameters' names,
shapes and dtypes in the staged pass's plan order, ``grad_reduce`` and
``accum_steps``, the mesh's degrees and the model's ``seq_mode`` (which
decide the seq rings' collectives in the forward and the backward), the
fusion threshold with its bucket census, the weight update and the wire
format (with zero1, the padded flat layout's census), the
statistics-and-metrics reduction (the float buffers and the metric names,
with its census), and in the sharded-state mode each split parameter's
spec (which of its dims the fsdp, expert and model axes split: which
blocks a rank gathers and reduce-scatters) and the batch degree (data x
fsdp, the ranks the means run over); with a pipe degree (in the mesh's
degrees), the microbatch count, which with it decides the pipeline's
ticks and rotations, and the stage split of every block leaf (its
spec).  Two ranks whose descriptions agree
issue the same collectives on tensors of the same sizes; everything else
the step does is local.
"""

from __future__ import annotations

import hashlib
import json

from torch import nn

from tpuframe_torch.parallel import bootstrap, fusion, zero1


def digest(payload: bytes | str) -> str:
    if isinstance(payload, str):
        payload = payload.encode()
    return hashlib.sha256(payload).hexdigest()


def assert_uniform_across_hosts(tag: str, payload: bytes | str) -> None:
    """Raise RuntimeError on every rank if any rank's payload hash
    differs (a no-op in one process)."""
    if bootstrap.process_count() == 1:
        return
    mine = digest(payload)
    everyone = bootstrap.allgather_object(mine)
    bad = [i for i, d in enumerate(everyone) if d != mine]
    if bad:
        raise RuntimeError(
            f"SPMD divergence in {tag!r}: host {bootstrap.process_index()} "
            f"disagrees with host(s) {bad} — hosts are about to run "
            f"different programs. Check for config drift / per-rank knobs "
            f"(TPUFRAME_FUSION_THRESHOLD) / host-dependent branches / "
            f"unseeded randomness.")


def step_program(model: nn.Module, *, grad_reduce: str, accum_steps: int,
                 fusion_threshold: int | None,
                 metric_names: tuple, mesh: dict | None = None,
                 seq_mode: str = "none", weight_update: str = "replicated",
                 wire_format: str = "fp",
                 pp_microbatches: int | None = None) -> dict:
    """What decides the train step's collective sequence (module
    docstring).  The metrics are named, not shaped: they are 0-d, and
    their dtypes follow from the config, which is checked beside this."""
    params = fusion.plan_params(model)
    stats = [(name, b) for name, b in model.named_buffers()
             if b.is_floating_point()]
    out = {
        "params": [(name, tuple(p.shape), str(p.dtype))
                   for name, p in params],
        "grad_reduce": grad_reduce,
        "accum_steps": int(accum_steps),
        "mesh": dict(mesh or {}),
        "seq_mode": seq_mode,
        "fusion_threshold": fusion_threshold,
        "weight_update": weight_update,
        "wire_format": wire_format,
        "stats": [(name, tuple(b.shape), str(b.dtype))
                  for name, b in stats],
        "metrics": sorted(metric_names),
    }
    specs = getattr(model, "shard_specs", {})
    if specs:
        out["shard_specs"] = {name: list(spec)
                              for name, spec in sorted(specs.items())}
        out["batch_degree"] = ((mesh or {}).get("data", 1)
                               * (mesh or {}).get("fsdp", 1))
    if (mesh or {}).get("pipe", 1) > 1:
        # the pipeline's schedule: its ticks and their rotations
        out["pp_microbatches"] = int(pp_microbatches or 0)
    if weight_update == "zero1":
        n = (mesh or {}).get("data", 1)
        out["zero1_census"] = {
            k: v for k, v in zero1.padding_census(model, n).items()
            if k != "leaves"}
    if fusion_threshold is not None:
        out["grad_census"] = fusion.bucket_census(
            [p for _, p in params], fusion_threshold)
        out["stats_census"] = fusion.bucket_census(
            [b for _, b in stats], fusion_threshold)
    return out


def check_step_program(model: nn.Module, tag: str, **program) -> None:
    """Hash :func:`step_program` across the ranks (a no-op in one
    process); ``program`` is its keyword arguments."""
    assert_uniform_across_hosts(
        f"{tag}:program",
        json.dumps(step_program(model, **program), sort_keys=True))
