"""Process bootstrap: ``hvd.init()`` on ``torch.distributed`` (counterpart
of ``tpuframe/parallel/bootstrap.py``).

The JAX package joins its hosts through ``jax.distributed.initialize`` (a
GRPC coordinator), after which one process sees every chip of its host.
Here there is one process per card, as in Horovod, and the world is a
``torch.distributed`` process group made from the environment contract
the launchers set (``tpuframe_torch.launch.launcher.LocalCluster`` here,
``tpuframe.launch`` in the JAX package):

    TPUFRAME_COORDINATOR=host:port   rank 0's TCP store
    TPUFRAME_NUM_PROCESSES=N         the world size
    TPUFRAME_PROCESS_ID=r            this process's rank
    TPUFRAME_DIST_BACKEND=nccl|gloo  the port's own; by default nccl when
                                     the process runs on CUDA, gloo on
                                     the CPU

:func:`initialize` is idempotent and a no-op without a coordinator, so the
same ``train.py`` runs as one process or as N.  The backend is the one
named and nothing switches it on failure: two NCCL ranks on one card fail
with NCCL's own error.  On the card each rank takes
``cuda:{local_rank % device_count}`` before its first NCCL collective
creates the communicator.  ``local_rank`` and ``local_size`` come from one
gather of the hostnames at start-up, since Horovod groups ranks by host.

The object verbs and the host barrier run over gloo: the default group
when it is gloo, else a gloo group made at start-up.  Pickled objects are
host data, and the hostname gather must run before any card is chosen.
"""

from __future__ import annotations

import os
import socket
from dataclasses import dataclass

import torch
import torch.distributed as dist

from tpuframe_torch import _device
from tpuframe_torch.parallel import collectives, fusion

ITEM_12 = "ROADMAP.md queue 1, item 12 (beyond-DP parallelism)"
# Horovod's tensor-fusion knob, which the JAX package never reads, and the
# JAX package's, which the port reads (parallel/fusion.py).
FUSION_ENV = ("HOROVOD_FUSION_THRESHOLD", "TPUFRAME_FUSION_THRESHOLD")

# owned: this module made the default group (and destroys it at shutdown);
# host_group: the gloo group of the object verbs when the default group is
# not gloo; local: (local_rank, local_size).
_STATE = {"initialized": False, "owned": False, "host_group": None,
          "local": (0, 1)}


def default_backend(device="cuda") -> str:
    """NCCL for a process on CUDA, gloo for one on the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


@dataclass(frozen=True)
class DistConfig:
    """Explicit multi-process wiring; every field defaults from the
    environment the launcher exports on each worker."""

    coordinator_address: str | None = None  # host:port of process 0
    num_processes: int | None = None
    process_id: int | None = None
    backend: str | None = None      # None: default_backend(device)

    @classmethod
    def from_env(cls, device="cuda") -> "DistConfig":
        def _int(name: str) -> int | None:
            v = os.environ.get(name)
            return int(v) if v is not None else None

        return cls(
            coordinator_address=os.environ.get("TPUFRAME_COORDINATOR"),
            num_processes=_int("TPUFRAME_NUM_PROCESSES"),
            process_id=_int("TPUFRAME_PROCESS_ID"),
            backend=(os.environ.get("TPUFRAME_DIST_BACKEND")
                     or default_backend(device)),
        )


def check_fusion_env() -> None:
    """``TPUFRAME_FUSION_THRESHOLD`` must parse (``ValueError`` naming it
    otherwise).  ``HOROVOD_FUSION_THRESHOLD`` raises
    ``NotImplementedError``: the JAX package never reads it, and ignoring
    it would run another reduction than the one asked for."""
    val = os.environ.get(FUSION_ENV[0], "").strip()
    if val:
        raise NotImplementedError(
            f"{FUSION_ENV[0]}={val!r}: the port's bucketed fusion reads "
            f"{FUSION_ENV[1]} (the JAX package's knob), not Horovod's; set "
            f"that instead")
    fusion.threshold_from_env()


def initialize(config: DistConfig | None = None, device="cuda") -> None:
    """Idempotent distributed bootstrap for a process that runs on
    ``device``.

    No coordinator configured: no group is made.  With one:
    ``dist.init_process_group(backend, init_method="tcp://<coordinator>",
    world_size, rank)``.  Whenever a default group then exists (this
    call's, or one the caller made, e.g. under torchrun) the ranks gather
    their hostnames for ``local_rank``/``local_size``, and a process on
    CUDA sets its device.  Every rank calls this collectively."""
    if _STATE["initialized"]:
        return
    check_fusion_env()
    cfg = config or DistConfig.from_env(device)
    if cfg.coordinator_address is not None:
        if cfg.num_processes is None or cfg.process_id is None:
            raise ValueError("TPUFRAME_COORDINATOR needs "
                             "TPUFRAME_NUM_PROCESSES and TPUFRAME_PROCESS_ID")
        _device.resolve(device)
        dist.init_process_group(
            cfg.backend or default_backend(device),
            init_method=f"tcp://{cfg.coordinator_address}",
            world_size=cfg.num_processes, rank=cfg.process_id)
        _STATE["owned"] = True
    if collectives.process_group() is not None:
        dev = _device.resolve(device)
        if dist.get_backend() != "gloo":
            _STATE["host_group"] = dist.new_group(backend="gloo")
        hosts = allgather_object(socket.gethostname())
        rank = dist.get_rank()
        same = [i for i, h in enumerate(hosts) if h == hosts[rank]]
        _STATE["local"] = (same.index(rank), len(same))
        if dev.type == "cuda":
            torch.cuda.set_device(_STATE["local"][0]
                                  % torch.cuda.device_count())
    _STATE["initialized"] = True


def is_initialized() -> bool:
    return _STATE["initialized"]


def _objects_group():
    """The group of the object verbs (None: no world)."""
    if collectives.process_group() is None:
        return None
    return _STATE["host_group"] or dist.group.WORLD


def host_barrier(tag: str) -> None:
    """Cross-process sync point.  ``tag`` names the rendezvous: the ranks
    gather their tags, and unrelated barriers that meet raise instead of
    releasing each other."""
    if _objects_group() is None:
        return
    tags = allgather_object(tag)
    if len(set(tags)) > 1:
        raise RuntimeError(f"host_barrier({tag!r}) met other barriers: "
                           f"{tags}")


def shutdown() -> None:
    """Destroy the groups this module made; a later :func:`initialize`
    starts afresh."""
    if _STATE["owned"] and dist.is_initialized():
        dist.destroy_process_group()
    elif _STATE["host_group"] is not None and dist.is_initialized():
        dist.destroy_process_group(_STATE["host_group"])
    _STATE.update(initialized=False, owned=False, host_group=None,
                  local=(0, 1))


def process_index() -> int:
    """This process's rank (Horovod's ``hvd.rank()``: one process a
    card): the group rank when a process group exists, else
    ``TPUFRAME_PROCESS_ID``, else 0.  The event log's ``proc`` and the
    fault registry's ``rank=`` read it, so that processes with no group
    (the serving fleet's replicas and router) keep their own ids, as the
    JAX package's ``_process_index`` does.  Under every launcher of the
    repo the group rank and the variable agree."""
    if collectives.process_group() is not None:
        return collectives.world()[1]
    env = os.environ.get("TPUFRAME_PROCESS_ID", "").strip()
    return int(env) if env else 0


def process_count() -> int:
    return collectives.world()[0]


def local_rank() -> int:
    """This process's index among the ranks on its host."""
    return _STATE["local"][0]


def local_size() -> int:
    return _STATE["local"][1]


def is_primary() -> bool:
    """True on the rank that owns logging and eval summaries (the
    reference's ``if hvd.rank() == 0`` gates)."""
    return process_index() == 0


def broadcast_object(obj, root: int = 0):
    """``root``'s picklable object on every process (Horovod
    ``hvd.broadcast_object``); every process calls it.  Pickle is the wire
    format, as in Horovod and ``torch.distributed``: the peers of a
    training job trust each other."""
    if not 0 <= root < process_count():
        raise ValueError(f"broadcast_object root {root} out of range for "
                         f"{process_count()} processes")
    grp = _objects_group()
    if grp is None:
        return obj
    box = [obj if process_index() == root else None]
    dist.broadcast_object_list(box, src=root, group=grp)
    return box[0]


def allgather_object(obj) -> list:
    """One picklable object per process, in process order on every
    process (Horovod ``hvd.allgather_object``); payloads may differ in
    size."""
    grp = _objects_group()
    if grp is None:
        return [obj]
    out = [None] * process_count()
    dist.all_gather_object(out, obj, group=grp)
    return out
