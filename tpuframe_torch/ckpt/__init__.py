"""Checkpointing of the port (counterpart of ``tpuframe/ckpt``), on the JAX
package's on-disk contract: see :mod:`tpuframe_torch.ckpt.checkpoint`."""

from tpuframe_torch.ckpt.checkpoint import (  # noqa: F401
    CheckpointManager,
    committed_world,
    in_flight_step,
    latest_step,
    quarantine_step,
    restore,
    save,
)
