"""Observability of the port (counterpart of ``tpuframe/obs``): so far the
run-event log, :mod:`tpuframe_torch.obs.events`."""
