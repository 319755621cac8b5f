"""Observability of the port (counterpart of ``tpuframe/obs``): the
run-event log (:mod:`~tpuframe_torch.obs.events`), the stall watchdog
(``heartbeat``), request tracing (``tracing``), the live OpenMetrics
exporter (``exporter``), the SLO sentry (``slo``), the offline goodput
analysis (``goodput``) and its CLI, ``python -m tpuframe_torch.obs``."""
