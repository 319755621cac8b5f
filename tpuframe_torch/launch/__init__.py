"""Launchers (counterpart of ``tpuframe/launch``): ``LocalCluster``."""
