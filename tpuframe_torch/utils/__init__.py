"""Configs and the optimizer (counterpart of ``tpuframe/utils``)."""
