"""Datasets and the sharded, prefetching loader (counterpart of
``tpuframe/data``)."""
