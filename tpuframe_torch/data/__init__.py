"""Datasets, the sharded, prefetching loader and the storage paths of the
checkpoints (counterpart of ``tpuframe/data``)."""
