"""Model definitions (PyTorch counterparts of ``tpuframe.models``)."""
