"""tpuframe_torch — tpuframe ported to PyTorch and CUDA on an NVIDIA H100.

The JAX package ``tpuframe`` is the reference; this package mirrors its
module names so that each counterpart is easy to find.  It imports
``torch`` and never ``jax`` or ``tpuframe``.  Each Pallas TPU kernel on a
ported path is a hand-written Hopper kernel under ``csrc/``, built at
first use (``tpuframe_torch._build``).

Entry points run on ``device="cuda"`` unless the caller asks for the CPU,
where every kernel's wrapper takes its plain PyTorch version.
"""

__version__ = "0.1.0"
