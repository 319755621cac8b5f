"""The precision probe: an f32 matrix product at three precisions.

``csrc/precision_probe.cu`` replaces the TPU kernel
``perf/exp_precision_probe.py:kernel``, a 256 x 256 f32 ``dot_general``
whose error against a float64 product shows what precision an f32 product
inside a kernel keeps.  Here the modes are named as PyTorch names f32
matmul precision (``torch.set_float32_matmul_precision``):

  - ``"highest"``: f32 FMAs on the CUDA cores (the probe's ``HIGHEST``);
  - ``"medium"``: one TF32 pass on the tensor cores, each operand rounded
    to 10 mantissa bits (the probe's ``DEFAULT`` and ``None``);
  - ``"high"``: 3xTF32, ``big.big + big.small + small.big`` with ``big =
    tf32(x)`` and ``small = tf32(x - big)``.

The answer bears on the f32 flash-attention backward: whether its products
could move to the tensor cores and still hold f32 gradients to 1e-4.

:func:`matmul_reference` is the plain version of each mode: it rounds the
operands as the kernel does and sums exact f32 products, so kernel and
plain version differ in summation order only.  :func:`matmul` launches the
kernel for a CUDA tensor and runs the plain version for a CPU one;
:func:`probe` is the probe itself.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from tpuframe_torch import _device

MODES = ("highest", "high", "medium")
SIZE = 256

# Launches of the CUDA kernel in this process.
LAUNCHES = {"precision_probe": 0}

_fns: dict = {}


def _kernel():
    if not _fns:
        from tpuframe_torch import _build

        lib = _build.load("precision_probe")
        fn = lib.tf_precision_probe
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        err = lib.tf_precision_probe_error_string
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        _fns["fn"], _fns["err"] = fn, err
    return _fns["fn"], _fns["err"]


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 rounded to TF32's 10 mantissa bits, to nearest with ties away
    from zero (``cvt.rna.tf32.f32``), kept as f32."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _f32_products(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` as a sum of f32 products, each rounded to f32 (exact when
    both factors are TF32 values), in 64-row slices."""
    return torch.cat([(a[i:i + 64, :, None] * b[None]).sum(dim=1)
                      for i in range(0, a.shape[0], 64)])


def _check(x, y, mode):
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}; got {mode!r}")
    if x.ndim != 2 or y.ndim != 2 or x.shape[1] != y.shape[0]:
        raise ValueError(f"want x [M, K] and y [K, N]; got {tuple(x.shape)} "
                         f"and {tuple(y.shape)}")
    if x.dtype != torch.float32 or y.dtype != torch.float32:
        raise TypeError(f"the probe multiplies f32; got {x.dtype}, "
                        f"{y.dtype}")
    if x.device != y.device:
        raise ValueError("x and y lie on different devices")


def matmul_reference(x, y, mode):
    """The plain version of the kernel in ``mode``."""
    _check(x, y, mode)
    if mode == "highest":
        return _f32_products(x, y)
    bx, by = round_tf32(x), round_tf32(y)
    if mode == "medium":
        return _f32_products(bx, by)
    sx, sy = round_tf32(x - bx), round_tf32(y - by)
    # big.big + big.small + small.big as one sum over 3K products
    return _f32_products(torch.cat([bx, bx, sx], dim=1),
                         torch.cat([by, sy, by], dim=0))


def matmul(x, y, mode):
    """``x @ y`` in ``mode``: the kernel for CUDA tensors, the plain
    version for CPU ones."""
    _check(x, y, mode)
    if x.device.type == "cpu":
        return matmul_reference(x, y, mode)
    if x.device.type != "cuda":
        raise ValueError(f"the probe runs on cuda or cpu, not {x.device}")
    x, y = x.contiguous(), y.contiguous()
    m, k = x.shape
    n = y.shape[1]
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    fn, err_str = _kernel()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), y.data_ptr(), out.data_ptr(), m, n, k,
                 MODES.index(mode), stream)
    if err != 0:
        raise RuntimeError(f"precision_probe kernel launch failed: "
                           f"{err_str(err).decode()} ({err})")
    LAUNCHES["precision_probe"] += 1
    return out


def inputs(seed: int = 0, size: int = SIZE, device="cpu"):
    """The probe's operands: two ``[size, size]`` f32 matrices of standard
    normals from ``numpy.random.default_rng(seed)``, x drawn first."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(size, size)).astype(np.float32)
    y = rng.normal(size=(size, size)).astype(np.float32)
    return (torch.from_numpy(x).to(device), torch.from_numpy(y).to(device))


def probe(mode, *, device="cuda", seed: int = 0) -> float:
    """The probe in ``mode``: max |x.y - x.y in float64| over the probe's
    256 x 256 operands."""
    x, y = inputs(seed, device=_device.resolve(device))
    out = matmul(x, y, mode)
    ref = x.double() @ y.double()
    return float((out.double() - ref).abs().max())
