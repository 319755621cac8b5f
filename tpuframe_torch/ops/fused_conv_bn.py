"""Fused 1x1-conv + BatchNorm training op: a hand-written Hopper backward
and its plain version (counterpart of ``tpuframe/ops/fused_conv_bn.py``).

``conv1x1_bn_train`` is a 1x1 convolution followed by training-mode
BatchNorm, as a :class:`torch.autograd.Function`:

  - forward (plain PyTorch, as XLA computes it in the JAX package): the
    conv as a matmul on the ``[M, K]`` view, f32 statistics with ``var =
    max(E[x^2] - mu^2, 0)``, and the affine in the compute dtype;
  - backward pass 1 (plain PyTorch): the two BN sums, ``dgamma`` and
    ``dbeta``, folded into per-channel coefficients ``s, u, c``;
  - backward pass 2: ``fused_conv_bn_bwd`` (``csrc/fused_conv_bn.cu``),
    which replaces ``_bwd_kernel`` (the ``pallas_call`` in
    ``_fused_bwd_matmuls``): ``g = s*dy - u*x + c`` rounded once to the
    compute dtype, ``da = g.W^T`` and ``dW = a^T.g`` (f32), with ``g`` kept
    on the SM.

The gradients of the returned ``mean`` and ``var`` are ignored: they exist
for the running-statistics update, as in the JAX package.  A tensor on the
CPU goes to :func:`fused_bwd_reference`; a CUDA tensor launches the kernel
or raises.  The TPU kernel's VMEM gate (``_pick_tiles``) does not carry
over: the CUDA kernel masks its ragged edges, so every shape runs it.
"""

from __future__ import annotations

import ctypes

import torch

DTYPES = (torch.float32, torch.bfloat16)

# Launches of the CUDA kernel in this process: the count a run reads to
# show that its path went through it.
LAUNCHES = {"fused_conv_bn_bwd": 0}

# The dW reduction is split over rows until about this many blocks are in
# flight (132 SMs, a few blocks each).  The tile and step sizes are the dW
# kernel's (csrc/fused_conv_bn.cu: DW_BM, DW_BN, BKK); the kernel checks
# the split it is given, so a mismatch costs speed, not correctness.
_DW_TARGET_BLOCKS = 132 * 6
_DW_TILE = (64, 128)   # a dW block's (K, C) tile
_BKK = 16              # rows staged per step

_fns: dict = {}


def _kernel():
    """The ctypes functions of ``csrc/fused_conv_bn.cu``, built on first
    use."""
    if not _fns:
        from tpuframe_torch import _build

        lib = _build.load("fused_conv_bn")
        ptr = ctypes.c_void_p
        fn = lib.tf_fused_conv_bn_bwd
        fn.argtypes = ([ptr] * 8 + [ctypes.c_int64] + [ctypes.c_int] * 4
                       + [ptr])
        fn.restype = ctypes.c_int
        err = lib.tf_fused_conv_bn_error_string
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        _fns["bwd"] = (fn, err)
    return _fns["bwd"]


def dw_splits(m: int, k: int, c: int) -> tuple[int, int]:
    """``(splits, rows_per_split)`` of the dW kernel's row split: enough
    slices that about ``_DW_TARGET_BLOCKS`` blocks run, each slice a
    multiple of 16 rows and none empty."""
    tiles = -(-k // _DW_TILE[0]) * -(-c // _DW_TILE[1])
    want = max(1, min(-(-m // _BKK), -(-_DW_TARGET_BLOCKS // tiles)))
    rows = -(-(-(-m // want)) // _BKK) * _BKK
    return -(-m // rows), rows


def fused_bwd_reference(a, w, x, dy, coef):
    """The plain version of the kernel: ``a [M, K]``, ``w [K, C]`` in the
    compute dtype, ``x``, ``dy [M, C]``, ``coef [3, C]`` f32 (rows s, u,
    c).  Returns ``(da [M, K] in a's dtype, dW [K, C] f32)``.  ``g = s*dy
    - u*x + c`` is computed in f32 and rounded to w's dtype before both
    products, where the TPU kernel rounds it."""
    _check(a, w, x, dy, coef)
    s, u, cc = coef[0], coef[1], coef[2]
    g = (s * dy.float() - u * x.float() + cc).to(w.dtype).float()
    da = (g @ w.float().T).to(a.dtype)
    dw = a.float().T @ g
    return da, dw


def _check(a, w, x, dy, coef):
    if a.ndim != 2 or w.ndim != 2 or x.ndim != 2 or dy.ndim != 2:
        raise ValueError(f"fused_conv_bn backward wants a [M, K], w [K, C], "
                         f"x and dy [M, C]; got a {tuple(a.shape)} w "
                         f"{tuple(w.shape)} x {tuple(x.shape)} dy "
                         f"{tuple(dy.shape)}")
    m, k = a.shape
    c = w.shape[1]
    if w.shape[0] != k or x.shape != (m, c) or dy.shape != (m, c):
        raise ValueError(f"shapes do not agree: a {tuple(a.shape)} w "
                         f"{tuple(w.shape)} x {tuple(x.shape)} dy "
                         f"{tuple(dy.shape)}")
    if tuple(coef.shape) != (3, c) or coef.dtype != torch.float32:
        raise ValueError(f"coef must be f32 [3, {c}]; got {coef.dtype} "
                         f"{tuple(coef.shape)}")
    if not a.dtype == w.dtype == x.dtype == dy.dtype:
        raise ValueError(f"a, w, x, dy dtypes differ: {a.dtype} {w.dtype} "
                         f"{x.dtype} {dy.dtype}")
    if len({t.device for t in (a, w, x, dy, coef)}) != 1:
        raise ValueError("a, w, x, dy, coef lie on different devices")


def _launch(a, w, x, dy, coef):
    if a.dtype not in DTYPES:
        raise TypeError(f"fused_conv_bn kernel takes {DTYPES}; got {a.dtype}")
    if not all(t.is_contiguous() for t in (a, w, x, dy, coef)):
        raise ValueError("fused_conv_bn kernel needs contiguous operands")
    m, k = a.shape
    c = w.shape[1]
    splits, _ = dw_splits(m, k, c)
    da = torch.empty((m, k), dtype=a.dtype, device=a.device)
    dw = torch.empty((k, c), dtype=torch.float32, device=a.device)
    ws = (torch.empty((splits, k, c), dtype=torch.float32, device=a.device)
          if splits > 1 else None)
    fn, err_str = _kernel()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = fn(a.data_ptr(), w.data_ptr(), x.data_ptr(), dy.data_ptr(),
                 coef.data_ptr(), da.data_ptr(), dw.data_ptr(),
                 None if ws is None else ws.data_ptr(), m, k, c, splits,
                 int(a.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"fused_conv_bn_bwd kernel launch failed: "
                           f"{err_str(err).decode()} ({err})")
    LAUNCHES["fused_conv_bn_bwd"] += 1
    return da, dw


def fused_bwd(a, w, x, dy, coef):
    """The kernel (CUDA) or its plain version (CPU): ``(da, dW)``."""
    _check(a, w, x, dy, coef)
    if a.device.type == "cuda":
        return _launch(a, w, x, dy, coef)
    if a.device.type != "cpu":
        raise ValueError(f"fused_conv_bn runs on cuda or cpu, not "
                         f"{a.device}")
    return fused_bwd_reference(a, w, x, dy, coef)


def _affine(x, gamma, beta, mean, var, eps):
    """``x * aa + bb`` in x's (the compute) dtype, ``aa = gamma *
    rsqrt(var + eps)`` and ``bb = beta - mean * aa`` folded in f32."""
    r = torch.rsqrt(var + eps)
    aa = gamma.float() * r
    bb = beta.float() - mean * aa
    return x * aa.to(x.dtype) + bb.to(x.dtype)


def _fwd_math(a, w, gamma, beta, eps):
    """``tpuframe/ops/fused_conv_bn.py:_fwd_math`` on the ``[M, K]`` view:
    ``(y, mean, var, x)``; f32 batch statistics with the biased ``var =
    max(E[x^2] - mu^2, 0)``."""
    x = a @ w.to(a.dtype)
    xf = x.float()
    mean = xf.mean(dim=0)
    var = torch.clamp((xf * xf).mean(dim=0) - mean * mean, min=0.0)
    return _affine(x, gamma, beta, mean, var, eps), mean, var, x


class _ConvBN(torch.autograd.Function):
    """``(y, mean, var)`` of ``a [M, K]``, ``w [K, C]`` (f32), gamma and
    beta, with the JAX package's custom VJP (``_core_fwd`` /
    ``_core_bwd``)."""

    @staticmethod
    def forward(ctx, a, w, gamma, beta, eps):
        y, mean, var, x = _fwd_math(a, w, gamma, beta, eps)
        ctx.save_for_backward(a, w, x, mean, var, gamma)
        ctx.eps = eps
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        a, w, x, mean, var, gamma = ctx.saved_tensors
        m = x.shape[0]
        dy = dy.to(x.dtype).contiguous()
        # Pass 1: both BN reductions over (x, dy).
        r = torch.rsqrt(var + ctx.eps)
        dyf = dy.float()
        xhat = (x.float() - mean) * r
        sum_dy = dyf.sum(dim=0)
        sum_dyxhat = (dyf * xhat).sum(dim=0)
        # Folded per-channel coefficients for g = s*dy - u*x + c.
        gf = gamma.float()
        c1 = sum_dy / m
        c2 = sum_dyxhat / m
        s = gf * r
        u = gf * r * r * c2
        cc = u * mean - s * c1
        coef = torch.stack([s, u, cc]).contiguous()
        # Pass 2: the kernel.
        da, dw = fused_bwd(a.contiguous(), w.to(a.dtype).contiguous(), x,
                           dy, coef)
        # w is stored f32 and cast to the compute dtype in the forward; the
        # f32 dW already is the gradient through that cast.
        return (da, dw.to(w.dtype), sum_dyxhat.to(gamma.dtype),
                sum_dy.to(gamma.dtype), None)


def conv1x1_bn_train(a4, w, gamma, beta, *, eps: float = 1e-5):
    """1x1 conv (stride 1, no bias) + training-mode BatchNorm.

    ``a4 [N, H, W, K]`` activations in the compute dtype, ``w [K, C]`` f32
    (any strides), ``gamma``/``beta [C]`` f32.  Returns ``(y [N, H, W, C]``
    in a4's dtype, ``mean [C]`` f32, ``var [C]`` f32, biased``)``; ``y`` is
    differentiable in a4, w, gamma and beta, ``mean`` and ``var`` are
    not."""
    n, h, w_sp, k = a4.shape
    if w.shape[0] != k:
        raise ValueError(f"w {tuple(w.shape)} does not take {k} channels")
    y, mean, var = _ConvBN.apply(a4.reshape(n * h * w_sp, k), w, gamma,
                                 beta, float(eps))
    return y.view(n, h, w_sp, -1), mean, var


def conv1x1_bn_reference(a4, w, gamma, beta, *, eps: float = 1e-5):
    """The unfused composition, differentiable by autograd end to end:
    the same forward math as :func:`conv1x1_bn_train`."""
    n, h, w_sp, k = a4.shape
    y, mean, var, _ = _fwd_math(a4.reshape(n * h * w_sp, k), w, gamma, beta,
                                eps)
    return y.view(n, h, w_sp, -1), mean, var


def conv1x1_bn_eval(a4, w, gamma, beta, mean, var, *, eps: float = 1e-5):
    """Eval mode: the 1x1 conv and the affine fold of the running
    statistics in the compute dtype (``FusedConvBN`` with
    ``use_running_average``)."""
    n, h, w_sp, k = a4.shape
    x = a4.reshape(n * h * w_sp, k) @ w.to(a4.dtype)
    return _affine(x, gamma, beta, mean, var, eps).view(n, h, w_sp, -1)
