"""Flash attention forward: a hand-written Hopper kernel and its plain version.

Replaces the TPU kernel ``tpuframe/ops/flash_attention.py:_fwd_kernel``
(its ``pallas_call`` in ``_flash_fwd``).  The CUDA source is
``tpuframe_torch/csrc/flash_fwd.cu``; its header note says what bounds it on
the H100 and what its design does about that.  In short: one thread block
per (batch * head, 32 query rows) loops over K/V tiles staged in shared
memory, keeping the S x S scores on the SM; tiles above the diagonal are
skipped under ``causal``, and the ragged edge is masked in the kernel, so
every sequence length works (the TPU kernel's ``supported()`` tiling rule
does not carry over).

Public functions take the JAX package's layout, ``[batch, seq, heads,
head_dim]``.  A tensor on the CPU goes to :func:`flash_mha_reference`; a
CUDA tensor launches the kernel or raises.  Only the forward exists in
this slice: serving runs no backward.
"""

from __future__ import annotations

import ctypes

import torch

NEG_INF = -1e30  # softmax mask fill; finite so (x - x) stays 0, not nan
HEAD_DIMS = (16, 32, 64, 128, 256)
DTYPES = (torch.float32, torch.bfloat16)

# Launches of the CUDA kernel in this process: the count a run reads to
# show that its path went through the kernel.
LAUNCHES = 0

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        from tpuframe_torch import _build

        lib = _build.load("flash_fwd")
        fn = lib.tf_flash_fwd
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                       + [ctypes.c_int64] * 9
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.tf_flash_error_string.argtypes = [ctypes.c_int]
        lib.tf_flash_error_string.restype = ctypes.c_char_p
        _fn = (fn, lib.tf_flash_error_string)
    return _fn


def _check(q, k, v, mask):
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError(f"flash attention wants [B, S, N, D] tensors; got "
                         f"q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    b, _, n, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2:] != (n, d):
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if not q.dtype == k.dtype == v.dtype:
        raise ValueError(f"q, k, v dtypes differ: {q.dtype} {k.dtype} "
                         f"{v.dtype}")
    if not q.device == k.device == v.device:
        raise ValueError("q, k, v lie on different devices")
    if mask is not None and tuple(mask.shape) != (b, k.shape[1]):
        raise ValueError(f"mask {tuple(mask.shape)} is not [B, S_kv] = "
                         f"{(b, k.shape[1])}")


def flash_mha_reference(q, k, v, *, mask=None, causal=False):
    """The plain PyTorch version of the kernel: same semantics, no tiling.

    Returns ``(out [B, S, N, D] in q's dtype, lse [B, N, S] f32)``.  Scores
    in f32 scaled by ``D**-0.5``; masked entries give ``p = 0`` exactly; P
    is rounded to V's dtype before the PV product; a fully masked row
    gives a zero output and ``lse = NEG_INF``."""
    _check(q, k, v, mask)
    s_q, d = q.shape[1], q.shape[-1]
    s_kv = k.shape[1]
    s = torch.einsum("bqnd,bknd->bnqk", q.float(), k.float()) * d ** -0.5
    keep = torch.ones((1, 1, s_q, s_kv), dtype=torch.bool, device=q.device)
    if causal:
        keep = keep.tril()
    if mask is not None:
        keep = keep & (mask != 0)[:, None, None, :]
    s = torch.where(keep, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(keep, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l == 0.0, 1.0, l)
    out = torch.einsum("bnqk,bknd->bqnd", p.to(v.dtype).float(), v.float())
    out = out / l_safe.permute(0, 2, 1, 3)
    lse = torch.where(l == 0.0, NEG_INF, m + torch.log(l_safe))[..., 0]
    return out.to(q.dtype), lse


def _launch(q, k, v, mask, causal):
    global LAUNCHES
    if q.dtype not in DTYPES:
        raise TypeError(f"flash kernel takes {DTYPES}; got {q.dtype}")
    b, s_q, n, d = q.shape
    s_kv = k.shape[1]
    if d not in HEAD_DIMS:
        raise ValueError(f"flash kernel takes head_dim in {HEAD_DIMS}; "
                         f"got {d}")
    if min(t.stride(-1) for t in (q, k, v)) != 1:
        raise ValueError("flash kernel needs unit stride on head_dim")
    if mask is not None:
        if mask.device != q.device:
            raise ValueError("mask lies on another device than q")
        mask = mask.to(torch.int32).contiguous()
    out = torch.empty((b, s_q, n, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, n, s_q), dtype=torch.float32, device=q.device)
    fn, err_str = _kernel()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 None if mask is None else mask.data_ptr(),
                 out.data_ptr(), lse.data_ptr(),
                 b, n, s_q, s_kv, d, int(q.dtype == torch.bfloat16),
                 q.stride(0), q.stride(1), q.stride(2),
                 k.stride(0), k.stride(1), k.stride(2),
                 v.stride(0), v.stride(1), v.stride(2),
                 d ** -0.5, int(causal), stream)
    if err != 0:
        raise RuntimeError(f"flash_fwd kernel launch failed: "
                           f"{err_str(err).decode()} ({err})")
    LAUNCHES += 1
    return out, lse


def flash_mha_lse(q, k, v, *, mask=None, causal=False):
    """:func:`flash_mha` that also returns the logsumexp rows.

    Returns ``(out [B, S, N, D], lse [B, N, S] f32)``; fully masked rows
    report ``lse = NEG_INF`` and a zero output."""
    if q.device.type == "cpu":
        return flash_mha_reference(q, k, v, mask=mask, causal=causal)
    _check(q, k, v, mask)
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on cuda or cpu, not "
                         f"{q.device}")
    return _launch(q, k, v, mask, causal)


def flash_mha(q, k, v, *, mask=None, causal=False):
    """Flash multi-head attention forward.

    Args:
      q, k, v: ``[batch, seq, heads, head_dim]``, float32 or bfloat16.
      mask: optional ``[batch, seq_kv]`` key-padding mask, nonzero = attend.
      causal: query ``i`` attends keys ``j <= i``; key tiles wholly above
        the diagonal are skipped.

    Returns ``[batch, seq, heads, head_dim]`` in q's dtype."""
    return flash_mha_lse(q, k, v, mask=mask, causal=causal)[0]
