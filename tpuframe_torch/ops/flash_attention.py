"""Flash attention: hand-written Hopper kernels and their plain versions.

Three kernels replace the TPU kernels of ``tpuframe/ops/flash_attention.py``:

  - ``flash_fwd`` (``csrc/flash_fwd.cu``) replaces ``_fwd_kernel`` (its
    ``pallas_call`` in ``_flash_fwd``): one thread block per (batch * head,
    tile of query rows) loops over K/V tiles staged in shared memory,
    keeping the S x S scores on the SM.
  - ``flash_bwd_dq`` and ``flash_bwd_dkv`` (``csrc/flash_bwd.cu``) replace
    ``_bwd_dq_kernel`` and ``_bwd_dkv_kernel`` (the two ``pallas_call``s in
    ``_flash_bwd``): the FA2 split, one kernel owning query rows and one
    owning keys, each recomputing the probabilities from the saved
    logsumexp, with no atomics.
  - ``flash_bwd_delta`` (``flash_bwd_delta_tc_kernel`` on the tensor
    cores, the CUDA-core dq kernel in its delta mode otherwise) computes
    the rows' ``delta`` that both take, where ``_flash_bwd`` computes
    ``rowsum(dO * O)`` in XLA: ``sum_j p * dp / sum_j p`` from the same
    recomputed p and dp, so that each row's ``ds`` sums to zero.  The
    rounded output's error in ``rowsum(dO * O)`` is a per-row offset that
    outweighs query and key gradients of ~1e-3 of the rest (BERT's upper
    layers) in bf16.  The sums run in f32 within a key tile of
    :data:`DELTA_BLOCK` keys and in f64 across tiles: a serial f32 sum
    over a long row loses those gradients' last digits in f32.

Every kernel has two routes, chosen from the dtype and head_dim alone
(:func:`fwd_route`, :func:`bwd_route`): bf16 at head_dim 64 or 128 runs on
the tensor cores (``wgmma``), everything else on the CUDA cores;
:data:`FWD_ROUTES` and :data:`BWD_ROUTES` count the launches of each.

Each source's header note says what bounds it on the H100 and what its
design does about that.  Tiles above the diagonal are skipped under
``causal``, and the ragged edge is masked in the kernels, so every sequence
length works (the TPU kernel's ``supported()`` tiling rule does not carry
over).

Public functions take the JAX package's layout, ``[batch, seq, heads,
head_dim]``, and are differentiable through :class:`_Flash`, whose backward
is the delta pass and the two backward kernels; the fold of the lse
cotangent into delta is plain PyTorch, as in the JAX package.  A tensor on
the CPU goes to the plain versions (:func:`flash_mha_reference`,
:func:`flash_bwd_delta_reference`, :func:`flash_bwd_dq_reference`,
:func:`flash_bwd_dkv_reference`); a CUDA tensor launches the kernels or
raises.
"""

from __future__ import annotations

import ctypes

import torch

NEG_INF = -1e30  # softmax mask fill; finite so (x - x) stays 0, not nan
HEAD_DIMS = (16, 32, 64, 128, 256)
DTYPES = (torch.float32, torch.bfloat16)

# The head dims the tensor-core routes take (in bf16).
TC_HEAD_DIMS = (64, 128)
# The delta pass sums each row in f32 over this many keys (the kernels'
# key tile on both routes), then in f64 across them.
DELTA_BLOCK = 64

# Launches of each CUDA kernel in this process: the counts a run reads to
# show that its path went through the kernels.
LAUNCHES = {"flash_fwd": 0, "flash_bwd_delta": 0, "flash_bwd_dq": 0,
            "flash_bwd_dkv": 0}
# Forward kernel launches by route.
FWD_ROUTES = {"tensor_core": 0, "cuda_core": 0}
# Backward kernel launches by route, the delta pass, dq and dkv alike.
BWD_ROUTES = {"tensor_core": 0, "cuda_core": 0}

_fns: dict = {}


def _kernel(name: str):
    """The ctypes functions of ``csrc/<name>.cu``, built on first use."""
    if name not in _fns:
        from tpuframe_torch import _build

        lib = _build.load(name)
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        if name == "flash_fwd":
            fns = [lib.tf_flash_fwd]
            fns[0].argtypes = ([ptr] * 6 + [i32] * 6 + [i64] * 9
                               + [ctypes.c_float, i32, i32, ptr])
            info = lib.tf_flash_fwd_kernel_info
            info.argtypes = [i32] * 3 + [ctypes.POINTER(i32)] * 2
            info.restype = ctypes.c_int
            _fns["flash_fwd_info"] = info
            err = lib.tf_flash_error_string
        else:
            *fns, _fns["flash_bwd_info"], err = bind_bwd(lib)
        for fn in fns:
            fn.restype = ctypes.c_int
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        _fns[name] = (*fns, err)
    return _fns[name]


def bind_bwd(lib):
    """``(dq, dkv, delta, kernel_info, error_string)``: the ctypes
    functions of a library built from ``csrc/flash_bwd.cu``, typed."""
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    tail = [ctypes.POINTER(ctypes.c_int64), ctypes.c_float, i32, i32, ptr]
    fns = [lib.tf_flash_bwd_dq, lib.tf_flash_bwd_dkv, lib.tf_flash_bwd_delta]
    for fn, n_ptr in zip(fns, (8, 9, 7)):
        fn.argtypes = [ptr] * n_ptr + [i32] * 6 + tail
        fn.restype = ctypes.c_int
    info = lib.tf_flash_bwd_kernel_info
    info.argtypes = [i32] * 4 + [ctypes.POINTER(i32)] * 2
    info.restype = ctypes.c_int
    err = lib.tf_flash_bwd_error_string
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return (*fns, info, err)


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


def _keep(q, k, mask, causal):
    """``[B or 1, 1, S_q, S_kv]`` bool: which query-key pairs attend."""
    keep = torch.ones((1, 1, q.shape[1], k.shape[1]), dtype=torch.bool,
                      device=q.device)
    if causal:
        keep = keep.tril()
    if mask is not None:
        keep = keep & (mask != 0)[:, None, None, :]
    return keep


def flash_mha_reference(q, k, v, *, mask=None, causal=False):
    """The plain PyTorch version of the forward kernel: same semantics, no
    tiling.

    Returns ``(out [B, S, N, D] in q's dtype, lse [B, N, S] f32)``.  Scores
    in f32 scaled by ``D**-0.5``; masked entries give ``p = 0`` exactly; P
    is rounded to V's dtype before the PV product; a fully masked row
    gives a zero output and ``lse = NEG_INF``."""
    _check(q, k, v, mask)
    d = q.shape[-1]
    s = torch.einsum("bqnd,bknd->bnqk", q.float(), k.float()) * d ** -0.5
    keep = _keep(q, k, mask, causal)
    s = torch.where(keep, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(keep, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l == 0.0, 1.0, l)
    out = torch.einsum("bnqk,bknd->bqnd", p.to(v.dtype).float(), v.float())
    out = out / l_safe.permute(0, 2, 1, 3)
    lse = torch.where(l == 0.0, NEG_INF, m + torch.log(l_safe))[..., 0]
    return out.to(q.dtype), lse


def _recompute_p(q, k, lse, mask, causal):
    """``tpuframe/ops/flash_attention.py:_recompute_p`` over the whole
    sequence: f32 ``[B, N, S_q, S_kv]`` probabilities from the saved
    logsumexp, an explicit zero on masked pairs (the ``where`` comes
    before the exponential, so a fully masked row never overflows)."""
    s = (torch.einsum("bqnd,bknd->bnqk", q.float(), k.float())
         * q.shape[-1] ** -0.5)
    keep = _keep(q, k, mask, causal)
    p = torch.exp(torch.where(keep, s, NEG_INF) - lse[..., None])
    return torch.where(keep, p, 0.0)


def _dp(do, v):
    """``dp = dO.v^T`` in f32, ``[B, N, S_q, S_kv]``."""
    return torch.einsum("bqnd,bknd->bnqk", do.float(), v.float())


def _ds(p, do, v, delta):
    """``ds = p * (dO.v^T - delta)`` in f32, ``[B, N, S_q, S_kv]``."""
    return p * (_dp(do, v) - delta[..., None])


def _blocked_sum(x):
    """Sum over the last dim as the delta pass takes it: f32 over blocks
    of :data:`DELTA_BLOCK` keys (the kernel's key tile), f64 across the
    blocks."""
    x = torch.nn.functional.pad(x, (0, -x.shape[-1] % DELTA_BLOCK))
    return x.unflatten(-1, (-1, DELTA_BLOCK)).sum(dim=-1).double().sum(-1)


def flash_bwd_delta_reference(q, k, v, do, lse, *, mask=None,
                              causal=False):
    """The plain version of the delta pass: ``[B, N, S_q]`` f32, ``sum_j p
    * dp / sum_j p`` over each query row from the probabilities recomputed
    from ``lse`` and ``dp = dO.v^T`` (0 for a row that keeps no key).  p
    and dp are f32, and so are the products and their sums within each
    tile of 64 keys; the tiles' sums add in f64, as in the kernel, from
    which it differs in summation order only.  A serial f32 sum over a
    long row would round at the row's full magnitude at every key."""
    _check(q, k, v, mask)
    p = _recompute_p(q, k, lse, mask, causal)
    total = _blocked_sum(p)
    pdp = _blocked_sum(p * _dp(do, v))
    return torch.where(total > 0.0, pdp / torch.where(total > 0.0, total,
                                                      1.0), 0.0).float()


def flash_bwd_dq_reference(q, k, v, do, lse, delta, *, mask=None,
                           causal=False):
    """The plain version of the dq kernel.  ``lse`` and ``delta`` are
    ``[B, N, S_q]`` f32 (``delta = rowsum(dO * O)``, less the lse
    cotangent).  Returns dq ``[B, S_q, N, D]`` in q's dtype: ``scale *
    ds.k`` with ds rounded to k's dtype first."""
    _check(q, k, v, mask)
    ds = _ds(_recompute_p(q, k, lse, mask, causal), do, v, delta)
    dq = torch.einsum("bnqk,bknd->bqnd", ds.to(k.dtype).float(), k.float())
    return (dq * q.shape[-1] ** -0.5).to(q.dtype)


def flash_bwd_dkv_reference(q, k, v, do, lse, delta, *, mask=None,
                            causal=False):
    """The plain version of the dkv kernel.  Returns ``(dk, dv)``, each
    ``[B, S_kv, N, D]``: ``dv = p^T.dO`` with p rounded to dO's dtype and
    ``dk = scale * ds^T.q`` with ds rounded to q's dtype."""
    _check(q, k, v, mask)
    p = _recompute_p(q, k, lse, mask, causal)
    dv = torch.einsum("bnqk,bqnd->bknd", p.to(do.dtype).float(), do.float())
    ds = _ds(p, do, v, delta)
    dk = torch.einsum("bnqk,bqnd->bknd", ds.to(q.dtype).float(), q.float())
    return (dk * q.shape[-1] ** -0.5).to(k.dtype), dv.to(v.dtype)


def _launch_checks(q, k, v, mask):
    if q.dtype not in DTYPES:
        raise TypeError(f"flash kernel takes {DTYPES}; got {q.dtype}")
    d = q.shape[-1]
    if d not in HEAD_DIMS:
        raise ValueError(f"flash kernel takes head_dim in {HEAD_DIMS}; "
                         f"got {d}")
    if min(t.stride(-1) for t in (q, k, v)) != 1:
        raise ValueError("flash kernel needs unit stride on head_dim")
    if mask is None:
        return None
    if mask.device != q.device:
        raise ValueError("mask lies on another device than q")
    return mask.to(torch.int32).contiguous()


def _raise_on(name, err, err_str):
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: "
                           f"{err_str(err).decode()} ({err})")


def _launch(q, k, v, mask, causal, route=None):
    """The forward kernel on ``route`` (default: :func:`fwd_route`'s).
    ``route="cuda_core"`` on a bf16 input at head_dim 64 or 128 runs the
    CUDA-core kernel on the tensor-core route's inputs: chip_smoke.py
    times the two routes that way."""
    mask = _launch_checks(q, k, v, mask)
    b, s_q, n, d = q.shape
    s_kv = k.shape[1]
    route = route or fwd_route(q.dtype, d)
    if route == "tensor_core" and fwd_route(q.dtype, d) != route:
        raise ValueError(f"no tensor-core forward for {q.dtype} at "
                         f"head_dim {d}")
    if q.device.type != "cuda":
        raise ValueError(f"flash forward kernel takes CUDA tensors; got "
                         f"{q.device}")
    if route == "tensor_core":
        q, k, v = map(_tc_operand, (q, k, v))
    out = torch.empty((b, s_q, n, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, n, s_q), dtype=torch.float32, device=q.device)
    fn, err_str = _kernel("flash_fwd")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 None if mask is None else mask.data_ptr(),
                 out.data_ptr(), lse.data_ptr(),
                 b, n, s_q, s_kv, d, int(q.dtype == torch.bfloat16),
                 q.stride(0), q.stride(1), q.stride(2),
                 k.stride(0), k.stride(1), k.stride(2),
                 v.stride(0), v.stride(1), v.stride(2),
                 d ** -0.5, int(causal), int(route == "tensor_core"), stream)
    _raise_on("flash_fwd", err, err_str)
    LAUNCHES["flash_fwd"] += 1
    FWD_ROUTES[route] += 1
    return out, lse


def fwd_kernel_info(dtype, head_dim, route):
    """``(dynamic shared memory bytes, blocks an SM holds)`` of the
    forward kernel on ``route``, from the CUDA runtime's occupancy
    calculator."""
    _, err_str = _kernel("flash_fwd")
    smem, blocks = ctypes.c_int(0), ctypes.c_int(0)
    err = _fns["flash_fwd_info"](head_dim, int(dtype == torch.bfloat16),
                                 int(route == "tensor_core"),
                                 ctypes.byref(smem), ctypes.byref(blocks))
    _raise_on("flash_fwd info", err, err_str)
    return smem.value, blocks.value


def _route(dtype, head_dim) -> str:
    if dtype not in DTYPES:
        raise TypeError(f"flash kernel takes {DTYPES}; got {dtype}")
    if head_dim not in HEAD_DIMS:
        raise ValueError(f"flash kernel takes head_dim in {HEAD_DIMS}; "
                         f"got {head_dim}")
    if dtype == torch.bfloat16 and head_dim in TC_HEAD_DIMS:
        return "tensor_core"
    return "cuda_core"


def fwd_route(dtype, head_dim) -> str:
    """The forward kernel's route for ``(dtype, head_dim)``:
    ``"tensor_core"`` for bf16 at :data:`TC_HEAD_DIMS` (the models' head
    dims), else ``"cuda_core"``.  f32 is on no training path and stays on
    the CUDA cores, like the backward's.  Raises for what no route
    takes."""
    return _route(dtype, head_dim)


def bwd_route(dtype, head_dim) -> str:
    """The backward kernels' route for ``(dtype, head_dim)``:
    ``"tensor_core"`` for bf16 at :data:`TC_HEAD_DIMS` (the models' head
    dims), else ``"cuda_core"``.  f32 stays on the CUDA cores on purpose:
    one TF32 pass keeps about 3 decimal digits, and f32 gradients are held
    to 1e-4.  Raises for what no route takes."""
    return _route(dtype, head_dim)


def _tc_operand(t):
    """``t`` as the tensor-core route reads it, 16 bytes at a time: its
    data 16-byte aligned and its batch, sequence and head strides multiples
    of 8 elements; a fresh contiguous copy where they are not."""
    if t.data_ptr() % 16 == 0 and all(t.stride(i) % 8 == 0
                                      for i in range(3)):
        return t
    return t.clone(memory_format=torch.contiguous_format)


def _launch_bwd(which, q, k, v, do, lse, delta, mask, causal, fns=None):
    """One backward kernel: ``which`` is ``"dq"`` (returns dq), ``"dkv"``
    (returns dk, dv) or ``"delta"`` (the delta pass, which takes no
    ``delta``: returns it), on the route :func:`bwd_route` picks.
    ``fns``, the ``(dq, dkv, delta, error_string)`` of another build of
    ``flash_bwd.cu`` (:func:`bind_bwd`), runs that build's kernel and
    counts no launch: ``tpuframe_torch.tools.flash_bwd_ab`` times builds
    against each other."""
    mask = _launch_checks(q, k, v, mask)
    if do.shape != q.shape or do.dtype != q.dtype or do.stride(-1) != 1:
        raise ValueError(f"dO {tuple(do.shape)} {do.dtype} must match q "
                         f"{tuple(q.shape)} {q.dtype} with unit stride on "
                         f"head_dim")
    b, s_q, n, d = q.shape
    s_kv = k.shape[1]
    rows = (b, n, s_q)
    row_inputs = {"lse": lse} if which == "delta" else {"lse": lse,
                                                         "delta": delta}
    for name, t in row_inputs.items():
        if (tuple(t.shape) != rows or t.dtype != torch.float32
                or t.device != q.device):
            raise ValueError(f"{name} must be f32 {rows} on {q.device}")
    if q.device.type != "cuda" or do.device != q.device:
        raise ValueError(f"flash backward kernels take CUDA tensors; got q "
                         f"on {q.device}, dO on {do.device}")
    route = bwd_route(q.dtype, d)
    if route == "tensor_core":
        q, k, v, do = map(_tc_operand, (q, k, v, do))
    if which == "delta":
        outs = (torch.empty(rows, dtype=torch.float32, device=q.device),)
    elif which == "dq":
        outs = (torch.empty((b, s_q, n, d), dtype=q.dtype, device=q.device),)
    else:
        outs = (torch.empty((b, s_kv, n, d), dtype=k.dtype, device=q.device),
                torch.empty((b, s_kv, n, d), dtype=v.dtype, device=q.device))
    strides = (ctypes.c_int64 * 12)(*(t.stride(i) for t in (q, k, v, do)
                                      for i in range(3)))
    fn_dq, fn_dkv, fn_delta, err_str = fns or _kernel("flash_bwd")
    fn = {"dq": fn_dq, "dkv": fn_dkv, "delta": fn_delta}[which]
    rows_in = [t.contiguous() for t in row_inputs.values()]
    ins = [t.data_ptr() for t in (q, k, v, do, *rows_in)]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(*ins, None if mask is None else mask.data_ptr(),
                 *(t.data_ptr() for t in outs),
                 b, n, s_q, s_kv, d, int(q.dtype == torch.bfloat16), strides,
                 d ** -0.5, int(causal), int(route == "tensor_core"), stream)
    name = f"flash_bwd_{which}"
    _raise_on(name, err, err_str)
    if fns is None:
        LAUNCHES[name] += 1
        BWD_ROUTES[route] += 1
    return outs if which == "dkv" else outs[0]


def bwd_kernel_info(which, dtype, head_dim, route):
    """``(dynamic shared memory bytes, blocks an SM holds)`` of the
    backward kernel ``which`` (``"dq"``, ``"dkv"`` or ``"delta"``) on
    ``route``, from the CUDA runtime's occupancy calculator."""
    *_, err_str = _kernel("flash_bwd")
    smem, blocks = ctypes.c_int(0), ctypes.c_int(0)
    mode = {"dkv": 0, "dq": 1, "delta": 2}[which]
    err = _fns["flash_bwd_info"](mode, head_dim,
                                 int(dtype == torch.bfloat16),
                                 int(route == "tensor_core"),
                                 ctypes.byref(smem), ctypes.byref(blocks))
    _raise_on(f"flash_bwd_{which} info", err, err_str)
    return smem.value, blocks.value


def _on_device(q):
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash attention runs on cuda or cpu, not "
                         f"{q.device}")
    return q.device.type == "cuda"


def flash_fwd(q, k, v, *, mask=None, causal=False):
    """The forward kernel (CUDA) or its plain version (CPU), no autograd.
    Returns ``(out, lse)``."""
    _check(q, k, v, mask)
    if _on_device(q):
        return _launch(q, k, v, mask, causal)
    return flash_mha_reference(q, k, v, mask=mask, causal=causal)


def flash_bwd_delta(q, k, v, do, lse, *, mask=None, causal=False):
    """The delta pass (CUDA) or its plain version (CPU): ``[B, N, S_q]``
    f32, ``sum_j p * dp / sum_j p``."""
    _check(q, k, v, mask)
    if _on_device(q):
        return _launch_bwd("delta", q, k, v, do, lse, None, mask, causal)
    return flash_bwd_delta_reference(q, k, v, do, lse, mask=mask,
                                     causal=causal)


def flash_bwd(q, k, v, do, lse, delta, *, mask=None, causal=False):
    """The two backward kernels (CUDA) or their plain versions (CPU).
    Returns ``(dq, dk, dv)``."""
    _check(q, k, v, mask)
    if _on_device(q):
        return (_launch_bwd("dq", q, k, v, do, lse, delta, mask, causal),
                *_launch_bwd("dkv", q, k, v, do, lse, delta, mask, causal))
    dq = flash_bwd_dq_reference(q, k, v, do, lse, delta, mask=mask,
                                causal=causal)
    return (dq, *flash_bwd_dkv_reference(q, k, v, do, lse, delta, mask=mask,
                                         causal=causal))


class _Flash(torch.autograd.Function):
    """``(out, lse)`` with the JAX package's custom VJP
    (``_flash_lse_vjp_fwd`` / ``_bwd``): both outputs are differentiable,
    and the lse cotangent folds into delta (``delta - dlse``), so both
    backward kernels run unchanged.  delta comes from the delta pass
    (:func:`flash_bwd_delta`), not from the saved output."""

    @staticmethod
    def forward(ctx, q, k, v, mask, causal):
        out, lse = flash_fwd(q, k, v, mask=mask, causal=causal)
        ctx.save_for_backward(q, k, v, mask, lse)
        ctx.causal = causal
        ctx.set_materialize_grads(False)
        return out, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, mask, lse = ctx.saved_tensors
        if do is None:
            do = torch.zeros_like(q)
        elif do.stride(-1) != 1:
            do = do.contiguous()
        do = do.to(q.dtype)
        delta = flash_bwd_delta(q, k, v, do, lse, mask=mask,
                                causal=ctx.causal)
        if dlse is not None:
            # lse = logsumexp(s) is an output: d lse / d s_j = p_j adds
            # dlse * p_j to ds, i.e. ds = p * (dp - (delta - dlse)).
            delta = delta - dlse.float()
        dq, dk, dv = flash_bwd(q, k, v, do, lse, delta, mask=mask,
                               causal=ctx.causal)
        return dq, dk, dv, None, None


def flash_mha_lse(q, k, v, *, mask=None, causal=False):
    """:func:`flash_mha` that also returns the logsumexp rows.

    Returns ``(out [B, S, N, D], lse [B, N, S] f32)``; fully masked rows
    report ``lse = NEG_INF`` and a zero output.  Both outputs carry
    gradient (the lse's folds into the backward's delta), which is what
    lets ring attention merge per-stage results exactly."""
    _check(q, k, v, mask)
    _on_device(q)
    return _Flash.apply(q, k, v, mask, causal)


def flash_mha(q, k, v, *, mask=None, causal=False):
    """Flash multi-head attention.

    Args:
      q, k, v: ``[batch, seq, heads, head_dim]``, float32 or bfloat16.
      mask: optional ``[batch, seq_kv]`` key-padding mask, nonzero = attend.
      causal: query ``i`` attends keys ``j <= i``; key tiles wholly above
        the diagonal are skipped.

    Returns ``[batch, seq, heads, head_dim]`` in q's dtype; differentiable
    in q, k and v."""
    return flash_mha_lse(q, k, v, mask=mask, causal=causal)[0]
