#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU (an H100): build, check, serve,
train.

    python3 chip_smoke.py

Phases, each printed as it ends; any failure raises and exits non-zero:

  1. require CUDA; print the card's name and power limit (nvidia-smi);
  2. build every kernel under tpuframe_torch/csrc with nvcc;
  3. hold the forward kernel against its plain PyTorch version at the
     serving shapes and at the training slice's (and, for correctness
     only, at every head_dim and dtype it takes, with strided inputs), and
     time the kernel, the plain version and one PyTorch library call that
     computes the same function (a yardstick only);
  4. the same for the two backward kernels at the training slice's shapes,
     plus a correctness sweep (f32, key masks with fully masked rows, a
     ragged length, every head_dim, strided inputs, an lse cotangent);
  5. prefill + decode logits against the full forward, full width, bf16;
  6. serve 12 requests over the three prompt buckets through run_loadgen
     -> Scheduler -> LMEngine at full width (TransformerLM defaults:
     hidden 768, 12 layers, 12 heads, vocab 32000, bf16, flash attention),
     with every kernel's launch count read around that run;
  7. one training step's loss and gradients at full width in f32, flash
     kernels against the plain einsum attention;
  8. train lm_long through ``tpuframe_torch.train.main`` (cuts in
     TRAIN_OVERRIDES), with every kernel's launch count read around that
     run, then profile one more step;
  9. hold the fused 1x1-conv+BN backward kernel against its plain version
     at the 15 shapes a ResNet-50 training step gives it (bf16, batch
     256), time it, its plain version and a yardstick (the autograd
     backward of cuDNN's unfused 1x1 conv + batch norm), then a
     correctness sweep (f32, ragged M/K/C, a strided downsample);
 10. one ResNet-50 training step's loss, gradients and running statistics
     at full width in f32, ``bn="fused"`` (the kernel) against
     ``bn="flax"`` (cuDNN), from the same weights;
 11. train imagenet_resnet50 with ``bn="fused"`` through
     ``tpuframe_torch.train.main`` (cuts in RESNET_CUTS), with every
     kernel's launch count read around that run, then profile one more
     step.

``--phases`` runs a subset after the build, for debugging.  A full run
prints a ``{"kernels": [...]}`` line, then ends with
``{"ok": true, "device": {...}}`` as its last line.  Weights and token ids
are random, drawn from fixed seeds.
"""

from __future__ import annotations

import argparse
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent))

from tpuframe_torch import _build  # noqa: E402
from tpuframe_torch import train as train_lib  # noqa: E402
from tpuframe_torch.models import get_model  # noqa: E402
from tpuframe_torch.models.transformer_lm import LMConfig  # noqa: E402
from tpuframe_torch.models import resnet as resnet_lib  # noqa: E402
from tpuframe_torch.ops import flash_attention as fa  # noqa: E402
from tpuframe_torch.ops import fused_conv_bn as fcb  # noqa: E402
from tpuframe_torch.serve import kv_cache as kv  # noqa: E402
from tpuframe_torch.serve import loadgen  # noqa: E402
from tpuframe_torch.serve.engine import LMEngine, parity_diffs  # noqa: E402
from tpuframe_torch.utils.config import get_config  # noqa: E402

# H100 SXM published peaks (NVIDIA data sheet, dense, at 700 W).
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = {torch.bfloat16: 989e12,   # tensor cores
              torch.float32: 67e12}     # CUDA cores, outside tensor cores

# Kernel vs plain tolerances (max |diff|).  f32: the two differ only in
# summation order.  bf16: the kernel rounds P to bf16 against the running
# max of each tile, the plain version against the row's final max, so
# each P carries its own 2^-9 relative rounding; over |v| <= ~4 that is
# worth a few bf16 steps of the output.
TOL = {torch.float32: {"out": 2e-5, "lse": 2e-5},
       torch.bfloat16: {"out": 1e-2, "lse": 1e-4}}

# Prefill+decode against the full forward at full width in bf16: the two
# paths round the bf16 residual stream at different places (decode uses
# the plain einsum attention, and the matmuls see other row counts), so
# the f32 logits (std ~1 with these weights) differ by a few bf16 steps
# of the hidden state carried through 12 layers.
PARITY_ATOL_BF16 = 0.25

# Backward kernels vs plain versions: max |diff| over max |plain|.  f32:
# summation order only.  bf16: the kernel and the plain version round P
# and dS to bf16 from scores summed in other orders, so an operand near a
# rounding boundary can fall the other way, and each gradient is rounded
# to bf16 at the end (2^-8 relative).
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}

# The training slice: lm_long at its full width (hidden 768, 12 layers,
# 12 heads of 64, intermediate 3072, vocab 32000, bf16, adamw 3e-4, wd
# 0.1, clip 1.0, warmup+cosine, remat, fused xent, flash attention) and
# global batch 8, cut for one card: sequence 32768 -> 4096 (the kernels
# run on CUDA cores: attention alone would take minutes a step at 32768),
# mesh data=2 x seq -> 1 x 1 (seq_mode ring on a seq degree of 1 is full
# causal attention), and a few steps with one eval batch.
TRAIN_STEPS = 4
TRAIN_EVAL_BATCHES = 1
TRAIN_OVERRIDES = {"mesh": {"data": 1, "seq": 1},
                   "dataset_kwargs": {"seq_len": 4096},
                   "total_steps": TRAIN_STEPS, "eval_every": TRAIN_STEPS,
                   "eval_batches": TRAIN_EVAL_BATCHES, "log_every": 1}
TRAIN_ARGS = ["--config", "lm_long"] + [
    a for k, v in TRAIN_OVERRIDES.items() for a in ("--set", f"{k}={v!r}")]
# The attention shape at the kernels there: batch, sequence, heads, D.
TRAIN_ATTN_SHAPE = (8, 4096, 12, 64)

# Gradient parity at full width in f32 (batch, sequence): the kernels and
# the einsum attention differ in summation order and in the einsum's
# -1e9 mask fill, worth ~1e-6 relative per layer.
GRAD_PARITY_SHAPE = (2, 256)
GRAD_PARITY_RTOL = 1e-4

SERVE_REQUESTS = 12
NEW_TOKENS = 16

# The ResNet slice: imagenet_resnet50 (ResNet-50 v1.5 at full width, 224 x
# 224, 1000 classes, bf16 compute with f32 params and BN statistics,
# nesterov SGD 0.9, wd 1e-4 under the decay mask, label smoothing 0.1,
# warmup + cosine, augment "flip") with bn="fused", cut for one card.
# Each cut and its reason:
RESNET_CUTS = {
    # the config's own per-chip model: its mesh is data-parallel, one card
    "model_kwargs": {"bn": "fused"},
    "mesh": {"data": 1},
    # 2048 over 8 chips in the recipe: one chip's share; the LR follows
    # the config's own rule (base_lr x global_batch / 256)
    "global_batch": 256,
    # no ImageNet on the machine: synthetic images, enough for 8 batches;
    # the eval split is an eighth (256) and must hold one batch
    "dataset_kwargs": {"synthetic_size": 2048},
    # a few steps and one eval batch, for the time limit
    "total_steps": 4, "eval_every": 4, "eval_batches": 1, "log_every": 1,
}
RESNET_ARGS = ["--config", "imagenet_resnet50"] + [
    a for k, v in RESNET_CUTS.items() for a in ("--set", f"{k}={v!r}")]
RESNET_BATCH = 256

# Fused conv+BN kernel vs plain version: max |diff| over max |plain|.
# Both compute g bit-equal (the kernel rounds each f32 operation on its
# own, as PyTorch does) and its products are exact in f32 for bf16
# operands; they differ in summation order only.  da is then rounded to
# its dtype (bf16: a 2^-8 step of the largest entries); dW is an f32 sum
# over up to 802,816 rows taken in another order.
CONV_BN_TOL = {torch.float32: {"da": 1e-4, "dw": 1e-4},
               torch.bfloat16: {"da": 1e-2, "dw": 1e-3}}
# The fused op against autograd through the plain composition (a strided
# downsample): max |diff| over max |plain|, the JAX package's own
# tolerances for the same comparison (tests/test_fused_conv_bn.py).  In
# bf16 autograd differentiates the bf16-rounded affine while the fused
# backward uses the exact closed form.
STRIDED_TOL = {torch.float32: 2e-4, torch.bfloat16: 3e-2}

# ResNet-50 gradient parity at full width in f32, batch 8 at 224: the
# fused op and cuDNN's conv + BN differ in summation order, in f32 with
# TF32 off, compounded through 53 BN layers.  Measured on the H100, the
# plain route alone moves its gradients by up to ~2.5% when the batch is
# reversed, so each tensor may differ by 3x that noise floor, or 1e-3.
RESNET_PARITY_BATCH = 8
RESNET_PARITY_RTOL = 1e-3
RESNET_NOISE_FACTOR = 3.0


def log(msg: str) -> None:
    print(msg, flush=True)


def reset_launches() -> None:
    for counts in (fa.LAUNCHES, fcb.LAUNCHES):
        for name in counts:
            counts[name] = 0


def launch_counts() -> dict:
    """Every kernel's launches since the last :func:`reset_launches`."""
    return {**fa.LAUNCHES, **fcb.LAUNCHES}


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` calls, by CUDA events,
    after a warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def phase_card() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    log(smi.stdout.strip().splitlines()[0])


def phase_build() -> None:
    secs = _build.build_all()
    log(f"[build] {len(_build.sources())} kernel source(s) in {secs:.1f} s")
    for src in _build.sources():
        text = _build.build_log(src.stem)
        regs = re.findall(r"Used (\d+) registers", text)
        spills = sum(map(int, re.findall(r"(\d+) bytes spill stores", text)))
        log(f"[build] {src.stem}: registers per instantiation {regs}, "
            f"spill stores {spills} B")


def _flash_inputs(b, s, n, d, dtype, masked, gen, strided=False):
    """q, k, v ``[b, s, n, d]`` and, if ``masked``, a key mask whose row
    0 keeps a ragged prefix and whose other rows are fully masked.
    ``strided`` hands the kernel head-major storage seen through a
    transposed view, as a fused projection could."""
    dev = torch.device("cuda")
    shape = (b, n, s, d) if strided else (b, s, n, d)
    q, k, v = (torch.randn(shape, generator=gen, device=dev).to(dtype)
               for _ in range(3))
    if strided:
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    mask = None
    if masked:
        mask = torch.zeros((b, s), dtype=torch.int32, device=dev)
        mask[0, : (3 * s) // 5] = 1
    return q, k, v, mask


def _flash_check(name, q, k, v, mask, causal):
    """Kernel against plain version; raises past the tolerance."""
    out, lse = fa.flash_mha_lse(q, k, v, mask=mask, causal=causal)
    torch.cuda.synchronize()
    ref_out, ref_lse = fa.flash_mha_reference(q, k, v, mask=mask,
                                              causal=causal)
    err = float((out.float() - ref_out.float()).abs().max())
    err_lse = float((lse - ref_lse).abs().max())
    tol = TOL[q.dtype]
    if not (err <= tol["out"] and err_lse <= tol["lse"]):
        raise RuntimeError(f"flash_fwd {name}: max|out diff| {err:.3e} "
                           f"(tol {tol['out']}), max|lse diff| "
                           f"{err_lse:.3e} (tol {tol['lse']})")
    return out, lse, err, err_lse


def _flash_case(s, dtype, causal, masked, gen):
    b, n, d = (2, 12, 64) if masked else (1, 12, 64)
    q, k, v, mask = _flash_inputs(b, s, n, d, dtype, masked, gen)
    name = (f"S={s} {str(dtype)[6:]} {'causal' if causal else 'full'}"
            f"{' masked' if masked else ''}")
    out, lse, err, err_lse = _flash_check(name, q, k, v, mask, causal)
    tol = TOL[dtype]

    ms = cuda_ms(lambda: fa.flash_mha_lse(q, k, v, mask=mask,
                                          causal=causal), 100)
    plain_ms = cuda_ms(lambda: fa.flash_mha_reference(
        q, k, v, mask=mask, causal=causal), 10)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    attn_mask = None if mask is None else mask.bool()[:, None, None, :]
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=attn_mask, is_causal=causal), 100)
    # Device time alone (the times above include the host's launch cost
    # wherever that is the larger).
    dev_ms = sum(ms for _, ms, _ in device_time(
        lambda: fa.flash_mha_lse(q, k, v, mask=mask, causal=causal), 10)) / 10
    lib_dev_ms = sum(ms for _, ms, _ in device_time(
        lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=attn_mask, is_causal=causal), 10)) / 10

    ops = 4 * d * _pairs(s, s, b, n, mask, causal)  # QK^T and PV
    nbytes = (3 * q.numel() * q.element_size() + out.numel()
              * out.element_size() + lse.numel() * 4
              + (0 if mask is None else mask.numel() * 4))
    t_ops, t_bytes = ops / PEAK_OPS_S[dtype], nbytes / PEAK_BYTES_S
    case = {"case": name, "max_abs_err": err, "max_abs_err_lse": err_lse,
            "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "device_ms": dev_ms, "library_device_ms": lib_dev_ms,
            "bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "ops": ops, "bytes": nbytes}
    log(f"[flash] {name}: err {err:.2e} (tol {tol['out']}), lse err "
        f"{err_lse:.2e}; kernel {ms:.4f} ms (device {dev_ms:.4f}), plain "
        f"{plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms (device "
        f"{lib_dev_ms:.4f}), bound {case['bound_ms']:.5f} ms "
        f"({case['bound_by']})")
    return case


def phase_kernels() -> dict:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = {}
    for dtype in (torch.bfloat16, torch.float32):
        for s in (128, 256, 512, 200):
            cases[(s, dtype, True, False)] = _flash_case(s, dtype, True,
                                                         False, gen)
    cases[(512, torch.bfloat16, False, True)] = _flash_case(
        512, torch.bfloat16, False, True, gen)
    log(json.dumps({"flash_fwd_cases": list(cases.values())}))
    # Every other head_dim the kernel takes, at a ragged length, with a
    # key mask and strided inputs: correctness only.
    worst = {}
    for d in fa.HEAD_DIMS:
        for dtype in fa.DTYPES:
            for causal in (False, True):
                name = f"D={d} {str(dtype)[6:]} causal={causal} strided"
                args = _flash_inputs(3, 77, 5, d, dtype, True, gen,
                                     strided=True)
                err = _flash_check(name, *args, causal)[2]
                worst[str(dtype)[6:]] = max(worst.get(str(dtype)[6:], 0.0),
                                            err)
    log(f"[flash] head_dims {fa.HEAD_DIMS} x f32/bf16 x causal/full, "
        f"S=77, masked, strided: worst err {worst}")
    cases["train"] = _flash_train_case(gen)
    return cases


def _flash_train_case(gen) -> dict:
    """The forward kernel at the training slice's shapes, against its
    plain version one batch row at a time."""
    b, s, n, d = TRAIN_ATTN_SHAPE
    dtype = torch.bfloat16
    q, k, v, _ = _flash_inputs(b, s, n, d, dtype, False, gen)
    out, lse = fa.flash_fwd(q, k, v, causal=True)
    torch.cuda.synchronize()
    ref_out, ref_lse = _by_row(fa.flash_mha_reference, (q, k, v), None, True)
    err = float((out.float() - ref_out.float()).abs().max())
    err_lse = float((lse - ref_lse).abs().max())
    tol = TOL[dtype]
    if not (err <= tol["out"] and err_lse <= tol["lse"]):
        raise RuntimeError(f"flash_fwd training shape: max|out diff| "
                           f"{err:.3e}, max|lse diff| {err_lse:.3e}")
    launch = lambda: fa.flash_fwd(q, k, v, causal=True)  # noqa: E731
    ms = cuda_ms(launch, 5)
    dev_ms = sum(t for _, t, _ in device_time(launch, 3)) / 3
    plain_ms = cuda_ms(lambda: _by_row(fa.flash_mha_reference, (q, k, v),
                                       None, True), 1)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True), 5)
    ops = 4 * d * _pairs(s, s, b, n, None, True)
    nbytes = 4 * q.numel() * 2 + lse.numel() * 4
    t_ops, t_bytes = ops / PEAK_OPS_S[dtype], nbytes / PEAK_BYTES_S
    case = {"max_abs_err": err, "ms": ms, "device_ms": dev_ms,
            "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "tflops": ops / ms / 1e9}
    log(f"[flash] B={b} S={s} N={n} D={d} bf16 causal (training shape): "
        f"err {err:.2e}, lse err {err_lse:.2e}; kernel {ms:.3f} ms (device "
        f"{dev_ms:.3f}, {case['tflops']:.2f} TFLOP/s), plain {plain_ms:.1f}"
        f" ms, sdpa {lib_ms:.3f} ms, bound {case['bound_ms']:.4f} ms "
        f"({case['bound_by']})")
    return case


def _pairs(s_q, s_kv, b, n, mask, causal) -> int:
    """Query-key pairs the kernels keep, summed over batch and heads."""
    keep = torch.ones((s_q, s_kv), dtype=torch.bool, device="cuda")
    if causal:
        keep = keep.tril()
    if mask is None:
        return n * b * int(keep.sum())
    return n * int((keep[None] & (mask[:, None, :] != 0)).sum())


def _bwd_inputs(b, s, n, d, dtype, masked, causal, gen, *, strided=False,
                dlse=False):
    """Backward inputs as training hands them to the kernels: q, k, v,
    dO, the forward kernel's lse, delta = rowsum(dO * O) (less a random
    lse cotangent when ``dlse``) and the key mask."""
    q, k, v, mask = _flash_inputs(b, s, n, d, dtype, masked, gen,
                                  strided=strided)
    do = torch.randn(q.shape, generator=gen, device="cuda").to(dtype)
    out, lse = fa.flash_fwd(q, k, v, mask=mask, causal=causal)
    delta = (do.float() * out.float()).sum(-1).permute(0, 2, 1)
    if dlse:
        delta = delta - torch.randn(lse.shape, generator=gen, device="cuda")
    return q, k, v, do, lse, delta.contiguous(), mask


def _by_row(fn, args, mask, causal):
    """A plain version over one batch row at a time: its [B, N, S, S]
    f32 score tensors for the whole batch would not fit the card at the
    training slice's shapes.  Same inputs, same arithmetic per row."""
    parts = []
    for i in range(args[0].shape[0]):
        row = [a[i:i + 1] for a in args]
        got = fn(*row, mask=None if mask is None else mask[i:i + 1],
                 causal=causal)
        parts.append(got if isinstance(got, tuple) else (got,))
    return tuple(torch.cat(p) for p in zip(*parts))


def _bwd_check(name, args, causal):
    """Both backward kernels against their plain versions; raises past the
    tolerance.  Returns ``{grad: max abs error}``."""
    *tensors, mask = args
    dq = fa._launch_bwd("dq", *tensors, mask, causal)
    dk, dv = fa._launch_bwd("dkv", *tensors, mask, causal)
    torch.cuda.synchronize()
    (ref_dq,) = _by_row(fa.flash_bwd_dq_reference, tensors, mask, causal)
    ref_dk, ref_dv = _by_row(fa.flash_bwd_dkv_reference, tensors, mask,
                             causal)
    tol = BWD_TOL[tensors[0].dtype]
    errs, bad = {}, []
    for g, got, ref in (("dq", dq, ref_dq), ("dk", dk, ref_dk),
                        ("dv", dv, ref_dv)):
        errs[g] = float((got.float() - ref.float()).abs().max())
        scale = float(ref.float().abs().max())
        if not (torch.isfinite(got.float()).all()
                and errs[g] <= tol * max(scale, 1e-30)):
            bad.append(f"{g}: max|diff| {errs[g]:.3e} vs tol {tol} x "
                       f"max|plain| {scale:.3e}")
    if mask is not None and not mask[1:].any():
        # rows 1.. of the batch are fully masked: exactly zero gradients
        if dq[1:].any() or dk[1:].any() or dv[1:].any():
            bad.append("a fully masked batch row has nonzero gradients")
    if bad:
        raise RuntimeError(f"flash backward {name}: " + "; ".join(bad))
    return errs


def phase_backward() -> dict:
    """Both backward kernels against their plain versions at the training
    slice's shapes (timed) and over the correctness sweep."""
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(1)
    b, s, n, d = TRAIN_ATTN_SHAPE
    dtype = torch.bfloat16
    args = _bwd_inputs(b, s, n, d, dtype, False, True, gen)
    *tensors, mask = args
    errs = _bwd_check("training shape", args, True)
    pairs = _pairs(s, s, b, n, None, True)
    elt = 2   # bf16 bytes
    qkvo = 4 * b * s * n * d * elt
    rows = 2 * b * n * s * 4            # lse, delta
    res = {}
    for which, flops_per_pair, out_bytes, fn in (
            ("dq", 6 * d, b * s * n * d * elt, fa.flash_bwd_dq_reference),
            ("dkv", 8 * d, 2 * b * s * n * d * elt,
             fa.flash_bwd_dkv_reference)):
        launch = (lambda w=which: fa._launch_bwd(w, *tensors, mask, True))
        ms = cuda_ms(launch, 5)
        dev = sum(t for _, t, _ in device_time(launch, 3)) / 3
        plain = cuda_ms(lambda f=fn: _by_row(f, tensors, mask, True), 1)
        ops = flops_per_pair * pairs
        nbytes = qkvo + rows + out_bytes
        t_ops, t_bytes = ops / PEAK_OPS_S[dtype], nbytes / PEAK_BYTES_S
        res[which] = {"ms": ms, "device_ms": dev, "plain_ms": plain,
                      "bound_ms": 1e3 * max(t_ops, t_bytes),
                      "bound_by": "operations" if t_ops >= t_bytes
                      else "bytes", "ops": ops, "bytes": nbytes,
                      "tflops": ops / ms / 1e9}
    res["dq"]["max_abs_err"] = errs["dq"]
    res["dkv"]["max_abs_err"] = max(errs["dk"], errs["dv"])
    # Yardstick: the backward of PyTorch's fused attention on the same
    # tensors, timed alone (the graph is kept, so each call is only the
    # backward).  The port never calls it.
    q, k, v, do, _, _ = tensors
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    dot = do.transpose(1, 2)
    lib = cuda_ms(lambda: torch.autograd.grad(out, (qt, kt, vt), dot,
                                              retain_graph=True), 5)
    for r in res.values():
        r["library_ms"] = lib
    del out
    log(f"[flash-bwd] B={b} S={s} N={n} D={d} bf16 causal: err dq "
        f"{errs['dq']:.2e} dk {errs['dk']:.2e} dv {errs['dv']:.2e} (tol "
        f"{BWD_TOL[dtype]} x max|plain|); "
        + "; ".join(f"{w} {r['ms']:.3f} ms (device {r['device_ms']:.3f}, "
                    f"{r['tflops']:.2f} TFLOP/s), plain {r['plain_ms']:.1f}"
                    f" ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']})"
                    for w, r in res.items())
        + f"; sdpa backward {lib:.3f} ms")

    # Correctness sweep: f32; a masked, not causal case with fully masked
    # batch rows; and every head_dim at a ragged length, masked, strided,
    # with an lse cotangent folded into delta.
    sweep = [("S=1024 f32 causal dlse",
              _bwd_inputs(2, 1024, 12, 64, torch.float32, False, True, gen,
                          dlse=True), True),
             ("S=512 bf16 masked full",
              _bwd_inputs(2, 512, 12, 64, dtype, True, False, gen), False)]
    for d_ in fa.HEAD_DIMS:
        for dt in fa.DTYPES:
            for causal in (False, True):
                sweep.append((f"D={d_} {str(dt)[6:]} causal={causal} S=77 "
                              f"masked strided dlse",
                              _bwd_inputs(3, 77, 5, d_, dt, True, causal,
                                          gen, strided=True, dlse=True),
                              causal))
    worst = {}
    for name, args, causal in sweep:
        e = max(_bwd_check(name, args, causal).values())
        key = "f32" if args[0].dtype == torch.float32 else "bf16"
        worst[key] = max(worst.get(key, 0.0), e)
    log(f"[flash-bwd] sweep of {len(sweep)} cases (f32 S=1024 with dlse; "
        f"bf16 masked full S=512 with fully masked rows; every head_dim x "
        f"dtype x causal at S=77, masked, strided, dlse): worst max abs "
        f"err {worst}")
    return res


def phase_parity() -> None:
    cfg = LMConfig(dtype="bfloat16", attn_impl="pallas")
    buckets = kv.DEFAULT_PROMPT_BUCKETS
    cap = kv.capacity_for(max(buckets) + 4, kv.DEFAULT_DECODE_BLOCK)
    diffs = parity_diffs(cfg, buckets=buckets, capacity=cap,
                         decode_tokens=4, seed=0)
    worst = max(diffs.values())
    log(f"[parity] prefill+decode vs full forward, bf16 full width: "
        + ", ".join(f"{b}/{n}: {d:.3e}" for (b, n), d in diffs.items())
        + f"; worst {worst:.3e} (atol {PARITY_ATOL_BF16})")
    if not worst <= PARITY_ATOL_BF16:
        raise RuntimeError(f"prefill+decode parity {worst:.3e} > "
                           f"{PARITY_ATOL_BF16}")


def _pct(vals, q):
    vals = sorted(vals)
    return vals[min(len(vals) - 1, int(round(q * (len(vals) - 1))))]


def phase_serve() -> dict:
    cfg = LMConfig(dtype="bfloat16", attn_impl="pallas")
    buckets = kv.DEFAULT_PROMPT_BUCKETS
    t0 = time.monotonic()
    engine = LMEngine(cfg, slots=4, prompt_buckets=buckets,
                      decode_block=kv.DEFAULT_DECODE_BLOCK, seed=0)
    n_params = sum(p.numel() for p in engine.model.parameters())
    log(f"[serve] engine: {n_params / 1e6:.1f} M params, capacity "
        f"{engine.spec.capacity}, KV cache "
        f"{engine.spec.total_bytes() / 1e6:.1f} MB, built in "
        f"{time.monotonic() - t0:.1f} s")
    # Warm-up (library handles, allocator), outside the counted run.
    loadgen.run_loadgen(engine, loadgen.synthetic_requests(
        3, buckets=buckets, vocab_size=cfg.vocab_size, max_new_tokens=2,
        seed=1))
    engine.reset()

    reqs = loadgen.synthetic_requests(
        SERVE_REQUESTS, buckets=buckets, vocab_size=cfg.vocab_size,
        max_new_tokens=NEW_TOKENS, seed=0)
    reset_launches()
    stats = loadgen.run_loadgen(engine, reqs)
    torch.cuda.synchronize()
    launches = launch_counts()

    prefills = len(reqs)   # each request is prefilled exactly once
    hit = sorted({kv.bucket_for(len(r.prompt), buckets) for r in reqs})
    ragged = sum(len(r.prompt) not in buckets for r in reqs)
    problems = []
    if stats["requests"] != len(reqs) or stats["unfinished"]:
        problems.append(f"{stats['requests']}/{len(reqs)} completed")
    if any(len(r.tokens) != NEW_TOKENS for r in reqs):
        problems.append("a request did not get all its tokens")
    if any(not 0 <= t < cfg.vocab_size for r in reqs for t in r.tokens):
        problems.append("a token lies outside the vocabulary")
    if hit != list(buckets) or not ragged:
        problems.append(f"buckets hit {hit}, {ragged} ragged prompts")
    if launches["flash_fwd"] != cfg.num_layers * prefills:
        problems.append(f"flash_fwd launched {launches['flash_fwd']} times"
                        f", want {cfg.num_layers} x {prefills} prefills")
    if problems:
        raise RuntimeError("serving: " + "; ".join(problems))

    ttft = [r.ttft_ms() for r in reqs]
    tpot = [r.tpot_ms() for r in reqs]
    log(f"[serve] {stats['requests']} requests over buckets {hit} "
        f"({ragged} ragged), {stats['total_tokens']} tokens in "
        f"{stats['wall_s']} s: {stats['tokens_per_s']} tokens/s; "
        f"TTFT p50 {_pct(ttft, .5):.2f} ms p90 {_pct(ttft, .9):.2f} ms; "
        f"TPOT p50 {_pct(tpot, .5):.2f} ms p90 {_pct(tpot, .9):.2f} ms; "
        f"flash_fwd launches {launches['flash_fwd']} = "
        f"{cfg.num_layers} x {prefills} prefills")

    # Where a request's time goes: host wall per call (synchronised by
    # the tokens it returns) against the device time of one such call.
    for b in buckets:
        ids = [(7 * i + 1) % cfg.vocab_size for i in range(b)]
        profile_window(f"prefill bucket {b}", lambda: engine.prefill(ids),
                       wall_ms(lambda: engine.prefill(ids), 5))
    profile_window(f"decode step ({engine.slots} slots)", engine.decode_step,
                   wall_ms(engine.decode_step, 20))
    return launches


def phase_grad_parity() -> None:
    """One training step's loss and gradients at full width in f32, with
    the flash kernels (``attn_impl="pallas"``) against the plain einsum
    attention (``"xla"``), from the same random weights and tokens."""
    torch.backends.cuda.matmul.allow_tf32 = False
    b, s = GRAD_PARITY_SHAPE
    cfg = get_config("lm_long").with_overrides(
        compute_dtype="float32", dataset_kwargs={"seq_len": s})
    gen = torch.Generator(device="cuda").manual_seed(3)
    ids = torch.randint(0, 32000, (b, s + 1), generator=gen, device="cuda")
    batch = {"input_ids": ids[:, :-1], "labels": ids[:, 1:]}
    loss_fn = train_lib.make_loss_fn(cfg)
    out = {}
    for impl in ("pallas", "xla"):
        model = get_model(cfg.model, dtype="float32", device="cuda", seed=0,
                          **dict(cfg.model_kwargs, attn_impl=impl))
        loss, _ = loss_fn(model, batch, 0)
        loss.backward()
        out[impl] = (float(loss.detach()), {n: p.grad for n, p in
                                   model.named_parameters()})
        del model
    (lp, gp), (lx, gx) = out["pallas"], out["xla"]
    worst, where = 0.0, ""
    for name, g in gx.items():
        rel = float((gp[name] - g).norm() / g.norm().clamp_min(1e-30))
        if rel > worst:
            worst, where = rel, name
    log(f"[grad-parity] lm_long widths f32, B={b} S={s}: loss kernels "
        f"{lp:.6f} plain {lx:.6f}; worst per-tensor relative grad "
        f"difference {worst:.2e} ({where}; tol {GRAD_PARITY_RTOL})")
    if not (abs(lp - lx) <= GRAD_PARITY_RTOL * abs(lx)
            and worst <= GRAD_PARITY_RTOL):
        raise RuntimeError(f"gradient parity: loss {lp} vs {lx}, worst "
                           f"relative grad difference {worst:.3e} at {where}")


def phase_train() -> dict:
    """The training slice: lm_long through ``tpuframe_torch.train.main``,
    with the cuts of TRAIN_ARGS, every kernel's launches read around it;
    then one more step of the same harness under the profiler."""
    b, s, n, d = TRAIN_ATTN_SHAPE
    layers = 12
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.monotonic()
    metrics = train_lib.main(TRAIN_ARGS)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    losses, step_ms = metrics["losses"], metrics["step_ms"]
    steps, evals = len(losses), TRAIN_EVAL_BATCHES
    want = {"flash_fwd": (2 * steps + evals) * layers,
            "flash_bwd_dq": steps * layers, "flash_bwd_dkv": steps * layers,
            "fused_conv_bn_bwd": 0}
    problems = []
    if not all(math.isfinite(x) for x in losses) or steps != TRAIN_STEPS:
        problems.append(f"losses {losses}")
    if not math.isfinite(metrics.get("eval_loss", float("nan"))):
        problems.append("no finite eval loss")
    if launches != want:
        problems.append(f"launches {launches}, want {want} (forward twice "
                        f"per layer and step under remat, once per layer "
                        f"and eval batch; each backward kernel once per "
                        f"layer and step)")
    if problems:
        raise RuntimeError("training: " + "; ".join(problems))
    p50 = statistics.median(step_ms[1:])
    tokens = b * s
    cfg = get_config("lm_long")
    h, inter, vocab = 768, 3072, 32000
    matmul_params = layers * (4 * h * h + 2 * h * inter) + h * vocab
    pairs = b * s * (s + 1) // 2
    flops = 6 * matmul_params * tokens + 3 * 4 * d * pairs * n * layers
    mfu = flops / (p50 / 1e3) / PEAK_OPS_S[torch.bfloat16]
    log(f"[train] {cfg.name} cut to S={s}, mesh 1x1, {steps} steps + "
        f"{evals} eval batch in {wall:.1f} s: losses "
        f"{[round(x, 4) for x in losses]}, eval loss "
        f"{metrics['eval_loss']:.4f}; step ms {[round(x, 1) for x in step_ms]}"
        f" (p50 after the first {p50:.1f}); {tokens / p50 * 1e3:.0f} "
        f"tokens/s; model FLOPs {flops:.3e} a step, MFU {mfu:.4f} of "
        f"989 TFLOP/s; peak memory {peak / 2**30:.2f} GiB; launches "
        f"{launches}")

    # One more step of the same path under the profiler: where it goes.
    cfg = get_config("lm_long").with_overrides(**TRAIN_OVERRIDES)
    harness = train_lib.build_harness(cfg)
    batch = next(iter(harness.train_loader))
    step = lambda: float(harness.train_step(harness.state, batch)["loss"])  # noqa: E731
    wall_step = wall_ms(step, 1)
    kernels = device_time(step)
    busy = sum(ms for _, ms, _ in kernels)
    log(f"[profile] training step: wall {wall_step:.1f} ms, "
        f"{sum(c for *_, c in kernels)} kernels, device {busy:.1f} ms, idle "
        f"share {1 - busy / wall_step:.3f}; top: "
        + "; ".join(f"{k[:60]} {ms:.1f} ms x{c}" for k, ms, c in kernels[:8]))
    return {"launches": launches, "step_ms_p50": p50, "mfu": mfu,
            "peak_bytes": peak}


def resnet_conv_bn_shapes(batch: int = RESNET_BATCH, size: int = 224):
    """The fused op's calls in one ResNet-50 training step: ``{(n, h, w,
    k, c): calls}`` from the port's own Bottleneck layout (conv1, conv3
    and the downsample of each block; the downsample after its stride)."""
    calls = {}
    hw = size // 4                       # after the stem and the max pool
    cin = 64
    for i, n_blocks in enumerate((3, 4, 6, 3)):
        f = 64 * 2 ** i
        for j in range(n_blocks):
            stride = 2 if i > 0 and j == 0 else 1
            out_hw = hw // stride
            for key in [(batch, hw, hw, cin, f),
                        (batch, out_hw, out_hw, f, 4 * f)] + (
                    [(batch, out_hw, out_hw, cin, 4 * f)] if j == 0 else []):
                calls[key] = calls.get(key, 0) + 1
            cin, hw = 4 * f, out_hw
    return calls


def _conv_bn_inputs(m, k, c, dtype, gen):
    """Kernel operands: activations ~N(0, 1), a conv-scaled W, and the
    folded coefficients of a BN with gamma in [0.5, 1.5]."""
    dev = torch.device("cuda")
    a = torch.randn((m, k), generator=gen, device=dev).to(dtype)
    w = (torch.randn((k, c), generator=gen, device=dev)
         * (2.0 / c) ** 0.5).to(dtype)
    x = torch.randn((m, c), generator=gen, device=dev).to(dtype)
    dy = torch.randn((m, c), generator=gen, device=dev).to(dtype)
    coef = torch.stack([
        torch.rand(c, generator=gen, device=dev) + 0.5,
        torch.randn(c, generator=gen, device=dev) * 0.1,
        torch.randn(c, generator=gen, device=dev) * 0.1])
    return a, w, x, dy, coef


def _conv_bn_check(name, args):
    """Kernel against plain version; raises past the tolerance.  Returns
    ``{"da": err, "dw": err}`` (max abs)."""
    da, dw = fcb.fused_bwd(*args)
    torch.cuda.synchronize()
    ref_da, ref_dw = fcb.fused_bwd_reference(*args)
    tol = CONV_BN_TOL[args[0].dtype]
    errs, bad = {}, []
    for g, got, ref in (("da", da, ref_da), ("dw", dw, ref_dw)):
        errs[g] = float((got.float() - ref.float()).abs().max())
        scale = float(ref.float().abs().max())
        if not (torch.isfinite(got.float()).all()
                and errs[g] <= tol[g] * max(scale, 1e-30)):
            bad.append(f"{g}: max|diff| {errs[g]:.3e} vs tol {tol[g]} x "
                       f"max|plain| {scale:.3e}")
    if bad:
        raise RuntimeError(f"fused_conv_bn {name}: " + "; ".join(bad))
    return errs


def _conv_bn_library_ms(n, h, w, args, iters):
    """The yardstick: the autograd backward of the unfused composition
    PyTorch offers, cuDNN's 1x1 ``F.conv2d`` + training-mode
    ``F.batch_norm``, on the same tensors (channels_last), timed alone
    (the graph is kept, so each call is only the backward).  The port
    never calls it."""
    a, w2, x, dy, coef = args
    k, c = w2.shape
    a4 = a.view(n, h, w, k).permute(0, 3, 1, 2).detach().requires_grad_()
    wt = w2.T.reshape(c, k, 1, 1).contiguous().detach().requires_grad_()
    gamma = coef[0].clone().requires_grad_()
    beta = coef[2].clone().requires_grad_()
    y = F.batch_norm(F.conv2d(a4, wt), None, None, gamma, beta,
                     training=True, eps=1e-5)
    dy4 = dy.view(n, h, w, c).permute(0, 3, 1, 2)
    lib = cuda_ms(lambda: torch.autograd.grad(
        y, (a4, wt, gamma, beta), dy4, retain_graph=True), iters)
    dev = sum(t for _, t, _ in device_time(lambda: torch.autograd.grad(
        y, (a4, wt, gamma, beta), dy4, retain_graph=True), 2)) / 2
    return lib, dev


def phase_conv_bn() -> dict:
    """The fused conv+BN backward kernel at every shape of a ResNet-50
    training step (bf16, batch 256), timed, then a correctness sweep."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(5)
    dtype = torch.bfloat16
    cases, tot = [], {"ms": 0.0, "device_ms": 0.0, "plain_ms": 0.0,
                      "library_ms": 0.0, "library_device_ms": 0.0,
                      "bound_ms": 0.0, "ops_ms": 0.0, "bytes_ms": 0.0,
                      "flops": 0.0, "bytes": 0.0}
    worst = {"da": 0.0, "dw": 0.0}
    for (n, h, w, k, c), calls in resnet_conv_bn_shapes().items():
        m = n * h * w
        args = _conv_bn_inputs(m, k, c, dtype, gen)
        errs = _conv_bn_check(f"M={m} K={k} C={c}", args)
        launch = lambda: fcb.fused_bwd(*args)  # noqa: E731
        ms = cuda_ms(launch, 10)
        dev = sum(t for _, t, _ in device_time(launch, 3)) / 3
        plain = cuda_ms(lambda: fcb.fused_bwd_reference(*args), 3)
        lib, lib_dev = _conv_bn_library_ms(n, h, w, args, 10)
        flops = 4 * m * k * c
        nbytes = (2 * (m * k + 2 * m * c + k * c + m * k) + 4 * 3 * c
                  + 4 * k * c)
        t_ops = 1e3 * flops / PEAK_OPS_S[dtype]
        t_bytes = 1e3 * nbytes / PEAK_BYTES_S
        case = {"m": m, "k": k, "c": c, "calls": calls, "ms": ms,
                "device_ms": dev, "plain_ms": plain, "library_ms": lib,
                "library_device_ms": lib_dev,
                "bound_ms": max(t_ops, t_bytes),
                "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                "max_abs_err_da": errs["da"], "max_abs_err_dw": errs["dw"],
                "tflops": flops / ms / 1e9,
                "splits": fcb.dw_splits(m, k, c)[0]}
        cases.append(case)
        for key, val in (("ms", ms), ("device_ms", dev), ("plain_ms", plain),
                         ("library_ms", lib), ("library_device_ms", lib_dev),
                         ("bound_ms", case["bound_ms"]), ("ops_ms", t_ops),
                         ("bytes_ms", t_bytes), ("flops", flops),
                         ("bytes", nbytes)):
            tot[key] += calls * val
        for g in worst:
            worst[g] = max(worst[g], errs[g])
        log(f"[conv-bn] M={m} K={k} C={c} x{calls}: err da {errs['da']:.2e}"
            f" dw {errs['dw']:.2e}; kernel {ms:.3f} ms (device {dev:.3f}, "
            f"{case['tflops']:.2f} TFLOP/s, {case['splits']} dW splits), "
            f"plain {plain:.3f} ms, cuDNN conv+BN backward {lib:.3f} ms "
            f"(device {lib_dev:.3f}), bound {case['bound_ms']:.4f} ms "
            f"({case['bound_by']})")
        del args
    log(json.dumps({"fused_conv_bn_cases": cases}))
    tot["bound_by"] = ("operations" if tot["ops_ms"] >= tot["bytes_ms"]
                       else "bytes")
    tot["max_abs_err"] = max(worst.values())
    log(f"[conv-bn] one ResNet-50 step's 36 calls ({len(cases)} shapes, "
        f"{tot['flops']:.3e} FLOPs, {tot['bytes'] / 1e9:.2f} GB): kernel "
        f"{tot['ms']:.2f} ms (device {tot['device_ms']:.2f}), plain "
        f"{tot['plain_ms']:.2f} ms, cuDNN conv+BN backward "
        f"{tot['library_ms']:.2f} ms (device "
        f"{tot['library_device_ms']:.2f}), bound {tot['bound_ms']:.3f} ms "
        f"(operations {tot['ops_ms']:.3f}, bytes {tot['bytes_ms']:.3f}); "
        f"worst err {worst}")

    # Correctness sweep: f32 at path widths; ragged M, K and C in both
    # dtypes; and the autograd op over a strided downsample.
    sweep = [(12544, 64, 256, torch.float32), (12544, 1024, 2048,
                                                torch.float32),
             (12544, 2048, 512, torch.float32)]
    for dt in fcb.DTYPES:
        sweep += [(1000, 12, 20, dt), (4099, 100, 300, dt), (33, 7, 130, dt),
                  (17, 65, 129, dt)]
    sworst = {}
    for m, k, c, dt in sweep:
        errs = _conv_bn_check(f"sweep M={m} K={k} C={c} {dt}",
                              _conv_bn_inputs(m, k, c, dt, gen))
        key = str(dt)[6:]
        sworst[key] = max(sworst.get(key, 0.0), *errs.values())
    for dt in fcb.DTYPES:
        sworst[f"strided {str(dt)[6:]}"] = _strided_downsample_check(dt, gen)
    log(f"[conv-bn] sweep of {len(sweep)} kernel cases (f32 at path widths;"
        f" ragged M, K, C in f32 and bf16) and a stride-2 downsample "
        f"through autograd: worst max abs err {sworst}")
    return tot


def _strided_downsample_check(dtype, gen) -> float:
    """``conv1x1_bn_train`` over ``a[:, ::2, ::2, :]`` (a ResNet
    downsample) against the plain composition through autograd: y and
    the gradients of a, w, gamma, beta."""
    dev = torch.device("cuda")
    a4 = torch.randn((8, 14, 14, 64), generator=gen, device=dev).to(dtype)
    w = torch.randn((64, 256), generator=gen, device=dev) * 0.2
    gamma = torch.rand(256, generator=gen, device=dev) + 0.5
    beta = torch.randn(256, generator=gen, device=dev)
    t = torch.randn((8, 7, 7, 256), generator=gen, device=dev)
    out = []
    for fn in (fcb.conv1x1_bn_train, fcb.conv1x1_bn_reference):
        leaves = [v.detach().clone().requires_grad_()
                  for v in (a4, w, gamma, beta)]
        y, _, _ = fn(leaves[0][:, ::2, ::2, :].contiguous(), *leaves[1:],
                     eps=1e-5)
        (y.float() * t).sum().backward()
        out.append([y.detach()] + [v.grad for v in leaves])
    tol = STRIDED_TOL[dtype]
    worst = 0.0
    for name, got, ref in zip(("y", "da", "dw", "dgamma", "dbeta"), *out):
        err = float((got.float() - ref.float()).abs().max())
        scale = float(ref.float().abs().max())
        if not err <= tol * max(scale, 1e-30):
            raise RuntimeError(f"strided downsample {dtype} {name}: max|diff|"
                               f" {err:.3e} vs tol {tol} x {scale:.3e}")
        worst = max(worst, err)
    return worst


def _random_bn_scales(model, seed):
    """BN scales in [0.5, 1.5] (the init zeroes the last of each block,
    which would leave conv3's gradients at exactly 0 on both routes)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, resnet_lib.BatchNorm):
                mod.weight.copy_(torch.rand(mod.weight.shape, generator=gen,
                                            device="cuda") + 0.5)


def phase_resnet_grad_parity() -> None:
    """One training step's loss, gradients and running statistics of
    ResNet-50 at full width in f32: ``bn="fused"`` (the kernel) against
    ``bn="flax"`` (cuDNN conv + the plain BatchNorm), same weights.

    The gradients of a random-init ResNet-50 at batch 8 are sensitive to
    f32 rounding: the plain route on the same batch in reverse order (the
    same function, its sums taken in another order) moves some tensors by
    a few percent.  So each tensor is held to the larger of
    RESNET_PARITY_RTOL and RESNET_NOISE_FACTOR times that measured noise
    floor."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    b = RESNET_PARITY_BATCH
    cfg = get_config("imagenet_resnet50").with_overrides(
        compute_dtype="float32", augment="none")
    gen = torch.Generator(device="cuda").manual_seed(7)
    batch = {"image": torch.randn((b, 224, 224, 3), generator=gen,
                                  device="cuda") * 0.3 + 0.5,
             "label": torch.randint(0, 1000, (b,), generator=gen,
                                    device="cuda")}
    rev = {k: v.flip(0) for k, v in batch.items()}
    loss_fn = train_lib.make_loss_fn(cfg)
    out, state = {}, None
    reset_launches()
    for route, bn, data in (("plain", "flax", batch), ("kernel", "fused", batch),
                            ("plain reversed", "flax", rev)):
        model = get_model("resnet50", dtype="float32", device="cuda", seed=0,
                          num_classes=1000, bn=bn)
        if state is None:
            _random_bn_scales(model, 8)
            state = {k: v.clone() for k, v in model.state_dict().items()}
        else:
            model.load_state_dict(state)
        loss, _ = loss_fn(model, data, 0)
        loss.backward()
        out[route] = (float(loss.detach()),
                      {n: p.grad for n, p in model.named_parameters()},
                      {n: v.clone() for n, v in model.named_buffers()})
        del model
    launches = fcb.LAUNCHES["fused_conv_bn_bwd"]

    def rel(a, b):
        return float((a - b).norm() / b.norm().clamp_min(1e-30))

    (lp, gp, sp), (lk, gk, sk), (_, gr, _) = (
        out["plain"], out["kernel"], out["plain reversed"])
    worst, noise, where, bad = 0.0, 0.0, "", []
    for name, g in gp.items():
        got, floor = rel(gk[name], g), rel(gr[name], g)
        noise = max(noise, floor)
        if got > worst:
            worst, where = got, name
        if got > max(RESNET_PARITY_RTOL, RESNET_NOISE_FACTOR * floor):
            bad.append(f"{name}: {got:.2e} (noise floor {floor:.2e})")
    stat = max(rel(sk[n], v) for n, v in sp.items())
    log(f"[resnet-grad-parity] ResNet-50 f32, B={b} 224x224: loss kernel "
        f"{lk:.6f} plain {lp:.6f}; worst per-tensor relative grad "
        f"difference {worst:.2e} ({where}), against a noise floor (plain "
        f"route, batch reversed) of up to {noise:.2e}; running stats "
        f"{stat:.2e}; fused_conv_bn_bwd launches {launches}")
    if abs(lk - lp) > RESNET_PARITY_RTOL * abs(lp):
        bad.append(f"loss {lk} vs {lp}")
    if stat > RESNET_PARITY_RTOL:
        bad.append(f"running stats {stat:.3e}")
    if launches != 36:
        bad.append(f"launches {launches} (want 36)")
    if bad:
        raise RuntimeError("ResNet gradient parity: " + "; ".join(bad[:8]))


def resnet_forward_flops(model, size: int = 224) -> int:
    """Forward FLOPs of one image: 2 x multiply-adds of every convolution
    and the Dense, counted from the outputs of one forward pass."""
    flops = []

    def conv_hook(mod, _inp, out):
        o, i, kh, kw = mod.weight.shape
        flops.append(2 * out[0].numel() * i * kh * kw)

    hooks = [m.register_forward_hook(conv_hook) for m in model.modules()
             if isinstance(m, resnet_lib.Conv)]
    try:
        with torch.no_grad():
            model(torch.zeros((1, size, size, 3), device="cuda"))
    finally:
        for h in hooks:
            h.remove()
    return sum(flops) + 2 * model.fc.weight.numel()


def phase_resnet_train() -> dict:
    """The ResNet slice: imagenet_resnet50 (bn="fused") through
    ``tpuframe_torch.train.main`` with the cuts of RESNET_CUTS, every
    kernel's launches read around it; then one more step of the same
    harness under the profiler."""
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.monotonic()
    metrics = train_lib.main(RESNET_ARGS)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    losses, step_ms = metrics["losses"], metrics["step_ms"]
    steps = len(losses)
    want = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
            "fused_conv_bn_bwd": 36 * steps}
    problems = []
    if not all(math.isfinite(x) for x in losses) or steps != 4:
        problems.append(f"losses {losses}")
    for key in ("eval_loss", "eval_accuracy", "eval_top5"):
        if not math.isfinite(metrics.get(key, float("nan"))):
            problems.append(f"no finite {key}")
    if launches != want:
        problems.append(f"launches {launches}, want {want} (the fused op "
                        f"once per Bottleneck 1x1 pair and step, none in "
                        f"eval)")
    if problems:
        raise RuntimeError("ResNet training: " + "; ".join(problems))
    p50 = statistics.median(step_ms[1:])
    cfg = get_config("imagenet_resnet50").with_overrides(**RESNET_CUTS)
    harness = train_lib.build_harness(cfg)
    fwd = resnet_forward_flops(harness.state.model)
    flops = 3 * fwd * RESNET_BATCH
    mfu = flops / (p50 / 1e3) / PEAK_OPS_S[torch.bfloat16]
    log(f"[resnet-train] imagenet_resnet50 bn=fused, batch {RESNET_BATCH}, "
        f"mesh 1, {steps} steps + 1 eval batch in {wall:.1f} s: losses "
        f"{[round(x, 4) for x in losses]}, eval loss "
        f"{metrics['eval_loss']:.4f} top5 {metrics['eval_top5']:.4f}; step "
        f"ms {[round(x, 1) for x in step_ms]} (p50 after the first "
        f"{p50:.1f}); {RESNET_BATCH / p50 * 1e3:.1f} images/s; model FLOPs "
        f"{flops:.3e} a step (3 x {fwd:.4e} a forward image), MFU "
        f"{mfu:.4f} of 989 TFLOP/s; peak memory {peak / 2**30:.2f} GiB; "
        f"launches {launches}")

    batch = next(iter(harness.train_loader))
    step = lambda: float(harness.train_step(harness.state, batch)["loss"])  # noqa: E731
    wall_step = wall_ms(step, 1)
    kernels = device_time(step)
    busy = sum(ms for _, ms, _ in kernels)
    conv_bn = sum(ms for k, ms, _ in kernels
                  if "dw_kernel" in k or "da_kernel" in k
                  or "dw_reduce" in k)
    log(f"[profile] ResNet-50 training step: wall {wall_step:.1f} ms, "
        f"{sum(c for *_, c in kernels)} kernels, device {busy:.1f} ms, idle "
        f"share {1 - busy / wall_step:.3f}; fused conv+BN kernels "
        f"{conv_bn:.1f} ms; top: "
        + "; ".join(f"{k[:60]} {ms:.1f} ms x{c}" for k, ms, c in kernels[:10]))
    return {"launches": launches, "step_ms_p50": p50, "mfu": mfu,
            "peak_bytes": peak}



def wall_ms(fn, calls: int) -> float:
    fn()
    t = time.monotonic()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return 1e3 * (time.monotonic() - t) / calls


def device_time(fn, calls: int = 1):
    """Kernels that ``calls`` calls of ``fn`` run on the card, by
    torch.profiler: a list of ``(name, device ms, count)``, largest
    first.  Only device-side events count (the CPU ops that launched
    them carry the same time again)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0),
                  key=lambda k: -k[1])


def profile_window(name: str, fn, wall: float) -> None:
    kernels = device_time(fn)
    busy = sum(ms for _, ms, _ in kernels)
    log(f"[profile] {name}: wall {wall:.3f} ms, {sum(c for *_, c in kernels)}"
        f" kernels, device {busy:.3f} ms, idle share "
        f"{1 - busy / wall:.3f}; top: "
        + "; ".join(f"{k[:50]} {ms:.3f} ms x{c}"
                    for k, ms, c in kernels[:4]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default=None,
                    help="comma-separated subset of "
                         f"{','.join(PHASES)} (debugging: a partial run "
                         "prints neither the kernels line nor the ok line)")
    args = ap.parse_args(argv)
    phase_card()
    t0 = time.monotonic()
    phase_build()
    if args.phases is not None:
        for name in args.phases.split(","):
            PHASES[name]()
        log(f"[done] partial run in {time.monotonic() - t0:.1f} s")
        return 0
    cases = phase_kernels()
    bwd = phase_backward()
    phase_parity()
    serve_launches = phase_serve()
    phase_grad_parity()
    train = phase_train()
    conv_bn = phase_conv_bn()
    phase_resnet_grad_parity()
    resnet = phase_resnet_train()

    by_path = {name: {"serve": serve_launches[name],
                      "lm_train": train["launches"][name],
                      "resnet_train": resnet["launches"][name]}
               for name in launch_counts()}
    attn = "B=8 S=4096 N=12 D=64 bf16 causal"
    rows = [("flash_fwd", "flash_fwd.cu", "flash_attention.py:136",
             cases["train"], attn),
            ("flash_bwd_dq", "flash_bwd.cu", "flash_attention.py:295",
             bwd["dq"], attn),
            ("flash_bwd_dkv", "flash_bwd.cu", "flash_attention.py:327",
             bwd["dkv"], attn),
            ("fused_conv_bn_bwd", "fused_conv_bn.cu", "fused_conv_bn.py:150",
             conv_bn, "ResNet-50 batch 256 bf16: the 36 calls of one "
                      "training step over 15 shapes, times summed")]
    kernels = [{
        "name": name, "route": "cuda",
        "source": f"tpuframe_torch/csrc/{src}",
        "replaces": f"tpuframe/ops/{line}",
        "launches": sum(by_path[name].values()),
        "launches_by_path": by_path[name],
        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": r["library_ms"],
        "shape": shape,
    } for name, src, line, r, shape in rows]
    log(f"[done] {time.monotonic() - t0:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


PHASES = {"kernels": phase_kernels, "backward": phase_backward,
          "parity": phase_parity, "serve": phase_serve,
          "grad_parity": phase_grad_parity, "train": phase_train,
          "conv_bn": phase_conv_bn,
          "resnet_grad_parity": phase_resnet_grad_parity,
          "resnet_train": phase_resnet_train}


if __name__ == "__main__":
    sys.exit(main())
