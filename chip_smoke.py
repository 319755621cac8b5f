#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU (an H100): build, check, serve.

    python3 chip_smoke.py

Phases, each printed as it ends; any failure raises and exits non-zero:

  1. require CUDA; print the card's name and power limit (nvidia-smi);
  2. build every kernel under tpuframe_torch/csrc with nvcc;
  3. hold each kernel against its plain PyTorch version at the serving
     shapes (and, for correctness only, at every head_dim and dtype it
     takes, with strided inputs), and time the kernel, the plain version and one PyTorch
     library call that computes the same function (a yardstick only);
  4. prefill + decode logits against the full forward, full width, bf16;
  5. serve 12 requests over the three prompt buckets through run_loadgen
     -> Scheduler -> LMEngine at full width (TransformerLM defaults:
     hidden 768, 12 layers, 12 heads, vocab 32000, bf16, flash attention),
     with every kernel's launch count read around that run.

Prints a ``{"kernels": [...]}`` line, then ends with
``{"ok": true, "device": {...}}`` as its last line.  Weights and token ids
are random, drawn from fixed seeds.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from pathlib import Path

import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent))

from tpuframe_torch import _build  # noqa: E402
from tpuframe_torch.models.transformer_lm import LMConfig  # noqa: E402
from tpuframe_torch.ops import flash_attention as fa  # noqa: E402
from tpuframe_torch.serve import kv_cache as kv  # noqa: E402
from tpuframe_torch.serve import loadgen  # noqa: E402
from tpuframe_torch.serve.engine import LMEngine, parity_diffs  # noqa: E402

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

SERVE_REQUESTS = 12
NEW_TOKENS = 16


def log(msg: str) -> None:
    print(msg, flush=True)


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
    dev = torch.device("cuda")
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

    keep = torch.ones((s, s), dtype=torch.bool, device=dev)
    if causal:
        keep = keep.tril()
    pairs = n * (int(keep.sum()) * b if mask is None
                 else int((keep[None] & (mask[:, None, :] != 0)).sum()))
    ops = 4 * d * pairs                      # QK^T and PV, 2 flops a MAC
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
    return cases


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
    fa.LAUNCHES = 0
    stats = loadgen.run_loadgen(engine, reqs)
    torch.cuda.synchronize()
    launches = {"flash_fwd": fa.LAUNCHES}

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


def main() -> int:
    phase_card()
    t0 = time.monotonic()
    phase_build()
    cases = phase_kernels()
    phase_parity()
    launches = phase_serve()

    main_case = cases[(512, torch.bfloat16, True, False)]
    kernels = [{
        "name": "flash_fwd", "route": "cuda",
        "source": "tpuframe_torch/csrc/flash_fwd.cu",
        "replaces": "tpuframe/ops/flash_attention.py:136",
        "launches": launches["flash_fwd"],
        "max_abs_err": main_case["max_abs_err"],
        "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"],
        "library_ms": main_case["library_ms"],
    }]
    log(f"[done] {time.monotonic() - t0:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
