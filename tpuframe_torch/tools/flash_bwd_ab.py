"""Time builds of ``csrc/flash_bwd.cu`` against each other on one card.

Each ``--src NAME=DIR`` names a directory that holds a ``flash_bwd.cu``
and the headers it includes (default: this checkout's ``csrc``).  Each
builds with nvcc into ``tpuframe_torch/_build/ab/NAME/`` and loads with
ctypes, and its delta pass (and, with ``--which delta,dq``, its dq kernel)
runs on the same inputs at the shapes of the main paths: the LM training
slice (B=8, S=4096, N=12, D=64, bf16, causal) and BERT's (B=8 and B=32,
S=128, bf16, glue_mnli and glue_sst2 key masks, not causal).  Every
build's delta is held to its plain version with ``DELTA_TOL``.  Times
are CUDA events over ``--iters`` launches, the builds in turns (A B B A)
for ``--rounds`` rounds, so that builds are compared within one call on
one card.  Prints the card's name and power limit, ptxas's registers and
spills for each build's delta and dq kernels, and one JSON object, also
written to ``--out``.

    python -m tpuframe_torch.tools.flash_bwd_ab \\
        --src parent=/path/to/parent/tpuframe_torch/csrc --src this=tpuframe_torch/csrc
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from tpuframe_torch import _build
from tpuframe_torch.ops import flash_attention as fa

# The delta pass vs its plain version: max |diff| over max |plain|, as in
# chip_smoke.py.
DELTA_TOL = 1e-4
PEAK_BF16_S = 989e12  # H100 SXM tensor cores, dense
PEAK_BYTES_S = 3.35e12
SHAPES = {"lm": (8, 4096, 12, 64, True, None),
          "bert8": (8, 128, 12, 64, False, ("glue_mnli", 0)),
          "bert32": (32, 128, 12, 64, False, ("glue_sst2", 1))}


def build(srcs: dict) -> dict:
    """``{name: (library path, ptxas log)}``, one nvcc per source, all
    started together."""
    nvcc = _build._nvcc()
    procs = {}
    for name, d in srcs.items():
        out = _build.BUILD_DIR / "ab" / name
        out.mkdir(parents=True, exist_ok=True)
        lib = out / "libflash_bwd.so"
        procs[name] = (lib, subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-o", str(lib),
             str(Path(d) / "flash_bwd.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    built = {}
    try:
        for name, (lib, proc) in procs.items():
            log, _ = proc.communicate(timeout=_build.BUILD_TIMEOUT_S)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc {name} exited {proc.returncode}:"
                                   f"\n{log}")
            built[name] = (lib, log)
    finally:
        for _, proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return built


def ptxas_lines(log: str) -> list:
    """``(entry, registers, spill store bytes)`` of each kernel in a
    build log."""
    rows = []
    for entry, body in re.findall(
            r"Compiling entry function '(\w+)'(.*?)(?=Compiling entry|\Z)",
            log, re.S):
        used = re.search(r"Used (\d+) registers", body)
        spill = re.search(r"(\d+) bytes spill stores", body)
        rows.append((entry, int(used.group(1)) if used else None,
                     int(spill.group(1)) if spill else None))
    return rows


def inputs(shape: str, gen):
    b, s, n, d, causal, glue = SHAPES[shape]
    q, k, v, do = (torch.randn((b, s, n, d), generator=gen, device="cuda")
                   .to(torch.bfloat16) for _ in range(4))
    mask = None
    if glue is not None:
        from tpuframe_torch.data import datasets
        ds = datasets.build(glue[0], None, seq_len=s)[glue[1]]
        mask = torch.from_numpy(np.ascontiguousarray(
            ds[np.arange(b)]["attention_mask"])).to("cuda")
    _, lse = fa.flash_fwd(q, k, v, mask=mask, causal=causal)
    return (q, k, v, do, lse, mask), causal


def plain_delta(args, causal):
    """The plain version one batch row at a time (its f32 [1, N, S, S]
    scores fit the card; the whole batch's would not at S=4096)."""
    q, k, v, do, lse, mask = args
    return torch.cat([fa.flash_bwd_delta_reference(
        q[i:i + 1], k[i:i + 1], v[i:i + 1], do[i:i + 1], lse[i:i + 1],
        mask=None if mask is None else mask[i:i + 1], causal=causal)
        for i in range(q.shape[0])])


def bound_ms(args, causal, which):
    """max(operations / peak, bytes / memory rate) in ms: two products of
    D multiply-adds a kept pair for the delta pass, three for dq; q, k, v,
    dO and lse read, delta (or dq, and delta read) written."""
    q, _, _, _, lse, mask = args
    b, s, n, d = q.shape
    keep = torch.ones((s, s), dtype=torch.bool, device="cuda")
    if causal:
        keep = keep.tril()
    pairs = (n * b * int(keep.sum()) if mask is None
             else n * int((keep[None] & (mask[:, None, :] != 0)).sum()))
    prods = 2 if which == "delta" else 3
    ops = 2 * prods * d * pairs
    nbytes = 4 * q.numel() * 2 + 2 * lse.numel() * 4 + (
        q.numel() * 2 if which == "dq" else 0) + (
        0 if mask is None else mask.numel() * 4)
    return 1e3 * max(ops / PEAK_BF16_S, nbytes / PEAK_BYTES_S), ops


def events_ms(fn, iters: int) -> float:
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


def device_ms(fn, calls: int = 10) -> float:
    """Mean device time a call of the backward kernel ``fn`` launches, by
    torch.profiler (the host's launch cost excluded)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and "flash_bwd" in e.key) / 1e3 / calls


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", action="append", default=None,
                    help="NAME=DIR holding a flash_bwd.cu (repeatable)")
    ap.add_argument("--shapes", default=",".join(SHAPES))
    ap.add_argument("--which", default="delta",
                    help="comma-separated kernels to time: delta, dq")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--out", default=str(_build.BUILD_DIR / "ab" /
                                         "flash_bwd_ab.json"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("flash_bwd_ab: torch.cuda.is_available() is False")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    srcs = dict(s.split("=", 1) for s in (args.src or [
        f"this={_build.SRC_DIR}"]))
    built = build(srcs)
    fns, info = {}, {}
    for name, (lib, log) in built.items():
        dq, dkv, delta, kinfo, err = fa.bind_bwd(ctypes.CDLL(str(lib)))
        fns[name] = (dq, dkv, delta, err)
        occ = {}
        for which, mode in (("delta", 2), ("dq", 1)):
            smem, blocks = ctypes.c_int(0), ctypes.c_int(0)
            e = kinfo(mode, 64, 1, 1, ctypes.byref(smem), ctypes.byref(blocks))
            occ[which] = (smem.value, blocks.value) if e == 0 else f"err {e}"
        info[name] = {"ptxas": [r for r in ptxas_lines(log)
                                if "delta" in r[0] or "dq" in r[0]],
                      "smem_blocks_per_sm": occ}
        print(f"[build] {name}: {info[name]}", flush=True)

    gen = torch.Generator(device="cuda").manual_seed(7)
    order = list(fns) + list(reversed(fns))
    res, bad = {}, []
    for shape in args.shapes.split(","):
        tensors, causal = inputs(shape, gen)
        q, k, v, do, lse, mask = tensors
        want = plain_delta(tensors, causal)
        scale = float(want.abs().max())
        delta_of = {}
        for name in fns:
            got = fa._launch_bwd("delta", q, k, v, do, lse, None, mask,
                                 causal, fns=fns[name])
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            delta_of[name] = got
            ok = bool(torch.isfinite(got).all()) and err <= DELTA_TOL * scale
            if not ok:
                bad.append(f"{shape} {name}: max|diff| {err:.3e} vs tol "
                           f"{DELTA_TOL} x {scale:.3e}")
            res.setdefault(shape, {}).setdefault("delta", {})[name] = {
                "max_abs_err": err, "rel_err": err / scale,
                "rows_unequal": int((got != want).sum())}
            print(f"[{shape}] delta {name}: max|diff| {err:.3e} over "
                  f"max|plain| {scale:.3e}, {int((got != want).sum())} of "
                  f"{got.numel()} rows not bit-equal", flush=True)
        first = next(iter(fns))
        for name in fns:
            res[shape]["delta"][name]["max_abs_diff_vs_" + first] = float(
                (delta_of[name] - delta_of[first]).abs().max())
        kernels = args.which.split(",")
        for which in kernels:
            d_in = None if which == "delta" else want
            times = {name: [] for name in fns}
            for _ in range(args.rounds):
                for name in order:
                    times[name].append(events_ms(
                        lambda n=name: fa._launch_bwd(
                            which, q, k, v, do, lse, d_in, mask, causal,
                            fns=fns[n]), args.iters))
            bound, ops = bound_ms(tensors, causal, which)
            for name, ts in times.items():
                dev = device_ms(lambda n=name: fa._launch_bwd(
                    which, q, k, v, do, lse, d_in, mask, causal,
                    fns=fns[n]))
                r = res[shape].setdefault(which, {}).setdefault(name, {})
                r.update(ms=float(np.median(ts)), ms_all=ts, device_ms=dev,
                         bound_ms=bound,
                         share_of_bound=bound / float(np.median(ts)),
                         tflops=ops / float(np.median(ts)) / 1e9)
            print(f"[{shape}] {which}: " + "; ".join(
                f"{n} {res[shape][which][n]['ms']:.4f} ms (device "
                f"{res[shape][which][n]['device_ms']:.4f}; "
                f"{res[shape][which][n]['share_of_bound']:.3f} of bound "
                f"{bound:.4f}, {res[shape][which][n]['tflops']:.1f} TFLOP/s)"
                for n in fns), flush=True)
    out = {"card": card, "builds": info, "shapes": res, "problems": bad}
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))
    print(json.dumps(out))
    if bad:
        print("flash_bwd_ab: " + "; ".join(bad), file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
