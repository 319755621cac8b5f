"""``python -m tpuframe_torch.serve``: the serving load generator CLI and
its selfcheck (counterpart of ``python -m tpuframe.serve``).

The default mode runs the open-loop load generator over a named model with
continuous batching and prints the summary stats::

    python -m tpuframe_torch.serve --model tiny-lm --steps 100
    python -m tpuframe_torch.serve --model tiny-lm --device cpu

``--selfcheck`` is the acceptance entry, on the card unless ``--device
cpu``: golden-logits parity on every bucket, a loadgen run with events,
``python -m tpuframe_torch.obs summarize`` over those events in a
subprocess (the TTFT/TPOT/tokens-per-second reporting path), a BERT
single-shot classification, and two ``FakeEngine`` replica processes
behind the router with one replica crashed mid-run::

    python -m tpuframe_torch.serve --selfcheck [--device cpu]

The JAX selfcheck's persistent-compile-cache safety step has no
counterpart: eager PyTorch keeps no compile cache.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile


def cmd_run(args) -> int:
    from tpuframe_torch.models.transformer_lm import LMConfig
    from tpuframe_torch.serve import loadgen
    from tpuframe_torch.serve.engine import LMEngine

    if args.model != "tiny-lm":
        raise SystemExit(f"unknown --model {args.model!r} (have: tiny-lm)")
    print(f"[serve] building engine for {args.model} "
          f"(slots={args.slots}, device={args.device}) ...", flush=True)
    engine = LMEngine(LMConfig.tiny(), slots=args.slots, device=args.device,
                      seed=args.seed)
    n_requests = max(1, args.steps // 4)
    reqs = loadgen.synthetic_requests(
        n_requests, buckets=engine.prompt_buckets,
        vocab_size=engine.cfg.vocab_size, seed=args.seed,
        max_new_tokens=args.max_new_tokens)
    stats = loadgen.run_loadgen(engine, reqs, max_steps=args.steps,
                                log=lambda m: print(f"[serve] {m}"))
    for key in ("requests", "steps", "total_tokens", "tokens_per_s",
                "tokens_per_s_per_chip"):
        print(f"[serve] {key}: {stats[key]}")
    if stats["unfinished"]:
        print(f"[serve] {stats['unfinished']} request(s) still in flight "
              f"at the --steps cap")
    # The step cap bounds the run, not its correctness — fail only when
    # the engine served nothing at all.
    return 0 if stats["requests"] > 0 else 1


def _summarize(events_dir: str) -> subprocess.CompletedProcess:
    """``python -m tpuframe_torch.obs summarize`` in a subprocess, with
    this checkout on its path and no JAX or XLA variable in its
    environment."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX_", "XLA_"))}
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (root, env.get("PYTHONPATH")) if p)
    return subprocess.run(
        [sys.executable, "-m", "tpuframe_torch.obs", "summarize",
         events_dir], capture_output=True, text=True, timeout=120, env=env)


def cmd_selfcheck(args) -> int:
    from tpuframe_torch.models.bert import BertConfig
    from tpuframe_torch.models.transformer_lm import LMConfig
    from tpuframe_torch.obs import events as obs_events
    from tpuframe_torch.serve import kv_cache as kv
    from tpuframe_torch.serve import loadgen
    from tpuframe_torch.serve import router as router_lib
    from tpuframe_torch.serve.engine import (BertClassifier, LMEngine,
                                             golden_parity_check)

    failures = []
    buckets = (16, 32)
    block = 16
    decode_tokens = 4
    cfg = LMConfig.tiny()

    # 1. Golden-logits parity: prefill+decode == the full forward, every
    #    bucket, full and ragged prompt lengths.
    cap = kv.capacity_for(max(buckets) + decode_tokens, block)
    problems = golden_parity_check(cfg, buckets=buckets, capacity=cap,
                                   decode_tokens=decode_tokens,
                                   device=args.device)
    failures += [f"parity: {p}" for p in problems]
    print(f"[serve] parity: {len(buckets)} buckets, "
          f"{len(problems)} problem(s)")

    # 2. Continuous-batching loadgen with obs events on.
    with tempfile.TemporaryDirectory(prefix="tpuframe-serve-") as tmp:
        events_dir = os.path.join(tmp, "events")
        obs_events.init(events_dir)
        engine = LMEngine(cfg, slots=3, prompt_buckets=buckets,
                          decode_block=block,
                          max_context=max(buckets) + decode_tokens,
                          seed=args.seed, device=args.device)
        reqs = loadgen.synthetic_requests(
            8, buckets=buckets, vocab_size=cfg.vocab_size,
            max_new_tokens=decode_tokens, seed=args.seed)
        stats = loadgen.run_loadgen(engine, reqs)
        obs_events.close()
        if stats["requests"] != 8 or stats["unfinished"]:
            failures.append(f"loadgen: {stats['requests']}/8 requests "
                            f"completed, {stats['unfinished']} unfinished")
        print(f"[serve] loadgen: {stats['requests']} requests, "
              f"{stats['total_tokens']} tokens, "
              f"{stats['tokens_per_s']} tok/s")

        # 3. The offline analyzer reports serving latency from those
        #    events (TTFT/TPOT percentiles, tokens/sec/chip).
        proc = _summarize(events_dir)
        out = proc.stdout
        if proc.returncode != 0:
            failures.append(f"obs summarize exited {proc.returncode}: "
                            f"{proc.stderr.strip()[-200:]}")
        for needle in ("serving", "TTFT", "TPOT", "tokens/s"):
            if needle not in out:
                failures.append(f"obs summarize missing {needle!r} "
                                "in serve section")
        print("[serve] obs summarize serve section:")
        for line in out.splitlines():
            if any(k in line for k in ("serving", "TTFT", "TPOT",
                                       "tokens/s")):
                print(f"    {line.strip()}")

    # 4. Single-shot BERT classification (the non-autoregressive path).
    clf = BertClassifier(BertConfig.tiny(num_classes=3), buckets=(16, 32),
                         seed=args.seed, device=args.device)
    label, probs = clf.classify(list(range(1, 11)))
    if not (0 <= label < 3 and abs(float(probs.sum()) - 1.0) < 1e-4):
        failures.append(f"bert classify: label={label} "
                        f"probs_sum={float(probs.sum()):.4f}")
    print(f"[serve] bert classify: label={label} ok")

    # 5. The JAX selfcheck's compile-cache safety of the decode outputs:
    #    nothing to check in eager PyTorch.
    print("[serve] compile-cache safety: no compile cache in eager "
          "PyTorch, nothing to check")

    # 6. Fleet smoke: two FakeEngine replica processes behind the router,
    #    seeded loadgen, one replica_crash mid-run: nothing lost.
    try:
        fleet = router_lib.fleet_smoke(
            replicas=2, n_requests=10, kill_rank=1, kill_step=3,
            step_delay_ms=5.0, seed=args.seed, device=args.device,
            log=lambda m: print(f"[serve] {m}"))
    except Exception as e:  # noqa: BLE001 — a harness crash is a failure
        failures.append(f"fleet smoke crashed: {type(e).__name__}: {e}")
    else:
        if fleet["lost"] or fleet["shed"] or fleet["timed_out"]:
            failures.append(
                f"fleet smoke: lost={fleet['lost']} shed={fleet['shed']} "
                f"timed_out={fleet['timed_out']} (want 0/0/False)")
        if fleet["drains"] < 1:
            failures.append("fleet smoke: replica_crash produced no "
                            "router drain")
        print(f"[serve] fleet smoke: {fleet['requests']} requests, "
              f"{fleet['drains']} drain(s), "
              f"{fleet['redispatched']} redispatched, "
              f"exit codes {fleet['exit_codes']}")

    for f in failures:
        print(f"SERVE FAIL {f}")
    print(f"[serve] selfcheck: {len(failures)} failure(s)")
    return 1 if failures else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m tpuframe_torch.serve",
        description="tpuframe_torch serving load generator / selfcheck")
    ap.add_argument("--model", default="tiny-lm")
    ap.add_argument("--steps", type=int, default=100,
                    help="max scheduler steps for the loadgen run")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new-tokens", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the plain kernels")
    ap.add_argument("--selfcheck", action="store_true",
                    help="run the acceptance selfcheck and exit")
    args = ap.parse_args(argv)
    if args.selfcheck:
        return cmd_selfcheck(args)
    return cmd_run(args)


if __name__ == "__main__":
    raise SystemExit(main())
