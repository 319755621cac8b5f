"""``python -m tpuframe_torch.serve`` — the serving load generator CLI.

Runs the open-loop load generator over a named model with continuous
batching and prints the summary stats::

    python -m tpuframe_torch.serve --model tiny-lm --steps 100
    python -m tpuframe_torch.serve --model tiny-lm --device cpu

The JAX CLI's ``--selfcheck`` (BERT, the fleet, obs) is not ported yet.
"""

from __future__ import annotations

import argparse


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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m tpuframe_torch.serve",
        description="tpuframe_torch serving load generator")
    ap.add_argument("--model", default="tiny-lm")
    ap.add_argument("--steps", type=int, default=100,
                    help="max scheduler steps for the loadgen run")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new-tokens", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the plain kernels")
    return cmd_run(ap.parse_args(argv))


if __name__ == "__main__":
    raise SystemExit(main())
